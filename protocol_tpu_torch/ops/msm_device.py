"""Sorted-prefix device MSM: Σ sᵢ·Pᵢ over BN254 G1 on the card.

The port of ``protocol_tpu/ops/msm_device.py``. The reference keeps this
design runnable but off: on its TPU the int32 multiply is emulated, and
a bucket pass lost to the host's MSM. On the H100 every field product
is one launch of the hand-written Montgomery kernel (``csrc/field.cu``)
and every sum one of ``add_mod``/``sub_mod``; the group law is the
batched a = 0 Jacobian law of ``ops/secp_batch.py`` (BN254 G1 is
y² = x³ + 3).

Per c-bit window:

1. the window digit of every scalar;
2. a stable argsort by digit, and the points gathered in that order;
3. a segmented Hillis–Steele inclusive scan of the sorted points under
   the group law: ⌈log₂ n⌉ steps, each one shifted gather and one
   masked add over all n lanes;
4. the segment tails are the bucket sums S_d, copied by index into
   2^c + 1 rows (the last row takes every non-tail lane and is never
   read); a suffix telescope over d = 2^c − 2 … 1 gives Σ d·S_d;
5. the windows combine MSB → LSB with c doublings and one add.

The JAX ``fori_loop``s are Python loops here. Exact integer arithmetic
end to end, bit for bit the host oracle's point (``zk.bn254.g1_msm``).
A CPU tensor takes the kernels' plain versions; a CUDA tensor launches
the kernels or raises.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device
from ..utils.fields import BN254_FQ_MODULUS
from .fieldops import (
    NUM_LIMBS,
    FieldCtx,
    from_limbs,
    from_mont,
    mont_one,
    to_limbs,
    to_mont,
)
from .secp_batch import _add, _dbl, _is_zero_row, _select, _to_affine

CTX_Q = FieldCtx(BN254_FQ_MODULUS)  # BN254 base field (G1 coords)
SCALAR_BITS = 264  # full 22×12-bit limb coverage

# seconds of the last msm_device call: ``prep`` turns the ints into limb
# rows and uploads them, ``device`` runs the sweep and the normalization
# (it ends reading the result, so the card has finished by then)
SECONDS = {"prep": 0.0, "device": 0.0}

# field launches of one ``_add`` (its doubling included) and one ``_dbl``
ADD_LAUNCHES = {"mont_mul": 23, "add_mod": 10, "sub_mod": 11}
DBL_LAUNCHES = {"mont_mul": 7, "add_mod": 9, "sub_mod": 5}


def _scan_steps(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _seg_scan_add(ctx, pts, seg):
    """Segmented inclusive scan under the group law: ``pts`` is a
    Jacobian triple of (n, L) rows sorted by segment key ``seg``; each
    output row holds the running sum of its segment's prefix. A
    shifted-in row is (0, 0, 0), the point at infinity."""
    n = seg.shape[0]
    cur = pts
    for i in range(_scan_steps(n)):
        off = min(1 << i, n)
        shifted = tuple(torch.cat([torch.zeros_like(p[:off]), p[:n - off]])
                        for p in cur)
        seg_shift = torch.cat([torch.full_like(seg[:off], -1),
                               seg[:n - off]])
        summed = _add(ctx, cur, shifted)
        cur = _select(seg == seg_shift, summed, cur)
    return cur


def _window_contrib(xs, ys, one, s_pl, w: int, c: int):
    """Bucket-weighted sum Σ d·S_d of window ``w``: a 1-lane Jacobian
    triple."""
    ctx = CTX_Q
    per = 12 // c
    d = (s_pl[:, w // per] >> (c * (w % per))) & ((1 << c) - 1)

    # stable, as the reference's sort: the order inside a bucket fixes
    # the Jacobian triple ``affine=False`` returns
    order = torch.argsort(d, stable=True)
    d_sorted = d[order]
    scan = _seg_scan_add(ctx, (xs[order], ys[order], one), d_sorted)

    nb = 1 << c
    is_tail = torch.ones_like(d_sorted, dtype=torch.bool)
    is_tail[:-1] = d_sorted[:-1] != d_sorted[1:]
    # one tail per present digit → unique rows; non-tails land on the
    # junk row nb and are never read
    idx = torch.where(is_tail, d_sorted, nb).long()
    bucket = tuple(
        torch.zeros((nb + 1, NUM_LIMBS), dtype=torch.int32,
                    device=p.device).index_copy_(0, idx, p)
        for p in scan)

    # Σ_{d>=1} d·S_d by suffix telescoping: run = Σ_{d>=j} S_d, tot +=
    # run for j = nb−2 .. 1 (bucket 0 never enters)
    run = tuple(p[nb - 1: nb] for p in bucket)
    tot = run
    for j in range(nb - 2, 0, -1):
        run = _add(ctx, run, tuple(p[j: j + 1] for p in bucket))
        tot = _add(ctx, tot, run)
    return tot


def _combine(acc, tot, c: int):
    for _ in range(c):
        acc = _dbl(CTX_Q, acc)
    return _add(CTX_Q, acc, tot)


def _window_bits(c: int, scalar_bits) -> int:
    if 12 % c:
        raise ValueError("window size must divide the 12-bit limb")
    return SCALAR_BITS if scalar_bits is None else int(scalar_bits)


def msm_rows(xs: torch.Tensor, ys: torch.Tensor, s_pl: torch.Tensor,
             c: int = 4, nbits: int = SCALAR_BITS):
    """Σ sᵢ·Pᵢ from device rows: ``xs``, ``ys`` the points' affine
    coordinates in the Montgomery domain and ``s_pl`` the scalars'
    plain limb rows, each (n, L) on one device. Returns the Jacobian
    Montgomery triple of (1, L) rows; Z = 0 is the identity."""
    one = mont_one(CTX_Q, xs.shape[0], xs.device)
    zero = torch.zeros((1, NUM_LIMBS), dtype=torch.int32, device=xs.device)
    acc = (zero, zero, zero)  # ∞
    for w in range((nbits + c - 1) // c - 1, -1, -1):
        tot = _window_contrib(xs, ys, one, s_pl, w, c)
        acc = _combine(acc, tot, c)
    return acc


def upload_points(points, device) -> tuple:
    """Affine int pairs → (xs, ys) Montgomery rows on ``device``."""
    xs = torch.from_numpy(to_limbs([p[0] for p in points])).to(device)
    ys = torch.from_numpy(to_limbs([p[1] for p in points])).to(device)
    return to_mont(CTX_Q, xs), to_mont(CTX_Q, ys)


def finish(acc, affine: bool = True):
    """The host result of :func:`msm_rows`: None for the identity, else
    the affine (x, y) ints, or with ``affine=False`` the Jacobian
    (x, y, z) ints."""
    ctx = CTX_Q
    if bool(_is_zero_row(acc[2])[0]):
        return None
    if not affine:
        return tuple(from_limbs(from_mont(ctx, a).cpu().numpy())[0]
                     for a in acc)
    ax, ay = _to_affine(ctx, acc)
    x = from_limbs(from_mont(ctx, ax).cpu().numpy())[0]
    y = from_limbs(from_mont(ctx, ay).cpu().numpy())[0]
    return (x, y)


def msm_device(points, scalars, c: int = 4, scalar_bits: int | None = None,
               affine: bool = True, device=None):
    """Σ scalars[i]·points[i] over BN254 G1 on ``device`` (default: the
    card; raises without one — name ``"cpu"`` to run the kernels' plain
    versions).

    points: [(x, y)] affine int pairs (no identities); scalars: ints.
    Returns an affine (x, y) int pair, or None for the identity.

    ``scalar_bits`` bounds the window sweep when every scalar is known
    small (raises if a scalar exceeds the bound). ``affine=False``
    returns the Jacobian (x, y, z) ints instead of normalizing on the
    device."""
    nbits = _window_bits(c, scalar_bits)
    if scalar_bits is not None:
        for s in scalars:
            if int(s) >> nbits:
                raise ValueError(
                    f"scalar exceeds the {nbits}-bit window bound")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    xs, ys = upload_points(points, dev)
    s_pl = torch.from_numpy(to_limbs([int(s) for s in scalars])).to(dev)
    t1 = time.perf_counter()
    out = finish(msm_rows(xs, ys, s_pl, c, nbits), affine)
    SECONDS["prep"], SECONDS["device"] = t1 - t0, time.perf_counter() - t1
    return out


def _inverse_launches() -> int:
    """``fieldops.inv_mod``'s Montgomery products: one per set bit of
    p − 2 and one square per bit below its top."""
    e = CTX_Q.modulus - 2
    return bin(e).count("1") + e.bit_length() - 1


def launch_counts(n: int, c: int = 4, scalar_bits: int | None = None,
                  affine: bool = True) -> dict:
    """The field launches of one :func:`msm_device` call over ``n``
    points (the identity result excepted: it stops before the
    normalization). Each window runs ⌈log₂ n⌉ scan adds, 2·(2^c − 2)
    telescope adds, c doublings and one combining add."""
    nbits = _window_bits(c, scalar_bits)
    windows = (nbits + c - 1) // c
    adds = windows * (_scan_steps(n) + 2 * max(0, (1 << c) - 2) + 1)
    dbls = windows * c
    out = {k: adds * ADD_LAUNCHES[k] + dbls * DBL_LAUNCHES[k]
           for k in ADD_LAUNCHES}
    out["mont_mul"] += 2  # the points' x and y into the Montgomery domain
    # affine: the inverse, 4 products and 2 conversions out; else 3 out
    out["mont_mul"] += _inverse_launches() + 6 if affine else 3
    return out

