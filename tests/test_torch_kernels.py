"""The port's hand-written kernels against their plain versions.

This file imports neither JAX nor the reference, so it also runs on the
machine with the card (whose Python has no JAX), without the suite's
conftest: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
Tests marked ``cuda`` need the card and skip without one.
"""

import numpy as np
import pytest
import torch

from protocol_tpu_torch.ops import kernels
from protocol_tpu_torch.ops.kernels import (
    FORWARD,
    MIDDLE,
    REVERSE,
    lane_perm,
    lane_perm_plain,
    route_stage,
    route_stage_plain,
)

_DTYPES = (np.float32, np.float64, np.int32)


def _case(T, np_dtype, seed):
    rng = np.random.default_rng(seed)
    if np_dtype == np.int32:
        x = rng.integers(-2**31, 2**31 - 1, (T, 128), dtype=np.int32)
    else:
        x = rng.standard_normal((T, 128)).astype(np_dtype)
    idx = rng.integers(0, 128, (T, 128)).astype(np.uint8)
    return x, idx


@pytest.mark.parametrize("T", [1, 7, 8, 1000])
def test_lane_perm_on_cpu_is_the_plain_gather(T):
    for np_dtype in _DTYPES:
        x, idx = _case(T, np_dtype, T)
        before = kernels.LAUNCHES["lane_perm"]
        y = lane_perm(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        assert kernels.LAUNCHES["lane_perm"] == before  # no kernel on CPU
        assert np.array_equal(
            y, np.take_along_axis(x, idx.astype(np.int64), axis=1))


def test_lane_perm_rejects_bad_input():
    x = torch.zeros(4, 128)
    idx = torch.zeros(4, 128, dtype=torch.uint8)
    with pytest.raises(ValueError):
        lane_perm(torch.zeros(4, 64), idx[:, :64])
    with pytest.raises(ValueError):
        lane_perm(x, idx.long())
    with pytest.raises(ValueError):
        lane_perm(x, idx[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7, 8, 1000, 8192])
def test_lane_perm_kernel_matches_plain(T):
    """The CUDA kernel, bit-exact against its plain version on the card
    (float32, float64, int32; T below, at and past one tile, with a
    ragged last tile at 1000), and one count per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for np_dtype in _DTYPES:
        x, idx = _case(T, np_dtype, T)
        x, idx = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
        before = kernels.LAUNCHES["lane_perm"]
        y = lane_perm(x, idx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["lane_perm"] == before + 1
        assert torch.equal(y, lane_perm_plain(x, idx))


@pytest.mark.cuda
def test_lane_perm_kernel_takes_unaligned_views():
    """A view that starts off a 16-byte boundary is copied, not refused
    and not sent to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, idx = _case(9, np.float32, 3)
    xf = torch.from_numpy(x).cuda().view(-1)
    x2 = torch.cat([xf[:1], xf])[1:].view(9, 128)  # storage offset 4 bytes
    assert x2.data_ptr() % 16 != 0
    idx = torch.from_numpy(idx).cuda()
    before = kernels.LAUNCHES["lane_perm"]
    y = lane_perm(x2, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lane_perm"] == before + 1
    assert torch.equal(y, lane_perm_plain(x2, idx))


# --- the fused route stage: forward and reverse forms -------------------------

def _stage_numpy(x, idx, form, m):
    """A stage as the reference's numpy replay runs it (``apply_route_np``):
    take_along_axis with the transposes as swapaxes."""
    T = x.shape[0]
    if form == REVERSE:
        x = x.reshape(T // m, 128, m).swapaxes(1, 2).reshape(T, 128)
    y = np.take_along_axis(x, idx.astype(np.int64), axis=1)
    if form == FORWARD:
        y = y.reshape(T // m, m, 128).swapaxes(1, 2).reshape(T, 128)
    return y


@pytest.mark.parametrize("form", [FORWARD, REVERSE])
@pytest.mark.parametrize("m,B", [(2, 1), (2, 3), (16, 3), (64, 2), (128, 1)])
def test_route_stage_on_cpu_is_the_plain_version(form, m, B):
    """The plain forms against numpy; at m = 128 on one subproblem the
    transpose of a square block is a view whose strides a caller's
    ``view`` would refuse, so the result must come back contiguous."""
    for np_dtype in _DTYPES:
        x, idx = _case(m * B, np_dtype, m + B)
        before = kernels.LAUNCHES["lane_perm"]
        y = route_stage(torch.from_numpy(x), torch.from_numpy(idx), form, m)
        assert kernels.LAUNCHES["lane_perm"] == before  # no kernel on CPU
        assert y.is_contiguous()
        assert np.array_equal(y.numpy(), _stage_numpy(x, idx, form, m))


def test_route_stage_rejects_bad_input():
    x = torch.zeros(6, 128)
    idx = torch.zeros(6, 128, dtype=torch.uint8)
    for form, m in ((FORWARD, 3), (FORWARD, 4), (REVERSE, 1), (REVERSE, 12),
                    (3, 2)):
        with pytest.raises(ValueError):
            route_stage(x, idx, form, m)
    assert torch.equal(route_stage(x, idx, MIDDLE), lane_perm_plain(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [FORWARD, REVERSE])
@pytest.mark.parametrize("m", [2, 16, 64, 1 << 13])
def test_route_stage_kernel_matches_plain(form, m):
    """Each transposing form of the CUDA kernel, bit-exact against its
    plain version on the card (float32, float64, int32): m below, at and
    past a tile's 16 or 32 rows and the state route's first level, on
    one subproblem and on three (for m < 32, a ragged last tile); one
    count per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for B in (1, 3):
        for np_dtype in _DTYPES:
            x, idx = _case(m * B, np_dtype, m + B)
            x, idx = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
            before = kernels.LAUNCHES["lane_perm"]
            y = route_stage(x, idx, form, m)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["lane_perm"] == before + 1
            assert torch.equal(y, route_stage_plain(x, idx, form, m)), (
                np_dtype, B)


# --- the topic batch: K arrays sharing one index array ------------------------

def _batch_case(K, T, np_dtype, seed):
    xs, idx = zip(*(_case(T, np_dtype, seed + k) for k in range(K)))
    return np.stack(xs), idx[0]


@pytest.mark.parametrize("form,m", [(FORWARD, 16), (MIDDLE, 1), (REVERSE, 64)])
def test_route_stage_batch_on_cpu_is_k_single_stages(form, m):
    """A ``[K, T, 128]`` batch through the plain version equals K single
    stages with the same index array, bit for bit."""
    for np_dtype in _DTYPES:
        x, idx = _batch_case(5, 128, np_dtype, m)
        y = route_stage(torch.from_numpy(x), torch.from_numpy(idx), form, m)
        assert y.shape == x.shape and y.is_contiguous()
        for k in range(5):
            assert np.array_equal(y[k].numpy(),
                                  _stage_numpy(x[k], idx, form, m))


def test_route_stage_batch_rejects_mismatched_index():
    x = torch.zeros(3, 6, 128)
    with pytest.raises(ValueError):
        route_stage(x, torch.zeros(3, 6, 128, dtype=torch.uint8), MIDDLE)
    with pytest.raises(ValueError):
        route_stage(x, torch.zeros(4, 128, dtype=torch.uint8), MIDDLE)


@pytest.mark.cuda
@pytest.mark.parametrize("form,m", [(FORWARD, 2), (FORWARD, 1 << 13),
                                    (MIDDLE, 1), (REVERSE, 16),
                                    (REVERSE, 1 << 13)])
def test_route_stage_kernel_batch_matches_single_launches(form, m):
    """The topic batch on the card: K = 5 arrays through one launch equal
    five single launches and the plain batch, bit for bit, in every
    dtype, on one subproblem and on three."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for B in (1, 3):
        for np_dtype in _DTYPES:
            x, idx = _batch_case(5, m * B, np_dtype, m + B)
            x, idx = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
            before = kernels.LAUNCHES["lane_perm"]
            y = route_stage(x, idx, form, m)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["lane_perm"] == before + 1
            singles = torch.stack([route_stage(x[k], idx, form, m)
                                   for k in range(5)])
            assert torch.equal(y, singles), (np_dtype, B)
            assert torch.equal(y, route_stage_plain(x, idx, form, m))


# --- the field kernels (csrc/field.cu) ----------------------------------------

from protocol_tpu_torch.ops import fieldops as fo  # noqa: E402
from protocol_tpu_torch.ops.kernels import field_kernel as fk  # noqa: E402
from protocol_tpu_torch.utils.fields import (  # noqa: E402
    BN254_FQ_MODULUS,
    BN254_FR_MODULUS,
    SECP256K1_N,
    SECP256K1_P,
)

_MODULI = (BN254_FR_MODULUS, BN254_FQ_MODULUS, SECP256K1_P, SECP256K1_N)
_FIELD = (("mont_mul", fk.mont_mul, fk.mont_mul_plain),
          ("add_mod", fk.add_mod, fk.add_mod_plain),
          ("sub_mod", fk.sub_mod, fk.sub_mod_plain))


def _field_rows(p, n, seed):
    """x (lazy sums below min(512, R/p)·p on every other lane), x mod p
    and y, as (n, 22) int32 tensors; the first lanes are 0, 1 and p − 1
    against each other."""
    rng = np.random.default_rng(seed)
    top = min(512, (1 << 264) // p) * p
    xs = [int.from_bytes(rng.bytes(34), "little") % (top if i % 2 else p)
          for i in range(n)]
    ys = [int.from_bytes(rng.bytes(33), "little") % p for _ in range(n)]
    edges = (0, 1, p - 1)
    for i in range(min(n, 9)):
        xs[i], ys[i] = edges[i % 3], edges[i // 3]
    t = lambda v: torch.from_numpy(fo.to_limbs(v))  # noqa: E731
    return t(xs), t([x % p for x in xs]), t(ys)


@pytest.mark.parametrize("name,kernel,plain", _FIELD)
def test_field_kernels_on_cpu_are_the_plain_versions(name, kernel, plain):
    ctx = fo.FieldCtx(BN254_FR_MODULUS)
    x, xc, y = _field_rows(ctx.modulus, 40, 1)
    x = x if name == "mont_mul" else xc
    before = dict(fk.LAUNCHES)
    assert torch.equal(kernel(x, y, ctx), plain(x, y, ctx))
    assert fk.LAUNCHES == before  # no kernel on the CPU


@pytest.mark.parametrize("name,kernel,plain", _FIELD)
def test_field_kernels_refuse_bad_input(name, kernel, plain):
    ctx = fo.FieldCtx(SECP256K1_P)
    x = torch.zeros(4, 22, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernel(x.long(), x.long(), ctx)
    with pytest.raises(ValueError, match="int32"):
        kernel(x, x.float(), ctx)
    with pytest.raises(ValueError, match="22"):
        kernel(x[:, :21], x[:, :21], ctx)
    with pytest.raises(ValueError, match="differs"):
        kernel(x, x[:3], ctx)
    with pytest.raises(ValueError, match="different devices"):
        kernel(x, x.to("meta"), ctx)
    with pytest.raises(ValueError, match="unsupported device"):
        kernel(x.to("meta"), x.to("meta"), ctx)


def _operand_forms(n):
    """Operand forms of n rows cut from n + 3: views 88 and 264 bytes
    into their storage (off a 16-byte boundary on the card), and one row
    broadcast to all n on either side (stride (0, 1))."""
    return {"offset": (lambda t: t[1:n + 1], lambda t: t[3:n + 3]),
            "broadcast_x": (lambda t: t[5].expand(n, fo.NUM_LIMBS),
                            lambda t: t[:n]),
            "broadcast_y": (lambda t: t[:n],
                            lambda t: t[2].expand(n, fo.NUM_LIMBS))}


def test_field_kernels_on_cpu_take_offset_and_broadcast_operands():
    """On the CPU a view or a broadcast row goes to the plain version as
    it is, with the result of its contiguous copy and no launch."""
    ctx = fo.FieldCtx(BN254_FR_MODULUS)
    n = 40
    x, xc, y = _field_rows(ctx.modulus, n + 3, 2)
    before = dict(fk.LAUNCHES)
    for form, (fx, fy) in _operand_forms(n).items():
        for name, kernel, plain in _FIELD:
            xin = fx(x if name == "mont_mul" else xc)
            yin = fy(y)
            want = plain(xin.contiguous(), yin.contiguous(), ctx)
            assert torch.equal(kernel(xin, yin, ctx), want), (name, form)
    assert fk.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("p", _MODULI)
def test_field_kernels_match_plain(p):
    """Each field kernel, bit-exact against its plain version on the
    card (edge values, lazy x for the multiply, n below, at and past one
    64-row tile, two tiles and one, and 127 to 1000), one count per
    launch; strided views are copied, not refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ctx = fo.FieldCtx(p)
    r = fk.TILE_ROWS
    for n in (1, r - 1, r, r + 1, 2 * r + 1, 127, 128, 1000):
        x, xc, y = (t.cuda() for t in _field_rows(p, n, n))
        for name, kernel, plain in _FIELD:
            xin = x if name == "mont_mul" else xc
            before = fk.LAUNCHES[name]
            got = kernel(xin, y, ctx)
            torch.cuda.synchronize()
            assert fk.LAUNCHES[name] == before + 1
            assert torch.equal(got, plain(xin, y, ctx)), (name, n)
    y_t = y.t().contiguous().t()  # same values, column-major strides
    assert not y_t.is_contiguous()
    assert torch.equal(fk.mont_mul(x, y_t, ctx), fk.mont_mul_plain(x, y, ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("p", _MODULI)
def test_field_kernels_take_offset_and_broadcast_operands(p):
    """Views off a 16-byte boundary (``x[1:]``, ``y[3:]``) and one row
    broadcast on either side (row stride 0) launch the kernels as they
    are, over a ragged last tile, bit-exact against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ctx = fo.FieldCtx(p)
    n = 2 * fk.TILE_ROWS + 1
    x, xc, y = (t.cuda() for t in _field_rows(p, n + 3, 7))
    for form, (fx, fy) in _operand_forms(n).items():
        for name, kernel, plain in _FIELD:
            xin = fx(x if name == "mont_mul" else xc)
            yin = fy(y)
            if form == "offset":
                assert xin.data_ptr() % 16 and yin.data_ptr() % 16
            before = fk.LAUNCHES[name]
            got = kernel(xin, yin, ctx)
            torch.cuda.synchronize()
            assert fk.LAUNCHES[name] == before + 1
            assert torch.equal(got, plain(xin, yin, ctx)), (name, form)


@pytest.mark.cuda
def test_field_kernels_at_the_mds_width():
    """819,200 lanes, the width of the Poseidon MDS step's multiply:
    every kernel bit-exact against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ctx = fo.FieldCtx(BN254_FR_MODULUS)
    rng = np.random.default_rng(8)
    x, y = (torch.from_numpy(rng.integers(0, fk.BASE, (819_200, fo.NUM_LIMBS),
                                          dtype=np.int32)).cuda()
            for _ in range(2))
    x[:, -1] = 0  # canonical: below 2^252 < p
    y[:, -1] = 0
    for name, kernel, plain in _FIELD:
        got = kernel(x, y, ctx)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x, y, ctx)), name


@pytest.mark.cuda
@pytest.mark.parametrize("p", _MODULI)
def test_sub_mod_borrows_on_every_operand_form(p):
    """The staged ``sub_mod`` where x < y on every other lane (the
    conditional +p), on operands as made, off a 16-byte boundary and
    broadcast on either side, over a ragged last tile: bit-exact against
    its plain version and against Python ints."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ctx = fo.FieldCtx(p)
    n = 2 * fk.TILE_ROWS + 1
    rng = np.random.default_rng(9)
    hi = [int.from_bytes(rng.bytes(33), "little") % p for _ in range(n + 3)]
    lo = [v // 2 for v in hi]
    xs = [lo[i] if i % 2 else hi[i] for i in range(n + 3)]
    ys = [hi[i] if i % 2 else lo[i] for i in range(n + 3)]
    x = torch.from_numpy(fo.to_limbs(xs)).cuda()
    y = torch.from_numpy(fo.to_limbs(ys)).cuda()
    row = fo.NUM_LIMBS
    forms = {"as_made": (lambda t: t[:n], lambda t: t[:n],
                         lambda i: i, lambda i: i),
             "offset": (lambda t: t[1:n + 1], lambda t: t[3:n + 3],
                        lambda i: i + 1, lambda i: i + 3),
             "broadcast_x": (lambda t: t[5].expand(n, row), lambda t: t[:n],
                             lambda i: 5, lambda i: i),
             "broadcast_y": (lambda t: t[:n], lambda t: t[2].expand(n, row),
                             lambda i: i, lambda i: 2)}
    for form, (fx, fy, ix, iy) in forms.items():
        got = fk.sub_mod(fx(x), fy(y), ctx)
        torch.cuda.synchronize()
        assert torch.equal(got, fk.sub_mod_plain(fx(x), fy(y), ctx)), form
        want = [(xs[ix(i)] - ys[iy(i)]) % p for i in range(n)]
        assert fo.from_limbs(got.cpu().numpy()) == want, form
