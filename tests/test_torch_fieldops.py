"""The port's field engine against the JAX package's.

Every comparison here is exact: the field engine is integer arithmetic,
so the port must give the reference's limbs bit for bit (and the
Python-int value, where that is the oracle). The port runs on the CPU,
where each kernel takes its plain torch version; the kernels themselves
are held to those plain versions on the card (``test_torch_kernels.py``,
``chip_smoke.py``). Inputs are made from a seed on the host and handed
to both packages as numpy arrays.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu.ops import fieldops as jfo
from protocol_tpu.ops.pallas_kernels import pallas_mont_mul
from protocol_tpu_torch.ops import fieldops as fo
from protocol_tpu_torch.utils.fields import (
    BN254_FQ_MODULUS,
    BN254_FR_MODULUS,
    SECP256K1_N,
    SECP256K1_P,
)

MODULI = {"bn254_fr": BN254_FR_MODULUS, "bn254_fq": BN254_FQ_MODULUS,
          "secp256k1_p": SECP256K1_P, "secp256k1_n": SECP256K1_N}
SIZES = (1, 5, 130)
R = 1 << 264


def _cases(p: int, seed: int):
    """For each size in SIZES, (xs, ys) as ints: edge values first (0, 1,
    p − 1 against each other), random canonical values, and every fourth
    x a lazy sum below min(512, R/p)·p."""
    rng = random.Random(seed)
    lazy = min(512, R // p) * p
    edges = [0, 1, p - 1]
    out = []
    for n in SIZES:
        xs, ys = [], []
        for i in range(n):
            if i < 9:
                xs.append(edges[i % 3])
                ys.append(edges[i // 3])
            elif i % 4 == 0:
                xs.append(rng.randrange(lazy))
                ys.append(rng.randrange(p))
            else:
                xs.append(rng.randrange(p))
                ys.append(rng.randrange(p))
        if n > 9:
            xs[9] = lazy - 1  # the largest lazy sum
        out.append((xs, ys))
    return out


def _t(values) -> torch.Tensor:
    return torch.from_numpy(fo.to_limbs(values))


@pytest.mark.parametrize("name", sorted(MODULI))
def test_mont_mul_matches_jax_and_pallas(name):
    p = MODULI[name]
    cases = _cases(p, seed=len(name))
    all_x = [v for xs, _ in cases for v in xs]
    all_y = [v for _, ys in cases for v in ys]
    jctx = jfo.FieldCtx(p)
    # one reference call over all sizes (rows are independent)
    jx = jnp.asarray(jfo.to_limbs(all_x))
    jy = jnp.asarray(jfo.to_limbs(all_y))
    want = np.asarray(jfo.mont_mul(jctx, jx, jy))
    want_pallas = np.asarray(pallas_mont_mul(jctx, jx, jy, interpret=True))
    assert np.array_equal(want, want_pallas)
    ctx = fo.FieldCtx(p)
    lo = 0
    for xs, ys in cases:
        got = fo.mont_mul(ctx, _t(xs), _t(ys)).numpy()
        assert got.dtype == np.int32 and got.shape == (len(xs), 22)
        assert np.array_equal(got, want[lo:lo + len(xs)]), (name, len(xs))
        r_inv = pow(R, -1, p)
        assert fo.from_limbs(got) == [x * y * r_inv % p
                                      for x, y in zip(xs, ys)]
        lo += len(xs)


@pytest.mark.parametrize("name", sorted(MODULI))
def test_add_sub_mod_match_python_ints(name):
    p = MODULI[name]
    ctx = fo.FieldCtx(p)
    for xs, ys in _cases(p, seed=7):
        xs = [x % p for x in xs]  # add and sub take canonical rows
        x, y = _t(xs), _t(ys)
        assert fo.from_limbs(fo.add_mod(ctx, x, y).numpy()) == [
            (a + b) % p for a, b in zip(xs, ys)]
        assert fo.from_limbs(fo.sub_mod(ctx, x, y).numpy()) == [
            (a - b) % p for a, b in zip(xs, ys)]


@pytest.mark.parametrize("name", sorted(MODULI))
def test_mont_pow_and_inv_mod_match_python_ints(name):
    p = MODULI[name]
    ctx = fo.FieldCtx(p)
    rng = random.Random(3)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(3)]
    xm = fo.to_mont(ctx, _t(xs))
    back = lambda t: fo.from_limbs(fo.from_mont(ctx, t).numpy())  # noqa: E731
    assert back(xm) == xs
    assert back(fo.mont_pow(ctx, xm, 5)) == [pow(x, 5, p) for x in xs]
    e = rng.randrange(1 << 200, 1 << 255)  # the rolled square-and-multiply
    assert back(fo.mont_pow(ctx, xm, e)) == [pow(x, e, p) for x in xs]
    # Fermat inverse; 0 → 0
    assert back(fo.inv_mod(ctx, xm)) == [pow(x, p - 2, p) for x in xs]


def test_ripple_matches_reference():
    """The port's carry ripple (bias, two passes, lookahead) against the
    reference's 22-pass ripple, over its documented input range: borrows
    down to −8190, lazy sums, accumulators up to 2^30, and chains of
    4095s that a single carry runs through."""
    rng = np.random.default_rng(5)
    for width in (22, 24):
        t = rng.integers(-8190, 1 << 30, (64, width)).astype(np.int32)
        t[:16] = rng.integers(-8190, 8191, (16, width))
        t[16:24] = 4095
        t[16:24, 0] = rng.integers(4096, 8191, 8)  # carries through 4095s
        t[24:32] = rng.choice([0, 4095, 4096, -1], (8, width))
        want = np.asarray(jfo._ripple(jnp.asarray(t)))
        assert np.array_equal(fo._ripple(torch.from_numpy(t)).numpy(), want)


def test_geq_and_cond_sub_p_match_reference():
    p = BN254_FR_MODULUS
    rng = random.Random(11)
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1] + [rng.randrange(2 * p)
                                                  for _ in range(10)]
    a = fo.to_limbs(vals)
    b = fo.to_limbs(vals[::-1])
    assert np.array_equal(
        fo._geq(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jfo._geq(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(
        fo._cond_sub_p(torch.from_numpy(a), fo.FieldCtx(p)).numpy(),
        np.asarray(jfo._cond_sub_p(jnp.asarray(a), jfo.FieldCtx(p))))


def _matrix(n: int, seed: int) -> list:
    rng = random.Random(seed)
    m = [[rng.randrange(1, 1000) if i != j else 0 for j in range(n)]
         for i in range(n)]
    m[n - 1] = [0] * n  # a zero row: inverse-or-zero
    return m


def test_mont_matvec_matches_jax():
    p = BN254_FR_MODULUS
    rng = random.Random(2)
    n = 4
    m = fo.to_limbs([rng.randrange(p) for _ in range(n * n)])
    v = fo.to_limbs([rng.randrange(p) for _ in range(n)])
    want = np.asarray(jfo.mont_matvec(
        jfo.FieldCtx(p), jnp.asarray(m.reshape(n, n, 22)), jnp.asarray(v)))
    got = fo.mont_matvec(fo.FieldCtx(p),
                         torch.from_numpy(m.reshape(n, n, 22)),
                         torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)


def test_mont_matvec_refuses_sets_past_the_lazy_limit():
    ctx = fo.FieldCtx(SECP256K1_P)  # 256 bits: at most 256 lazy terms
    m = torch.zeros(257, 257, 22, dtype=torch.int32)
    with pytest.raises(ValueError, match="up to 256"):
        fo.mont_matvec(ctx, m, torch.zeros(257, 22, dtype=torch.int32))


def test_field_converge_matches_jax():
    p = BN254_FR_MODULUS
    m = _matrix(4, seed=9)
    init = [1000, 0, 250, 3]
    want = jfo.field_converge(jfo.FieldCtx(p), m, init, 5)
    assert fo.field_converge(fo.FieldCtx(p), m, init, 5,
                             device="cpu") == want


def test_field_converge_matches_native_model():
    """The reference's own parity target (``tests/test_fieldops.py``):
    the port's limb arithmetic reproduces the host
    ``EigenTrustSet.converge``'s Fr scores bit for bit."""
    from protocol_tpu.crypto.secp256k1 import EcdsaKeypair
    from protocol_tpu.models.eigentrust import (
        Attestation,
        EigenTrustSet,
        SignedAttestation,
    )
    from protocol_tpu.utils.fields import Fr

    domain = Fr(42)
    n = 4
    kps = [EcdsaKeypair(1000 + i) for i in range(n)]
    addrs = [kp.public_key.to_address() for kp in kps]
    native = EigenTrustSet(n, 20, 1000, domain)
    for a in addrs:
        native.add_member(a)
    rows = {0: [0, 300, 300, 400], 1: [500, 0, 250, 250],
            2: [100, 200, 0, 700], 3: [300, 300, 400, 0]}
    for i, row in rows.items():
        signed = []
        for j in range(n):
            if row[j]:
                att = Attestation(about=addrs[j], domain=domain,
                                  value=Fr(row[j]), message=Fr.zero())
                signed.append(
                    SignedAttestation(att, kps[i].sign(int(att.hash()))))
            else:
                signed.append(None)
        native.update_op(kps[i].public_key, signed)
    expect = [int(s) for s in native.converge()]
    matrix, _ = native.opinion_matrix()
    got = fo.field_converge(fo.FieldCtx(Fr.MODULUS), matrix, [1000] * n, 20,
                            device="cpu")
    assert got == expect


def test_field_converge_zero_row_normalization():
    """A zero opinion row (inverse-or-zero) must not poison scores; the
    host twin of the same semantics is the oracle."""
    p = SECP256K1_P
    matrix = [[0, 5, 0], [3, 0, 7], [0, 0, 0]]
    got = fo.field_converge(fo.FieldCtx(p), matrix, [10, 10, 10], 3,
                            device="cpu")
    s = [10, 10, 10]
    norm = []
    for row in matrix:
        inv = pow(sum(row), p - 2, p) if sum(row) else 0
        norm.append([v * inv % p for v in row])
    for _ in range(3):
        s = [sum(norm[j][i] * s[j] for j in range(3)) % p for i in range(3)]
    assert got == s


def test_port_model_copy_converges_like_the_reference():
    """The port's copy of ``EigenTrustSet`` (its converge oracle) gives
    the reference's scores on the same opinions."""
    from protocol_tpu.models.eigentrust import EigenTrustSet as JSet
    from protocol_tpu.utils.fields import Fr as JFr
    from protocol_tpu_torch.models.eigentrust import EigenTrustSet
    from protocol_tpu_torch.utils.fields import Fr

    n = 3
    ours, ref = EigenTrustSet(n, 10, 1000, Fr(7)), JSet(n, 10, 1000, JFr(7))
    for i in range(n):
        ours.add_member(Fr(100 + i))
        ref.add_member(JFr(100 + i))
    rows = [[0, 2, 5], [4, 0, 0], [0, 0, 0]]
    for i, row in enumerate(rows):
        ours.ops[Fr(100 + i)] = [Fr(v) for v in row]
        ref.ops[JFr(100 + i)] = [JFr(v) for v in row]
    assert [int(s) for s in ours.converge()] == [int(s) for s in
                                                 ref.converge()]
    m, _ = ours.opinion_matrix()
    assert fo.field_converge(fo.FieldCtx(Fr.MODULUS), m, [1000] * n, 10,
                             device="cpu") == [int(s) for s in ours.converge()]
