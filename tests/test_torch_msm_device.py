"""The port's device MSM (``protocol_tpu_torch/ops/msm_device.py``) held
bit for bit against the reference's host oracle
``protocol_tpu.zk.bn254.g1_msm`` on the CPU, where every field launch is
the kernels' plain torch version.

A full 264-bit sweep costs about 30 s an MSM on this CPU (one plain
``_add`` on one lane takes ~17 ms), so every case bounds the sweep with
``scalar_bits`` ≤ 8; the card runs the full width in ``chip_smoke.py``.
The reference's own ``msm_device`` is not run: its eager CPU pipeline
takes tens of seconds even at 4 points. Each case also counts the plain
field calls and holds them to ``launch_counts``, the count
``chip_smoke.py`` checks the card's launches against."""

import random

import pytest

from protocol_tpu.zk.bn254 import G1_GEN, R as FR, g1_msm, g1_mul
from protocol_tpu_torch.ops import msm_device as md
from protocol_tpu_torch.ops.kernels import field_kernel as fk

P = md.BN254_FQ_MODULUS


def _points(n, seed):
    rng = random.Random(seed)
    return [g1_mul(G1_GEN, rng.randrange(1, FR)) for _ in range(n)]


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the plain field versions' calls (the CPU's launches)."""
    counts = dict.fromkeys(fk._PLAIN, 0)
    for name, fn in list(fk._PLAIN.items()):
        def counted(x, y, ctx, name=name, fn=fn):
            counts[name] += 1
            return fn(x, y, ctx)
        monkeypatch.setitem(fk._PLAIN, name, counted)
    return counts


def _scalars(n, bits, seed):
    """Seeded scalars below 2^bits with zero digits (zero scalars and
    zero windows) and duplicate digits (repeated scalars, one bucket
    shared by many points)."""
    rng = random.Random(seed)
    top = 1 << bits
    out = [0, 0, top - 1, top - 1, 1 << (bits - 1)]
    out += [rng.randrange(top) for _ in range(n - len(out))]
    rng.shuffle(out)
    return out[:n]


@pytest.mark.parametrize("c,n,bits", [(2, 4, 4), (3, 9, 6), (4, 16, 8)],
                         ids=["c2-n4", "c3-n9", "c4-n16"])
def test_matches_the_host_oracle(c, n, bits, plain_calls):
    points = _points(n, 0xE11 + c)
    scalars = _scalars(n, bits, c)
    got = md.msm_device(points, scalars, c=c, scalar_bits=bits,
                        device="cpu")
    assert got == g1_msm(points, scalars)
    assert plain_calls == md.launch_counts(n, c, bits)


def test_jacobian_triple_normalised_on_the_host(plain_calls):
    """The reference's tiny CPU case (its fixture: 4 points, 2-bit
    scalars with duplicate digits, c = 2) with ``affine=False``: the
    Jacobian triple, normalised here, is the oracle's point."""
    rng = random.Random(0xE10)
    points = [g1_mul(G1_GEN, rng.randrange(1, FR)) for _ in range(4)]
    scalars = [3, 2, 1, 3]
    x, y, z = md.msm_device(points, scalars, c=2, scalar_bits=2,
                            affine=False, device="cpu")
    zi = pow(z, -1, P)
    assert (x * zi * zi % P, y * zi * zi * zi % P) == g1_msm(points, scalars)
    assert plain_calls == md.launch_counts(4, 2, 2, affine=False)


def test_point_and_its_negation_cancel():
    (p,) = _points(1, 0xE15)
    neg = (p[0], (P - p[1]) % P)
    assert md.msm_device([p, neg], [5, 5], c=2, scalar_bits=3,
                         device="cpu") is None
    assert md.msm_device([p, p], [0, 0], c=2, scalar_bits=2,
                         device="cpu") is None


def test_value_errors():
    points = _points(2, 0xE15)
    with pytest.raises(ValueError, match="bit window bound"):
        md.msm_device(points, [5, 1], c=2, scalar_bits=2, device="cpu")
    with pytest.raises(ValueError, match="divide the 12-bit limb"):
        md.msm_device(points, [1, 1], c=5, device="cpu")
