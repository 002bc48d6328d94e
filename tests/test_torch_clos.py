"""The port's Clos planner and executor against the reference's.

Permutations are exact: every comparison here is bit for bit. On the CPU
each route stage runs its plain version (``torch.gather`` with the
reference's reshapes and transposes); the CUDA kernel is held against
that plain version on the card by ``tests/test_torch_kernels.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import native as ref_native
from protocol_tpu.ops import clos as ref
from protocol_tpu_torch import native as port_native
from protocol_tpu_torch.ops import clos as port
from protocol_tpu_torch.ops.kernels import FORWARD, MIDDLE, REVERSE, lane_perm

_DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64),
           (np.int32, torch.int32)]


def _values(rng, E, np_dtype):
    if np_dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, E, dtype=np.int32)
    return rng.standard_normal(E).astype(np_dtype)


def test_route_bits_schedule_matches_reference():
    for e in range(1, 32):
        assert port.route_bits(e) == ref.route_bits(e)


@pytest.mark.parametrize("e", [7, 12, 15])
def test_python_planner_stages_match_reference(e):
    perm = np.random.default_rng(e).permutation(1 << e)
    a = ref.plan_route_py(perm)
    b = port.plan_route_py(perm)
    assert (b.e, b.bits) == (a.e, a.bits)
    assert len(b.stages) == len(a.stages) == 2 * len(a.bits) - 1
    for sa, sb in zip(a.stages, b.stages):
        assert sb.dtype == np.uint8 and np.array_equal(sa, sb)


@pytest.mark.parametrize("e", [7, 9, 13, 17])
def test_native_plans_match_reference_native(e):
    """Both packages compile the same planner source; with the threaded
    level-0 fan-out each sub-split writes a disjoint slice, so the plan
    bytes are identical. e=17 crosses into the interleaved-walker path."""
    if not (ref_native.available() and port_native.available()):
        pytest.skip("a native planner library did not build (no g++)")
    perm = np.random.default_rng(100 + e).permutation(1 << e)
    bits = ref.route_bits(e)
    a = ref_native.clos_plan(perm.astype(np.int32), bits)
    b = port_native.clos_plan(perm.astype(np.int32), bits)
    assert np.array_equal(a, b)
    plan = port.plan_route(perm)
    x = np.arange(1 << e, dtype=np.int32)
    assert np.array_equal(port.apply_route_np(plan, x), perm)
    assert np.array_equal(port_native.clos_apply_route(plan.stages, bits, x),
                          perm)


def test_native_planner_rejects_non_permutation():
    if not port_native.available():
        pytest.skip("the native planner library did not build (no g++)")
    with pytest.raises(ValueError):
        port_native.clos_plan(np.zeros(128, dtype=np.int32), port.route_bits(7))


def test_planner_requires_pow2():
    for bad in (np.arange(129), np.arange(64)):
        with pytest.raises(ValueError):
            port.plan_route_py(bad)
        with pytest.raises(ValueError):
            port.plan_route(bad)


@pytest.mark.parametrize("np_dtype,t_dtype", _DTYPES)
@pytest.mark.parametrize("e", [7, 12, 15])
def test_apply_route_matches_reference(e, np_dtype, t_dtype):
    rng = np.random.default_rng(7 * e)
    perm = rng.permutation(1 << e)
    plan = ref.plan_route(perm)
    x = _values(rng, 1 << e, np_dtype)
    want = x[perm]
    y_ref = np.asarray(ref.apply_route(
        jnp.asarray(x), tuple(jnp.asarray(s) for s in plan.stages), plan.e,
        plan.bits, pallas=False))
    stages = tuple(torch.from_numpy(s) for s in plan.stages)
    y = port.apply_route(torch.from_numpy(x), stages, plan.e, plan.bits)
    assert y.dtype == t_dtype
    y = y.numpy()
    assert np.array_equal(y, want)
    assert np.array_equal(y, y_ref)
    assert np.array_equal(y, port.apply_route_np(plan, x))


def test_identity_route_is_identity():
    E = 1 << 10
    plan = port.plan_route_py(np.arange(E))
    x = np.arange(E, dtype=np.float32)
    assert np.array_equal(port.apply_route_np(plan, x), x)
    stages = tuple(torch.from_numpy(s) for s in plan.stages)
    y = port.apply_route(torch.from_numpy(x), stages, plan.e, plan.bits)
    assert np.array_equal(y.numpy(), x)


@pytest.mark.parametrize("T", [1, 7, 8, 9, 64])
def test_lane_perm_plain_matches_take_along_axis(T):
    """The plain version at T < 8 (where the reference never runs its
    Pallas kernel) and T ≥ 8, against the reference's own stage."""
    rng = np.random.default_rng(T)
    for np_dtype, _ in _DTYPES:
        x = _values(rng, T * 128, np_dtype).reshape(T, 128)
        idx = rng.integers(0, 128, (T, 128)).astype(np.uint8)
        y = lane_perm(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        assert np.array_equal(y, np.take_along_axis(x, idx.astype(np.int64),
                                                    axis=1))
        y_ref = np.asarray(ref._lane_perm(jnp.asarray(x), jnp.asarray(idx),
                                          pallas=False))
        assert np.array_equal(y, y_ref)


@pytest.mark.parametrize("np_dtype,t_dtype", _DTYPES)
@pytest.mark.parametrize("e", [7, 12, 15, 20])
def test_route_core_stage_forms_match_reference(e, np_dtype, t_dtype):
    """The port's route, one fused stage form at a time, against the
    reference's ``route_core`` (``pallas=False``) and ``apply_route_np``
    on random stage indices (any uint8 lanes make a route a function,
    not only a plan's): the whole route on B = 1, and the middle levels
    from stage 1 on B = 128 subproblems, as a sharded route runs them."""
    rng = np.random.default_rng(e)
    E = 1 << e
    bits = port.route_bits(e)
    stages = [rng.integers(0, 128, E).astype(np.uint8)
              for _ in range(2 * len(bits) - 1)]
    x = _values(rng, E, np_dtype)
    t_stages = tuple(torch.from_numpy(s) for s in stages)
    j_stages = tuple(jnp.asarray(s) for s in stages)
    runs = [(0, e, bits)]
    if len(bits) > 1:
        runs.append((1, e - 7, bits[1:]))
    for si, e_sub, b in runs:
        forms = [f for _, f, _ in port.route_forms(e_sub, b, si)]
        assert forms == ([FORWARD] * (len(b) - 1) + [MIDDLE]
                         + [REVERSE] * (len(b) - 1))
        y = port.route_core(torch.from_numpy(x), t_stages, si, e_sub, b)
        assert y.dtype == t_dtype
        y_ref = np.asarray(ref.route_core(jnp.asarray(x), j_stages, si,
                                          e_sub, b, pallas=False))
        assert np.array_equal(y.numpy(), y_ref), (si, e_sub, b)
    plan = port.RoutePlan(e=e, bits=bits, stages=stages)
    y = port.apply_route(torch.from_numpy(x), t_stages, e, bits).numpy()
    assert np.array_equal(y, port.apply_route_np(plan, x))
