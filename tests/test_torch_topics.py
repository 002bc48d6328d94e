"""The port's topic batch against independent reference converges.

K topic vectors go through one operator in one batched loop; each topic
must match the reference's own converge of that topic, run alone (never
the reference's batched output: its batched parity test is a known
failure, ``ROADMAP.md`` C). Float64, within 1e-12 relative with equal
iterations. The batched route (``[K, E]`` through one set of stages)
must equal K single routes bit for bit, and the batch must pay one
routing-plan build.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import backend as ref_backend
from protocol_tpu.graph import barabasi_albert_edges
from protocol_tpu_torch import backend as port_backend
from protocol_tpu_torch.ops.clos import plan_route, route_core
from protocol_tpu_torch.ops.kernels import route_stage_plain
from protocol_tpu_torch.utils import trace as port_trace

N, K = 400, 5   # the reference's topic test
MAX_IT = 300    # room for every topic to reach tol, each at its own count


@pytest.fixture(scope="module")
def topics():
    src, dst, val = barabasi_albert_edges(N, 4, seed=11)
    s0k = np.random.default_rng(11).uniform(0.5, 1.5, (K, N)) * 1000.0
    # one topic starts at (near) its fixed point, so it stops long before
    # the others and must stay frozen while they sweep on
    s0k[0] = ref_backend.JaxSparseBackend(dtype=jnp.float64).converge_edges(
        N, src, dst, val, None, 1000.0, MAX_IT, tol=1e-9, alpha=0.1)[0]
    return src, dst, val, s0k


@pytest.mark.parametrize("engine", ["sparse", "routed"])
def test_topic_batch_matches_independent_reference_converges(topics, engine):
    src, dst, val, s0k = topics
    ref_cls, port_cls = {
        "sparse": (ref_backend.JaxSparseBackend,
                   port_backend.TorchSparseBackend),
        "routed": (ref_backend.JaxRoutedBackend,
                   port_backend.TorchRoutedBackend)}[engine]
    ref = ref_cls(dtype=jnp.float64)
    want = [ref.converge_edges(N, src, dst, val, None, 1000.0, MAX_IT,
                               tol=1e-6, alpha=0.1, s0=s0k[t])
            for t in range(K)]
    tracer = port_trace.TRACER
    was = tracer.enabled
    tracer.reset_instruments()
    tracer.enable()
    try:
        scores, iters, delta = port_cls(
            dtype=torch.float64, device="cpu").converge_topics(
            N, src, dst, val, None, s0k, MAX_IT, tol=1e-6, alpha=0.1)
        built = port_trace.counter_total("operator_full_builds")
    finally:
        tracer.reset()
        tracer.reset_instruments()
        if not was:
            tracer.disable()
    assert built == (1 if engine == "routed" else 0)
    assert scores.shape == (K, N) and iters.shape == delta.shape == (K,)
    assert len(set(iters.tolist())) > 1, "every topic stopped together"
    assert max(iters) < MAX_IT and max(delta) <= 1e-6
    for t, (s, it, d) in enumerate(want):
        assert int(iters[t]) == it, t
        assert abs(float(delta[t]) - d) <= 1e-12
        assert np.max(np.abs(scores[t] - s)) <= 1e-12 * np.max(np.abs(s)), t


def test_batched_plain_route_equals_k_single_routes():
    rng = np.random.default_rng(4)
    e = 16
    plan = plan_route(rng.permutation(1 << e))
    stages = tuple(torch.from_numpy(s) for s in plan.stages)
    x = torch.from_numpy(rng.standard_normal((K, 1 << e)))
    y = route_core(x, stages, 0, plan.e, plan.bits, stage=route_stage_plain)
    for t in range(K):
        single = route_core(x[t], stages, 0, plan.e, plan.bits,
                            stage=route_stage_plain)
        assert torch.equal(y[t], single)


def test_topic_batch_validates_shape():
    with pytest.raises(ValueError, match=r"s0_topics must be"):
        port_backend.TorchSparseBackend(device="cpu").converge_topics(
            10, np.array([0]), np.array([1]), np.array([1.0]), None,
            np.ones(10), 10)
