"""The port's scenario harness against the reference's, on the CPU.

The topologies and metrics are numpy copies: the same seed gives the
same arrays bit for bit and the same metric values. ``run_scenario``
converges through torch on ``device="cpu"`` and is held to the
reference's report on every topology, both semirings and both engines:

- with both sides' backends made float64, every integer field equal
  and every float within 1e-9 relative;
- at the defaults (float32), iterations within one and the attacker
  mass capture within 1e-4 relative (float32 rounding can move a rank
  under ``plusmul``, so ranks are compared only in float64).

Twins of the scenario cases of ``tests/test_scenarios.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu import scenarios as ref
from protocol_tpu.backend import JaxRoutedBackend, JaxSparseBackend
from protocol_tpu.scenarios import metrics as ref_metrics
from protocol_tpu.scenarios import runner as ref_runner
from protocol_tpu_torch import scenarios as port
from protocol_tpu_torch.backend import TorchRoutedBackend, TorchSparseBackend
from protocol_tpu_torch.scenarios import metrics as port_metrics
from protocol_tpu_torch.scenarios import runner as port_runner

TOPOLOGIES = sorted(ref.TOPOLOGIES)
PEERS = 600
SEED = 5


def _ref_backend64(engine):
    return (JaxRoutedBackend if engine == "routed"
            else JaxSparseBackend)(dtype=jnp.float64)


def _port_backend64(engine, device=None):
    return (TorchRoutedBackend if engine == "routed"
            else TorchSparseBackend)(dtype=torch.float64, device=device)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def reports():
    """Reference and port reports, each scenario run once per process:
    ``reports(topology, semiring, engine, f64) -> (ref, port)``."""
    cache = {}

    def get(topology, semiring, engine, f64):
        key = (topology, semiring, engine, f64)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                if f64:
                    mp.setattr(ref_runner, "_make_backend", _ref_backend64)
                    mp.setattr(port_runner, "_make_backend", _port_backend64)
                kw = dict(peers=PEERS, seed=SEED, semiring=semiring,
                          engine=engine)
                cache[key] = (ref.run_scenario(topology, **kw),
                              port.run_scenario(topology, device="cpu", **kw))
        return cache[key]

    return get


# --- topologies, metrics, catalog ------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_arrays_match_reference(name):
    for seed in (13, 14):
        kwargs = {"peers": 800, "seed": seed}
        if name != "smallworld":
            kwargs["attacker_fraction"] = 0.1
        want = ref.build_topology(name, **kwargs)
        got = port.build_topology(name, **kwargs)
        for field in ("src", "dst", "val", "attacker"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
        assert (got.n, got.n_attackers, got.params) == \
            (want.n, want.n_attackers, want.params)
    with pytest.raises(ValueError, match="unknown topology"):
        port.build_topology("star", peers=10)


def test_metrics_match_reference_exactly():
    rng = np.random.default_rng(3)
    for n in (1, 7, 400):
        # rounded scores make ties, which the stable sorts must break alike
        base = np.round(rng.random(n) * 20) / 4
        att = np.round(rng.random(n) * 20) / 4
        attacker = rng.random(n) < 0.2
        for fn, args in (
                ("attacker_mass_capture", (att, attacker)),
                ("attacker_mass_capture", (np.zeros(n), attacker)),
                ("rank_displacement", (base, att, ~attacker)),
                ("attackers_in_top", (att, attacker, 5)),
                ("robustness_report", (att, base, attacker, 17, 0.1, 1e-6)),
                ("robustness_report", (att, base, attacker, 3, 0.0, 1e-6))):
            got = getattr(port_metrics, fn)(*args)
            want = getattr(ref_metrics, fn)(*args)
            assert got == want and type(got) is type(want), (fn, n)
    for alpha, tol in ((0.1, 1e-6), (0.0, 1e-6), (1.0, 1e-6), (0.3, 0.5)):
        assert port_metrics.iteration_bound(alpha, tol) == \
            ref_metrics.iteration_bound(alpha, tol)
    with pytest.raises(ValueError):
        port_metrics.rank_displacement(np.ones(3), np.ones(2),
                                       np.ones(3, bool))


def test_list_scenarios_matches_reference():
    assert port.list_scenarios() == ref.list_scenarios()
    assert port.SCENARIO_SCHEMA == ref.SCENARIO_SCHEMA == "ptpu-scenario-v1"
    assert port_runner.ROUTED_EDGE_THRESHOLD == \
        ref_runner.ROUTED_EDGE_THRESHOLD == 20_000_000


# --- the runner --------------------------------------------------------------

CASES = [(t, s, e) for e in ("sparse", "routed")
         for s in ("plusmul", "maxplus") for t in TOPOLOGIES]


@pytest.mark.parametrize("topology,semiring,engine", CASES)
def test_run_scenario_float64_matches_reference(reports, topology, semiring,
                                                engine):
    want, got = (_flat(r) for r in reports(topology, semiring, engine, True))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            assert isinstance(g, float), k
            assert abs(g - w) <= 1e-9 * abs(w), (k, g, w)
        else:
            assert g == w and type(g) is type(w), (k, g, w)


@pytest.mark.parametrize("topology,semiring,engine", CASES)
def test_run_scenario_float32_matches_reference(reports, topology, semiring,
                                                engine):
    want, got = reports(topology, semiring, engine, False)
    assert got.keys() == want.keys()
    for k in ("schema", "topology", "peers", "edges", "attackers",
              "semiring", "seed", "alpha", "tol", "max_iterations", "engine",
              "params"):
        assert got[k] == want[k], k
    for k in ("iterations", "baseline_iterations"):
        assert abs(got["scores"][k] - want["scores"][k]) <= 1, k
    assert got["scores"]["residual"] <= want["tol"]
    rg, rw = got["robustness"], want["robustness"]
    for k in ("attacker_mass_capture", "baseline_attacker_mass"):
        assert abs(rg[k] - rw[k]) <= 1e-4 * rw[k], k
    assert rg["iteration_bound"] == rw["iteration_bound"]
    assert rg["within_bound"] == rw["within_bound"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_maxplus_routed_equals_sparse(reports, topology):
    """Under (max, min) nothing rounds: the port's routed and gather
    engines give the same scores, so every score-derived field of the
    float32 reports is equal (the residual is a float32 sum taken in
    state-slot order on one engine and node order on the other)."""
    routed = _flat(reports(topology, "maxplus", "routed", False)[1])
    sparse = _flat(reports(topology, "maxplus", "sparse", False)[1])
    for k in routed:
        if k not in ("engine", "scores.residual"):
            assert routed[k] == sparse[k], k
    assert abs(routed["scores.residual"] - sparse["scores.residual"]) \
        <= 1e-5 * sparse["scores.residual"]


def test_scenario_verb_reproducible_and_report_renders(tmp_path, capsys):
    """``scenario run`` twice gives byte-identical JSON, equal to
    ``run_scenario``'s report; ``--out`` then ``report`` round-trips;
    ``--timing`` adds only the opt-in key; ``list`` is the catalog."""
    from protocol_tpu_torch.cli.main import main

    base = ["--assets", str(tmp_path), "scenario"]
    run = [*base, "run", "--topology", "sybil-ring", "--peers", "300",
           "--seed", "7", "--engine", "routed", "--device", "cpu"]
    assert main([*run, "--out", "r.json"]) == 0
    first = capsys.readouterr().out
    assert main(run) == 0
    assert capsys.readouterr().out == first
    report = json.loads(first)
    assert report == port.run_scenario("sybil-ring", peers=300, seed=7,
                                       engine="routed", device="cpu")
    assert (tmp_path / "r.json").read_text() == first
    assert main([*base, "report", "--json", "r.json"]) == 0
    text = capsys.readouterr().out
    assert "topology sybil-ring (300 peers" in text and "WITHIN" in text
    assert main([*run, "--timing"]) == 0
    timed = json.loads(capsys.readouterr().out)
    assert set(timed) - set(report) == {"timing_s"}
    assert set(timed["timing_s"]) == {"build", "attack_converge",
                                      "baseline_converge"}
    assert main([*base, "list"]) == 0
    assert json.loads(capsys.readouterr().out) == ref.list_scenarios()
    assert main([*base, "run", "--topology", "star", "--device", "cpu"]) == 1
    assert "unknown topology" in capsys.readouterr().err


def test_scenario_workload_matches_reference():
    from protocol_tpu.cli import profilecmd as ref_profile
    from protocol_tpu_torch.cli import profilecmd as port_profile

    # the seed and size of the runner cases: the reference's converges
    # are compiled already
    want = ref_profile.run_scenario_workload(peers=PEERS, seed=SEED)
    got = port_profile.run_scenario_workload(peers=PEERS, seed=SEED,
                                             device="cpu")
    assert (got["workload"], got["peers"], got["edges"]) == \
        (want["workload"], want["peers"], want["edges"])
    for name in ("plusmul", "maxplus"):
        assert abs(got["iterations"][name] - want["iterations"][name]) <= 1
        assert abs(got["capture"][name] - want["capture"][name]) \
            <= 1e-4 * want["capture"][name]
