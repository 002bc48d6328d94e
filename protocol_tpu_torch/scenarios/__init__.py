"""Adversarial scenario harness over the generalized-semiring converge.

The system computes trust scores; this package attacks them. Three
layers:

- :mod:`topologies` — deterministic, seeded, fully vectorized edge-array
  generators for the canonical EigenTrust attack families (sybil rings,
  collusion clusters, slander campaigns) over an honest small-world
  baseline, parameterized by attacker fraction and scale (designed to
  10M peers);
- :mod:`metrics` — robustness outcomes: attacker score-mass capture,
  honest-peer rank displacement vs the attack-free baseline, measured
  iteration counts vs the damped-convergence-bound prediction;
- :mod:`runner` — the reproducible runner behind the ``scenario`` CLI
  verb and ``chip_smoke.py``'s scenario phase: one seeded run of {topology x semiring} through the ConvergeBackend
  seam, emitting a deterministic JSON report (byte-identical across
  runs of the same seed — wall-clock timing is opt-in, never default).

The port's copy of ``protocol_tpu/scenarios``: the topologies and
metrics are numpy only and unchanged; the runner converges on torch.
"""

from .metrics import (
    attacker_mass_capture,
    iteration_bound,
    rank_displacement,
    robustness_report,
)
from .runner import SCENARIO_SCHEMA, list_scenarios, run_scenario
from .topologies import (
    ScenarioGraph,
    TOPOLOGIES,
    build_topology,
    collusion_cluster,
    honest_smallworld,
    slander_campaign,
    sybil_ring,
)

__all__ = [
    "ScenarioGraph",
    "TOPOLOGIES",
    "SCENARIO_SCHEMA",
    "attacker_mass_capture",
    "build_topology",
    "collusion_cluster",
    "honest_smallworld",
    "iteration_bound",
    "list_scenarios",
    "rank_displacement",
    "robustness_report",
    "run_scenario",
    "slander_campaign",
    "sybil_ring",
]
