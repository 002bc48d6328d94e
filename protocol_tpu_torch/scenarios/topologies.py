"""Adversarial trust-graph generators — deterministic, seeded, vectorized.

Every generator returns a :class:`ScenarioGraph`: raw attestation edge
arrays (the exact shape ``graph.filter_edges`` / the backends consume)
plus the ground-truth attacker mask the robustness metrics score
against. Layout convention: honest peers occupy ids ``[0, n_honest)``,
attackers ``[n_honest, n)`` — the mask is the contract, not the id
split, so metrics never assume it.

All randomness flows through one ``np.random.default_rng(seed)`` per
build and every edge family is emitted by whole-array ops (no Python
per-edge loops), so a 10M-peer graph builds in seconds and the same
seed reproduces the same arrays byte-for-byte on any box.

The attack families are the classic EigenTrust threat models:

- **sybil ring**: attackers attest each other in a cycle at maximum
  value, funneling extra weight into one front sybil; a small fooled
  fraction of honest peers attests the front (the bridge mass every
  sybil analysis shows is the attack's real budget).
- **collusion cluster**: attackers form dense mutual-attestation
  cliques and camouflage with low-value attestations toward random
  honest peers, plus the same fooled-bridge in-mass.
- **slander campaign**: attackers rate many honest peers at the
  maximum value but the victim set at the minimum — under row
  normalization the victims' share of every attacker row collapses,
  displacing their rank without a single forged positive edge.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class ScenarioGraph:
    """One generated scenario: raw edges + ground-truth attacker mask."""

    name: str
    n: int
    src: np.ndarray        # int64 attester ids
    dst: np.ndarray        # int64 subject ids
    val: np.ndarray        # float64 attestation values (> 0)
    attacker: np.ndarray   # bool [n] — ground truth for the metrics
    params: dict = field(default_factory=dict)

    @property
    def n_attackers(self) -> int:
        return int(self.attacker.sum())


def _smallworld_edges(n: int, k: int, rewire: float,
                      rng: np.random.Generator, low: int, high: int):
    """Watts–Strogatz-style directed small world over ids [0, n): ring
    lattice (each peer attests its k nearest neighbors, both sides) with
    a ``rewire`` fraction of targets re-pointed uniformly. Vectorized:
    one (n, k) offset grid, one rewire mask draw."""
    half = max(1, k // 2)
    offs = np.concatenate([np.arange(1, half + 1),
                           -np.arange(1, half + 1)])
    src = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    dst = (src + np.tile(offs, n)) % n
    moved = rng.random(len(dst)) < rewire
    dst = np.where(moved, rng.integers(0, n, len(dst)), dst)
    val = rng.integers(low, high + 1, len(src)).astype(np.float64)
    return src, dst, val


def honest_smallworld(peers: int = 10_000, seed: int = 0, k: int = 8,
                      rewire: float = 0.1, low: int = 1,
                      high: int = 10) -> ScenarioGraph:
    """The attack-free control: every peer is honest. The baseline the
    robustness metrics rank-compare against uses exactly this shape."""
    if peers < 4:
        raise ValueError("smallworld needs >= 4 peers")
    rng = np.random.default_rng(seed)
    src, dst, val = _smallworld_edges(peers, k, rewire, rng, low, high)
    return ScenarioGraph(
        name="smallworld", n=peers, src=src, dst=dst, val=val,
        attacker=np.zeros(peers, dtype=bool),
        params={"peers": peers, "seed": seed, "k": k, "rewire": rewire,
                "low": low, "high": high})


def _split(peers: int, attacker_fraction: float):
    n_att = int(round(peers * attacker_fraction))
    n_att = min(max(n_att, 1), peers - 2)
    return peers - n_att, n_att


def _bridges(rng, n_honest: int, n_att: int, fooled_fraction: float,
             front: np.ndarray, high: int):
    """The fooled-honest in-mass every attack needs: a seeded sample of
    honest peers attests attacker entry points at full value."""
    n_fooled = max(1, int(round(n_honest * fooled_fraction)))
    fooled = rng.choice(n_honest, size=min(n_fooled, n_honest),
                        replace=False).astype(np.int64)
    b_dst = front[rng.integers(0, len(front), len(fooled))]
    b_val = np.full(len(fooled), float(high))
    return fooled, b_dst, b_val


def sybil_ring(peers: int = 10_000, attacker_fraction: float = 0.1,
               seed: int = 0, k: int = 8, rewire: float = 0.1,
               fooled_fraction: float = 0.01, low: int = 1,
               high: int = 10) -> ScenarioGraph:
    """Sybil ring: attackers cycle maximum-value attestations and every
    sybil additionally endorses the ring's front node."""
    n_honest, n_att = _split(peers, attacker_fraction)
    rng = np.random.default_rng(seed)
    h_src, h_dst, h_val = _smallworld_edges(n_honest, k, rewire, rng,
                                            low, high)
    att = np.arange(n_honest, peers, dtype=np.int64)
    front = att[:1]
    ring_src = att
    ring_dst = np.roll(att, -1)
    ring_val = np.full(n_att, float(high))
    # the funnel: every sybil (front included — a self-edge the filter
    # drops) also endorses the front at max value
    fun_src = att
    fun_dst = np.full(n_att, front[0], dtype=np.int64)
    fun_val = np.full(n_att, float(high))
    fooled, b_dst, b_val = _bridges(rng, n_honest, n_att,
                                    fooled_fraction, front, high)
    src = np.concatenate([h_src, ring_src, fun_src, fooled])
    dst = np.concatenate([h_dst, ring_dst, fun_dst, b_dst])
    val = np.concatenate([h_val, ring_val, fun_val, b_val])
    attacker = np.zeros(peers, dtype=bool)
    attacker[n_honest:] = True
    return ScenarioGraph(
        name="sybil-ring", n=peers, src=src, dst=dst, val=val,
        attacker=attacker,
        params={"peers": peers, "attacker_fraction": attacker_fraction,
                "seed": seed, "k": k, "rewire": rewire,
                "fooled_fraction": fooled_fraction, "low": low,
                "high": high})


def collusion_cluster(peers: int = 10_000, attacker_fraction: float = 0.1,
                      seed: int = 0, k: int = 8, rewire: float = 0.1,
                      cluster_size: int = 16, camouflage: int = 2,
                      fooled_fraction: float = 0.01, low: int = 1,
                      high: int = 10) -> ScenarioGraph:
    """Collusion clusters: attackers in cliques of ``cluster_size``
    cross-attest at max value and camouflage with ``camouflage``
    low-value attestations toward random honest peers each."""
    n_honest, n_att = _split(peers, attacker_fraction)
    rng = np.random.default_rng(seed)
    h_src, h_dst, h_val = _smallworld_edges(n_honest, k, rewire, rng,
                                            low, high)
    att = np.arange(n_honest, peers, dtype=np.int64)
    csize = max(2, min(cluster_size, n_att))
    cluster_of = (att - n_honest) // csize
    # intra-cluster: each member attests min(csize-1, 4) random
    # fellow members (offset 1..csize-1 within the cluster, mod its
    # true size — vectorized, self-edges impossible)
    fan = min(csize - 1, 4)
    c_src = np.repeat(att, fan)
    base = np.repeat(cluster_of * csize, fan)
    within = np.repeat(att - n_honest - cluster_of * csize, fan)
    cl_n = np.repeat(np.minimum((cluster_of + 1) * csize, n_att)
                     - cluster_of * csize, fan)
    step = rng.integers(1, np.maximum(cl_n, 2))
    c_dst = n_honest + base + (within + step) % cl_n
    c_val = np.full(len(c_src), float(high))
    # camouflage: low-value attestations toward random honest peers
    cam_src = np.repeat(att, camouflage)
    cam_dst = rng.integers(0, n_honest, len(cam_src)).astype(np.int64)
    cam_val = np.full(len(cam_src), float(low))
    fronts = att[cluster_of * csize == att - n_honest]  # cluster heads
    fooled, b_dst, b_val = _bridges(rng, n_honest, n_att,
                                    fooled_fraction, fronts, high)
    src = np.concatenate([h_src, c_src, cam_src, fooled])
    dst = np.concatenate([h_dst, c_dst, cam_dst, b_dst])
    val = np.concatenate([h_val, c_val, cam_val, b_val])
    attacker = np.zeros(peers, dtype=bool)
    attacker[n_honest:] = True
    return ScenarioGraph(
        name="collusion", n=peers, src=src, dst=dst, val=val,
        attacker=attacker,
        params={"peers": peers, "attacker_fraction": attacker_fraction,
                "seed": seed, "k": k, "rewire": rewire,
                "cluster_size": cluster_size, "camouflage": camouflage,
                "fooled_fraction": fooled_fraction, "low": low,
                "high": high})


def slander_campaign(peers: int = 10_000, attacker_fraction: float = 0.1,
                     seed: int = 0, k: int = 8, rewire: float = 0.1,
                     victim_fraction: float = 0.05, spread: int = 8,
                     fooled_fraction: float = 0.01, low: int = 1,
                     high: int = 10) -> ScenarioGraph:
    """Slander/badmouthing: each attacker rates ``spread`` random
    honest peers at max value and one victim at the minimum — row
    normalization then collapses the victims' share of attacker mass.
    Victims are the first ``victim_fraction`` of honest ids (the
    metrics read them from ``params["victims"]``)."""
    n_honest, n_att = _split(peers, attacker_fraction)
    rng = np.random.default_rng(seed)
    h_src, h_dst, h_val = _smallworld_edges(n_honest, k, rewire, rng,
                                            low, high)
    att = np.arange(n_honest, peers, dtype=np.int64)
    n_victims = max(1, int(round(n_honest * victim_fraction)))
    # boost edges: max value toward random NON-victim honest peers
    s_src = np.repeat(att, spread)
    s_dst = rng.integers(n_victims, n_honest, len(s_src)).astype(np.int64)
    s_val = np.full(len(s_src), float(high))
    # the slander itself: minimum value toward a victim each
    v_src = att
    v_dst = rng.integers(0, n_victims, n_att).astype(np.int64)
    v_val = np.full(n_att, float(low))
    fooled, b_dst, b_val = _bridges(rng, n_honest, n_att,
                                    fooled_fraction, att[:1], high)
    src = np.concatenate([h_src, s_src, v_src, fooled])
    dst = np.concatenate([h_dst, s_dst, v_dst, b_dst])
    val = np.concatenate([h_val, s_val, v_val, b_val])
    attacker = np.zeros(peers, dtype=bool)
    attacker[n_honest:] = True
    return ScenarioGraph(
        name="slander", n=peers, src=src, dst=dst, val=val,
        attacker=attacker,
        params={"peers": peers, "attacker_fraction": attacker_fraction,
                "seed": seed, "k": k, "rewire": rewire,
                "victim_fraction": victim_fraction, "spread": spread,
                "fooled_fraction": fooled_fraction, "low": low,
                "high": high, "victims": n_victims})


TOPOLOGIES = {
    "smallworld": honest_smallworld,
    "sybil-ring": sybil_ring,
    "collusion": collusion_cluster,
    "slander": slander_campaign,
}


def build_topology(name: str, **kwargs) -> ScenarioGraph:
    """Build a named topology; unknown names raise with the catalog."""
    try:
        builder = TOPOLOGIES[name]
    except KeyError:
        raise ValueError(f"unknown topology {name!r} (have: "
                         f"{sorted(TOPOLOGIES)})") from None
    return builder(**kwargs)
