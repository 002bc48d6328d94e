"""The plain reference: EigenTrust by power iteration, in float64.

Written from the definition, in plain torch, with no kernel, plan,
layout or state of the program under test, and importing nothing of
it:

- an attestation ``i → j`` counts when ``i ≠ j``, both peers are valid
  and its value is positive; repeated pairs add up;
- each peer's counted values are divided by their sum (its row), so the
  local trust ``C[i, j]`` of a row sums to 1;
- a valid peer with no counted attestation is dangling: its score goes
  in equal parts to every other valid peer;
- one sweep is ``s' = (1 − α)·(Cᵀs + dangling share) + α·p·Σs``, with
  ``p`` uniform over the valid peers, so the total score is conserved;
- the start gives every valid peer ``initial_score``; the iteration
  stops when one sweep moves the scores by at most ``tol`` of the
  start's total (relative L1).

``precision="float64"`` is the reference. ``precision="bfloat16"`` is
the control: the same iteration with the weights and the score vector
held in bfloat16 and the arithmetic in float32, the step below the
configuration's float32 that a faster program might take.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference iterates to the bottom of float64; the control stops
# where the configuration tells the program to
FLOAT64_TOL = 1e-12
FLOAT64_MAX_ITERATIONS = 20000


def stop_rule(precision: str, cfg: dict) -> tuple:
    """``(tol, max_iterations)`` of a converge in ``precision``."""
    if precision == "float64":
        return FLOAT64_TOL, FLOAT64_MAX_ITERATIONS
    return float(cfg["tol"]), int(cfg["max_iterations"])


def trust_edges(n: int, src, dst, val, valid=None):
    """The counted attestations of a raw edge list: ``(src, dst, val)``
    with repeated pairs summed, sorted by ``(src, dst)``; ``val`` is the
    raw (unnormalised) float64 value."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    val = np.asarray(val, dtype=np.float64)
    valid = (np.ones(n, dtype=bool) if valid is None
             else np.asarray(valid, dtype=bool))
    keep = (src != dst) & valid[src] & valid[dst] & (val > 0)
    key, inv = np.unique(src[keep] * n + dst[keep], return_inverse=True)
    total = np.bincount(inv, weights=val[keep], minlength=len(key))
    return key // n, key % n, total


class TrustGraph:
    """One graph's counted attestations, revisable, and its fixed point.

    ``src``/``dst``/``val`` are the output of :func:`trust_edges`. The
    host keeps the values; :meth:`fixed_point` uploads them to
    ``device`` and iterates there."""

    def __init__(self, n: int, src, dst, val, valid=None, alpha: float = 0.0,
                 device="cpu", precision: str = "float64"):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.n = int(n)
        self.src = np.asarray(src, dtype=np.int64)
        self.dst = np.asarray(dst, dtype=np.int64)
        self.val = np.array(val, dtype=np.float64)
        self.key = self.src * self.n + self.dst
        self.valid = (np.ones(self.n, dtype=bool) if valid is None
                      else np.asarray(valid, dtype=bool))
        self.alpha = float(alpha)
        self.device = torch.device(device)
        self.precision = precision

    def revise(self, batch) -> None:
        """Apply ``[(src, dst, old, new)]``: each pair's value becomes
        ``new``. A pair the graph does not hold is refused."""
        if not len(batch):
            return
        arr = np.asarray(batch, dtype=np.float64)
        key = arr[:, 0].astype(np.int64) * self.n + arr[:, 1].astype(np.int64)
        pos = np.searchsorted(self.key, key)
        pos_c = np.minimum(pos, len(self.key) - 1)
        if not np.all(self.key[pos_c] == key):
            raise ValueError("revision of a pair the graph does not hold")
        self.val[pos_c] = np.maximum(arr[:, 3], 0.0)

    def _operator(self):
        dev, f64 = self.device, torch.float64
        val = torch.from_numpy(self.val).to(dev)
        src = torch.from_numpy(self.src).to(dev)
        dst = torch.from_numpy(self.dst).to(dev)
        row = torch.zeros(self.n, dtype=f64, device=dev).index_add_(
            0, src, val)
        w = torch.where(val > 0, val / torch.where(row[src] > 0, row[src],
                                                   1.0), 0.0)
        valid = torch.from_numpy(self.valid).to(dev).to(f64)
        dangling = valid * (row == 0).to(f64)
        return src, dst, w, valid, dangling

    def fixed_point(self, initial_score: float, tol: float,
                    max_iterations: int, s0=None):
        """Iterate from ``s0`` (node order; default: ``initial_score`` on
        every valid peer). Returns ``(scores, iterations, delta)``,
        the scores as float64 numpy."""
        src, dst, w, valid, dangling = self._operator()
        n_valid = float(valid.sum())
        denom = max(n_valid - 1.0, 1.0)
        pre = valid / max(n_valid, 1.0)
        alpha = self.alpha
        if self.precision == "bfloat16":
            def rnd(x):
                return x.to(torch.bfloat16).to(torch.float32)
            w, valid, dangling, pre = (rnd(w), valid.float(),
                                       dangling.float(), pre.float())
        else:
            def rnd(x):
                return x
        if s0 is None:
            s = valid.to(torch.float64) * float(initial_score)
        else:
            s = torch.as_tensor(np.asarray(s0, dtype=np.float64),
                                device=self.device)
        s = rnd(s.to(w.dtype))
        norm = max(float(s.abs().sum()), 1.0)
        delta, it = float("inf"), 0
        while delta > tol and it < max_iterations:
            base = torch.zeros_like(s).index_add_(0, dst, w * s[src])
            d_mass = (s * dangling).sum()
            corr = (d_mass - dangling * s) / denom
            nxt = ((1.0 - alpha) * (base + corr * valid)
                   + alpha * pre * (s * valid).sum())
            nxt = rnd(nxt)
            delta = float((nxt - s).abs().sum()) / norm
            s, it = nxt, it + 1
        return s.to(torch.float64).cpu().numpy(), it, delta


def compare(scores, reference) -> dict:
    """The numbers that decide ``correct`` for one answer: ``rel_l1``,
    the L1 distance over the reference's L1 norm, and ``max_rel``, the
    largest distance of one peer over that peer's reference score
    (peers with a positive reference score). A missing, misshapen or
    non-finite answer reads ``inf``."""
    ref = np.asarray(reference, dtype=np.float64)
    got = None if scores is None else np.asarray(scores, dtype=np.float64)
    if got is None or got.shape != ref.shape or not np.all(np.isfinite(got)):
        return {"rel_l1": float("inf"), "max_rel": float("inf")}
    diff = np.abs(got - ref)
    pos = ref > 0
    return {
        "rel_l1": float(diff.sum() / max(np.abs(ref).sum(), 1e-300)),
        "max_rel": float(np.max(diff[pos] / ref[pos])) if pos.any() else 0.0,
    }
