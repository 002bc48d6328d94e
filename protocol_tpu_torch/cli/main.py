"""``sparse-scores``: converge a raw edge-list trust graph on torch.

The port's counterpart of the reference CLI's ``sparse-scores`` verb,
with the same arguments, output CSV and exit codes, plus ``--device``.
The sharded ``--checkpoint-dir`` mode is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import os
import sys
from pathlib import Path

import numpy as np


class CliError(Exception):
    """A user-facing failure: printed as ``error: ...``, exit code 1."""


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="protocol-tpu-torch",
        description="EigenTrust scores on torch (CUDA by default)")
    parser.add_argument("--assets",
                        help="assets directory (default $EIGEN_ASSETS or "
                             "./assets)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "sparse-scores",
        help="converge a raw edge-list trust graph (the scale path)")
    p.add_argument("--edges", required=True,
                   help="CSV of src,dst,weight rows (no header)")
    p.add_argument("--n", type=int, required=True, help="number of peers")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="relative L1 stopping tolerance")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="pre-trust damping factor (0 = reference semantics)")
    p.add_argument("--max-iterations", type=int, default=500)
    p.add_argument("--initial-score", type=float, default=1000.0)
    p.add_argument("--checkpoint-dir",
                   help="sharded checkpointed mode (not available in the "
                        "torch port yet)")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--engine", choices=["auto", "routed", "gather"],
                   default="auto",
                   help="SpMV engine: 'routed' compiles the edge "
                        "permutation to a Clos lane-shuffle network "
                        "(one-time plan build); 'auto' picks it beyond "
                        "100K peers when the native planner builds")
    p.add_argument("--operator-cache",
                   help="directory for compiled routed operators, keyed "
                        "on the edge-list digest (same files as the "
                        "reference CLI's)")
    p.add_argument("--out", default="sparse-scores.csv",
                   help="output CSV (peer_id,score), relative to assets")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the "
                        "CPU)")
    return parser


def _read_edges(path: Path, n: int):
    src_l, dst_l, val_l = [], [], []
    try:
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                src_l.append(int(row[0]))
                dst_l.append(int(row[1]))
                val_l.append(float(row[2]) if len(row) > 2 else 1.0)
    except (OSError, ValueError, IndexError) as e:
        raise CliError(f"bad edge list: {e}") from e
    if not src_l:
        raise CliError("edge list is empty")
    src, dst, val = np.asarray(src_l), np.asarray(dst_l), np.asarray(val_l)
    if src.min() < 0 or dst.min() < 0 or src.max() >= n or dst.max() >= n:
        raise CliError(f"edge endpoints must be in [0, {n})")
    return src, dst, val


def _cached_routed_operator(args, assets: Path, src, dst, val, valid):
    """Load the compiled operator from ``--operator-cache``, else build
    (and store) it. The key is the reference CLI's, so a cache written
    by either package serves both."""
    from ..ops.routed import RoutedOperator, build_routed_operator

    def build():
        return build_routed_operator(args.n, src, dst, val, valid)

    if not args.operator_cache:
        return build()
    h = hashlib.sha256()
    h.update(f"routed:v1:n={args.n}:D=1".encode())
    for a in (src, dst, val):
        h.update(np.ascontiguousarray(a).tobytes())
    cache_dir = Path(args.operator_cache)
    if not cache_dir.is_absolute():
        cache_dir = assets / cache_dir
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"routed_{h.hexdigest()[:24]}.npz"
    if path.exists():
        try:
            return RoutedOperator.load(path)
        except (OSError, ValueError, KeyError) as e:
            print(f"warning: ignoring unreadable operator cache {path}: {e}",
                  file=sys.stderr)
    op = build()
    op.save(path)
    return op


def handle_sparse_scores(args, assets: Path) -> int:
    from .. import native
    from ..backend import TorchRoutedBackend, TorchSparseBackend

    if args.checkpoint_dir:
        raise CliError("--checkpoint-dir (sharded checkpointed converge) is "
                       "not available in the torch port yet")
    edges_path = Path(args.edges)
    if not edges_path.is_absolute():
        edges_path = assets / edges_path
    src, dst, val = _read_edges(edges_path, args.n)

    engine = args.engine
    if engine == "auto":
        engine = ("routed" if args.n >= 100_000 and native.available()
                  else "gather")
    try:
        backend = (TorchRoutedBackend if engine == "routed"
                   else TorchSparseBackend)(device=args.device)
    except RuntimeError as e:  # no GPU and no --device
        raise CliError(str(e)) from e
    valid = np.ones(args.n, dtype=bool)
    extra = {}
    if engine == "routed":
        extra["operator"] = _cached_routed_operator(args, assets, src, dst,
                                                    val, valid)
    scores, iters, delta = backend.converge_edges(
        args.n, src, dst, val, valid, args.initial_score,
        args.max_iterations, tol=args.tol, alpha=args.alpha, **extra)

    out_path = Path(args.out)
    if not out_path.is_absolute():
        out_path = assets / out_path
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["peer_id", "score"])
        for i, s in enumerate(np.asarray(scores)[: args.n]):
            writer.writerow([i, repr(float(s))])
    converged = delta <= args.tol
    print(f"{args.n} peers, {len(src)} edges: "
          f"{'converged' if converged else 'NOT converged'} after "
          f"{int(iters)} iterations (delta {float(delta):.2e})")
    print(f"saved {out_path}")
    return 0 if converged else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    assets = Path(args.assets or os.environ.get("EIGEN_ASSETS", "assets"))
    assets.mkdir(parents=True, exist_ok=True)
    try:
        return handle_sparse_scores(args, assets)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
