"""Iteration checkpoint / resume for long convergence runs.

The reference persists only final artifacts (params/keys/proofs via the
``Storage`` trait + EigenFile layout, eigentrust/src/storage.rs:25-33,
eigentrust-cli/src/fs.rs:50-84) — runs are seconds-long at N=4 so
mid-computation checkpointing doesn't exist. At 10M peers SURVEY.md §5
requires real iteration checkpointing: a crashed or preempted shard run
must resume from the last completed chunk, not from iteration 0.

Design: numpy ``.npz`` payload + JSON sidecar metadata, written
atomically (tmp + rename) so a partially-written checkpoint is never
observed; ``keep`` bounds disk usage; ``latest()``/``restore()`` drive
resume. Device arrays are fetched to host once per checkpoint interval —
the interval amortizes the transfer, and the payload is just the score
vector (O(n) floats), not the operator.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time

import numpy as np

from .errors import EigenError


class CheckpointManager:
    """Step-indexed checkpoints: ``step-{i}.npz`` + ``step-{i}.json``."""

    def __init__(self, directory: str, keep: int = 2):
        if keep < 1:
            raise EigenError("config_error", "keep must be >= 1")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # --- write ------------------------------------------------------------
    def save(self, step: int, arrays: dict, meta: dict | None = None) -> str:
        """Atomically persist ``arrays`` (name → ndarray) at ``step``."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        base = os.path.join(self.directory, f"step-{step:012d}")
        tmp = base + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, base + ".npz")

        sidecar = {
            "step": step,
            "written_at": time.time(),
            "arrays": {k: list(v.shape) for k, v in arrays.items()},
            **(meta or {}),
        }
        tmp_meta = base + ".tmp.json"
        with open(tmp_meta, "w") as f:
            json.dump(sidecar, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_meta, base + ".json")

        self._gc()
        return base + ".npz"

    def _gc(self) -> None:
        steps = self.steps()
        for step in steps[: -self.keep]:
            base = os.path.join(self.directory, f"step-{step:012d}")
            for suffix in (".npz", ".json"):
                try:
                    os.remove(base + suffix)
                except FileNotFoundError:
                    pass
        # orphan payloads (crash between the payload and sidecar renames)
        # never appear in steps() and would otherwise accumulate forever.
        # Safe here because _gc runs in the writer process after its own
        # sidecar rename completed (single-writer assumption).
        live = set(steps)
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step-(\d{12})\.npz", name)
            if m and int(m.group(1)) not in live:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.directory, name))

    # --- read -------------------------------------------------------------
    def steps(self) -> list:
        """Completed checkpoint steps, ascending. A checkpoint counts
        only when both payload and sidecar exist (atomic-rename order
        guarantees payload-before-sidecar). Leftover ``*.tmp.*`` files
        from a crash mid-save are ignored (and swept) rather than
        breaking resume."""
        out = []
        for name in os.listdir(self.directory):
            if ".tmp." in name:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.directory, name))
                continue
            m = re.fullmatch(r"step-(\d{12})\.json", name)
            if m:
                step = int(m.group(1))
                if os.path.exists(
                    os.path.join(self.directory, f"step-{step:012d}.npz")
                ):
                    out.append(step)
        return sorted(out)

    def latest(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> tuple:
        """Returns (step, arrays, meta); ``step=None`` → latest."""
        if step is None:
            step = self.latest()
            if step is None:
                raise EigenError("file_io_error", "no checkpoint to restore")
        base = os.path.join(self.directory, f"step-{step:012d}")
        try:
            with np.load(base + ".npz") as z:
                arrays = {k: z[k] for k in z.files}
            with open(base + ".json") as f:
                meta = json.load(f)
        except FileNotFoundError as e:
            raise EigenError("file_io_error",
                             f"checkpoint step {step} missing") from e
        return step, arrays, meta
