#!/usr/bin/env python3
"""Time the route-stage kernel of two versions of ``lane_perm.cu`` in
turns on one card.

    python3 tools/torch_stage_ab.py PARENT_CU CHANGE_CU

Builds each CUDA source with nvcc (``sm_90a``) into a temporary
directory, binds its ``route_stage`` with ctypes (a source whose
``route_stage`` takes no ``batch`` argument is bound without it), checks
that both give the same bits, and times the forward form (m = T), the
middle form and the reverse form (m = T) in float32 at T = 262,144 and
8,192 rows, by CUDA-graph replay with the operands cycling through
copies that outgrow the L2 (``chip_smoke.graph_ms``). The rounds run
parent, change, change, parent. Prints one JSON line per round, the
card's name and power limit, and a summary line with each version's
median per form and T.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORMS = {"forward": 0, "middle": 1, "reverse": 2}
SHAPES = ((262_144, 20), (8192, 200))   # (T, launches per graph)


def bind(src: Path, build_dir: Path):
    from protocol_tpu_torch._build import build_shared_library
    from protocol_tpu_torch.ops.kernels.lane_perm_kernel import _nvcc_path

    cmd = [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    lib = ctypes.CDLL(str(build_shared_library(
        f"ab_{abs(hash(str(src)))}", src, cmd, build_dir=build_dir)))
    has_batch = "int batch," in src.read_text()
    argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int]
    if has_batch:
        argtypes.append(ctypes.c_int)
    lib.route_stage.argtypes = argtypes + [ctypes.c_void_p]
    lib.route_stage.restype = ctypes.c_int

    def stage(x, idx, form: int, m: int):
        import torch

        out = torch.empty_like(x)
        args = [0, form, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                x.shape[0], m.bit_length() - 1]
        if has_batch:
            args.append(1)
        rc = lib.route_stage(*args,
                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"route_stage launch failed: {rc}")
        return out

    return stage


def main() -> int:
    import torch

    from chip_smoke import COLD_BYTES, graph_ms, nvidia_smi_line

    if not torch.cuda.is_available() or len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = (Path(a).resolve() for a in sys.argv[1:])
    with tempfile.TemporaryDirectory() as d:
        stages = {"parent": bind(parent, Path(d)),
                  "change": bind(change, Path(d))}
        g = torch.Generator(device="cuda").manual_seed(3)
        times = {}
        for T, launches in SHAPES:
            sets = min(launches, max(2, -(-COLD_BYTES // (T * 128 * 5))))
            xs = [torch.randn(T, 128, device="cuda", generator=g)
                  for _ in range(sets)]
            idxs = [torch.randint(0, 128, (T, 128), device="cuda",
                                  generator=g, dtype=torch.uint8)
                    for _ in range(sets)]
            for form, f in FORMS.items():
                a = stages["parent"](xs[0], idxs[0], f, T)
                b = stages["change"](xs[0], idxs[0], f, T)
                if not torch.equal(a, b):
                    print(f"{form} at T = {T}: the versions differ",
                          file=sys.stderr)
                    return 1
            for rnd, name in enumerate(("parent", "change", "change",
                                        "parent")):
                row = {"round": rnd, "version": name, "T": T}
                for form, f in FORMS.items():
                    row[form] = graph_ms(
                        lambda i: stages[name](xs[i % sets], idxs[i % sets],
                                               f, T), launches)["ms"]
                    times.setdefault((name, T, form), []).append(row[form])
                print(json.dumps(row), flush=True)
            del xs, idxs
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"median_ms": {
        f"{name} T={T} {form}": statistics.median(v)
        for (name, T, form), v in sorted(times.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
