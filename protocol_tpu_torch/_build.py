"""Build a shared library from one source file, once, at first use.

The port's native code (the Clos planner's C++, the CUDA kernels) ships
as source and is compiled on the machine that runs it into ``build/``
beside this package. The library's name carries a digest of the source
and the compile command, so an edited source or flag never loads a
stale library. Several processes may ask at once (the test suite runs
under several workers): the build holds a file lock, compiles to a
temporary name and moves the result into place with ``os.replace``, so
no process ever loads a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"


def build_shared_library(name: str, src: Path, cmd: list,
                         build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` with ``cmd + ["-o", out, src]`` into ``build_dir``
    unless already built; returns the library path. Raises
    ``RuntimeError`` with the compiler's output when the compile fails."""
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(cmd).encode())
    lib = Path(build_dir) / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
        try:
            proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {src.name} failed ({' '.join(cmd)}):\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib)
        finally:
            if tmp.exists():
                tmp.unlink()
    return lib
