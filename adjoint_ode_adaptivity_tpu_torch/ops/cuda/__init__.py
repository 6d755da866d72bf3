"""Hand-written CUDA kernels for the DG hot loops, and their loader.

The sources live in the package's ``csrc/``. :func:`load_library` compiles
them with plain ``nvcc -shared`` (sm_90a, a C interface, no PyTorch headers)
into ``build/torch_kernels/`` at the root of the checkout on first use,
cached by a hash of the sources and flags, and loads the result with ctypes.
Nothing is built when a module is imported, so CPU-only machines import
every module and run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["pick_chunk", "load_library", "KernelLibrary"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def pick_chunk(n_steps: int, candidates=(64, 32, 16, 8, 4, 2, 1)) -> int:
    """Largest candidate chunk/segment size that divides ``n_steps``."""
    return next(c for c in candidates if n_steps % c == 0)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built only on a machine with "
        "the CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


class KernelLibrary:
    """The loaded kernel library: ctypes entry points with declared
    argument types, plus where and how long the build took."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.dg_fwd_march.argtypes = [i, i, i, i, d, d, d] + [p] * 11
        lib.dg_fwd_march.restype = i
        lib.dg_adj_est_stored.argtypes = [i, i, i, i, d, d, d] + [p] * 15
        lib.dg_adj_est_stored.restype = i
        lib.dg_error_string.argtypes = [i]
        lib.dg_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.lib.dg_error_string(code).decode()
            raise RuntimeError(f"{what} failed: error {code} ({msg})")


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libaoa_kernels-{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(s) for s in sources if s.suffix == ".cu"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(out, build_seconds, log)
