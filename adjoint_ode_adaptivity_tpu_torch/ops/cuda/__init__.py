"""Hand-written CUDA kernels (the DG advection pipelines — stored, recompute,
element-tiled, element-sharded and the MXU layout —, the FD, DG-in-time and
hp DG-in-time hot loops, the two fused training epochs and the limited
Burgers march), and their loader.

The sources live in the package's ``csrc/``. :func:`load_library` compiles
them with plain ``nvcc`` (sm_90a, a C interface, no PyTorch headers), one
``nvcc -c`` per source, all started together, then links one shared library
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

import torch

__all__ = [
    "pick_chunk",
    "load_library",
    "KernelLibrary",
    "require_device",
    "make_cuda_fwd_adj_estimate_grid_mxu",
    "make_cuda_fwd_adj_estimate_sharded_blocked",
    "make_cuda_fwd_adj_estimate_tiled_grid_sharded",
]

# entry points of the kernel modules exported here, each loaded on first use
# (the kernel modules import this one)
_ENTRY_POINTS = {
    "make_cuda_fwd_adj_estimate_grid_mxu": "dg_mxu",
    "make_cuda_fwd_adj_estimate_sharded_blocked": "dg_sharded",
    "make_cuda_fwd_adj_estimate_tiled_grid_sharded": "dg_sharded",
}


def __getattr__(name):
    if name in _ENTRY_POINTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_ENTRY_POINTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def pick_chunk(n_steps: int, candidates=(64, 32, 16, 8, 4, 2, 1)) -> int:
    """Largest candidate chunk/segment size that divides ``n_steps``."""
    return next(c for c in candidates if n_steps % c == 0)


def require_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`. A CUDA device that is not
    there raises: the port's entry points run on the card unless the caller
    asks for the CPU, and never carry on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (pass device='cpu' "
            "to run on the CPU)"
        )
    return device


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
        lib.dg_fwd_march.argtypes = [i] * 9 + [d] * 3 + [p] * 11
        lib.dg_fwd_march.restype = i
        lib.dg_adj_est_stored.argtypes = [i] * 9 + [d] * 3 + [p] * 13
        lib.dg_adj_est_stored.restype = i
        lib.dg_adj_est_recompute.argtypes = [i] * 9 + [d] * 3 + [p] * 14
        lib.dg_adj_est_recompute.restype = i
        lib.dg_adj_march.argtypes = [i] * 8 + [p] * 10
        lib.dg_adj_march.restype = i
        lib.dg_tiled_fwd.argtypes = [i] * 7 + [d] * 3 + [p] * 10
        lib.dg_tiled_fwd.restype = i
        lib.dg_mxu_fwd.argtypes = [i] * 8 + [p] * 9
        lib.dg_mxu_fwd.restype = i
        lib.dg_mxu_rev.argtypes = [i] * 8 + [p] * 11
        lib.dg_mxu_rev.restype = i
        lib.fd_ensemble.argtypes = [i, i, i, i, p, i, i, i, p, p, p, p]
        lib.fd_ensemble.restype = i
        lib.fd_ensemble_vec.argtypes = [i, i, i, i, p, p, p, p]
        lib.fd_ensemble_vec.restype = i
        lib.fd_estimate_per_member.argtypes = ([i, i, i, p, i, i, i, i, ctypes.c_float]
                                               + [i] * 3 + [p] * 5)
        lib.fd_estimate_per_member.restype = i
        lib.dg_estimate_ensemble.argtypes = [i] * 4 + [p] * 2 + [i] * 10 + [p] * 6
        lib.dg_estimate_ensemble.restype = i
        lib.dg_estimate_hp_per_member.argtypes = [i] * 3 + [p] * 2 + [i] * 11 + [p] * 8
        lib.dg_estimate_hp_per_member.restype = i
        lib.resblock_epoch_grad.argtypes = [i] * 5 + [p] * 6 + [d] * 2 + [p] * 5
        lib.resblock_epoch_grad.restype = i
        lib.dense_epoch_grad.argtypes = [i, p] + [i] * 4 + [p] * 4 + [d] + [p] * 6
        lib.dense_epoch_grad.restype = i
        for name in ("burgers_march_f32", "burgers_march_f64"):
            getattr(lib, name).argtypes = [i] * 9 + [p] * 7
            getattr(lib, name).restype = i
        for name in ("dg_error_string", "fd_error_string", "dg_slab_error_string",
                     "dg_slab_mixed_error_string", "train_fused_error_string",
                     "train_dense_error_string", "burgers_error_string",
                     "dg_tiled_error_string", "dg_mxu_error_string"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str, error_string=None) -> None:
        """Raise when a C entry point returned ``code`` != 0, with the
        message of ``error_string`` (the source file's own, default dg_rhs.cu's)."""
        if code != 0:
            msg = (error_string or self.lib.dg_error_string)(code).decode()
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
        nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
        units = [s for s in sources if s.suffix == ".cu"]
        objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in units]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(units, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log_path.write_text("".join(logs))
        for src, proc, log in zip(units, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for o in objs:
            o.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(out, build_seconds, log)
