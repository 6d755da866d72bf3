"""Hand-written CUDA kernels (the DG advection pipelines — stored, recompute,
element-tiled, element-sharded and the MXU layout —, the FD, DG-in-time and
hp DG-in-time hot loops, the two fused training epochs and the limited
Burgers march), and their loader.

The sources live in the package's ``csrc/``. :func:`load_library` compiles
them with plain ``nvcc`` (sm_90a, a C interface, no PyTorch headers), one
``nvcc -c`` per source, all started together, then links one shared library
into ``build/torch_kernels/`` at the root of the checkout on first use,
cached by a hash of the sources and flags, and loads the result with ctypes.
:func:`load_user_library` builds a user library the same way for a
caller's traced callables (ops/cuda/functor.py): only the sources a kernel
needs, with the generated header, under ``build/torch_kernels/user/``.
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
    "load_user_library",
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
    """A loaded kernel library: ctypes entry points with declared argument
    types (for the symbols it has: a user library holds one source's), plus
    where and how long the build took."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        signatures = {
            "dg_fwd_march": [i] * 10 + [d] * 3 + [p] * 11,
            "dg_adj_est_stored": [i] * 9 + [d] * 3 + [p] * 13,
            "dg_adj_est_recompute": [i] * 9 + [d] * 3 + [p] * 14,
            "dg_adj_march": [i] * 8 + [p] * 10,
            "dg_mxu_fwd": [i] * 8 + [p] * 9,
            "dg_mxu_rev": [i] * 8 + [p] * 11,
            "fd_ensemble": [i, i, i, i, p] + [i] * 5 + [p] * 4,
            "fd_ensemble_vec": [i] * 7 + [p] * 4,
            "fd_estimate_per_member": ([i, i, i, p, i, i, i, i, ctypes.c_float]
                                       + [i] * 3 + [p] * 5),
            "dg_estimate_ensemble": [i] * 5 + [p] * 2 + [i] * 10 + [p] * 6,
            "dg_estimate_hp_per_member": [i] * 4 + [p] * 2 + [i] * 11 + [p] * 8,
            "resblock_epoch_grad": [i] * 5 + [p] * 6 + [d] * 2 + [p] * 5,
            "dense_epoch_grad": [i, p] + [i] * 5 + [p] * 4 + [d] + [p] * 6,
            "burgers_march_f32": [i] * 9 + [p] * 7,
            "burgers_march_f64": [i] * 9 + [p] * 7,
        }
        for name, argtypes in signatures.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = i
        for name in ("dg_error_string", "fd_error_string", "dg_slab_error_string",
                     "dg_slab_mixed_error_string", "train_fused_error_string",
                     "train_dense_error_string", "burgers_error_string",
                     "dg_mxu_error_string"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [i]
                getattr(lib, name).restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str, error_string=None) -> None:
        """Raise when a C entry point returned ``code`` != 0, with the
        message of ``error_string`` (the source file's own, default dg_rhs.cu's)."""
        if code != 0:
            msg = (error_string or self.lib.dg_error_string)(code).decode()
            raise RuntimeError(f"{what} failed: error {code} ({msg})")


def _build(out: Path, units, extra_flags=()) -> None:
    """``nvcc -c`` each of ``units`` (all started together) and link them
    into ``out``; the compilers' output goes to ``out``'s ``.log``."""
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{s.stem}-{tag}.o" for s in units]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(s), "-o", str(o)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(units, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    out.with_suffix(".log").write_text("".join(logs))
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


def _loaded(out: Path, t0: float) -> KernelLibrary:
    log_path = out.with_suffix(".log")
    build_seconds = time.perf_counter() - t0
    return KernelLibrary(out, build_seconds, log_path.read_text() if log_path.exists() else "")


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
    t0 = time.perf_counter()
    if not out.exists():
        _build(out, [s for s in sources if s.suffix == ".cu"])
    return _loaded(out, t0)


@functools.cache
def load_user_library(sources: tuple, header: str) -> KernelLibrary:
    """Build (once per hash of ``sources``, every csrc header, ``header``
    and the flags) and load a user library: the csrc files ``sources``
    (e.g. ``("dg_slab.cu",)``) compiled with ``-DAOA_USER_FUNCTORS`` and the
    generated ``header`` as ``aoa_user_functors.cuh`` (ops/cuda/functor.py),
    so that their switches take the traced functors alone. The library and
    its header sit in ``build/torch_kernels/user/``; ``build_seconds`` and
    ``build_log`` are this build's."""
    units = [CSRC_DIR / name for name in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in units + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(header.encode())
    key = digest.hexdigest()[:16]
    inc = BUILD_DIR / "user" / key
    out = inc.parent / f"libaoa_user-{key}.so"
    t0 = time.perf_counter()
    if not out.exists():
        # written whole under a name of its own, then renamed: a process
        # building the same library beside this one reads a complete header
        inc.mkdir(parents=True, exist_ok=True)
        tmp = inc / f"aoa_user_functors.cuh.{os.getpid()}.tmp"
        tmp.write_text(header)
        os.replace(tmp, inc / "aoa_user_functors.cuh")
        _build(out, units, ("-DAOA_USER_FUNCTORS", "-I", str(inc)))
    return _loaded(out, t0)
