#!/usr/bin/env python3
"""The registry FD kernels' bits of a checkout, on one GPU: digests of F1
(sin u), F2 (the harmonic oscillator) and F3 (sin u, strided) at
chip_smoke.py's phase-6 inputs (``fd_inputs``: 102,400 ICs, 16 steps,
rf 4, dt = 2/16; the per-member study's B = 1024 widths over 43 steps),
and of F2 on phase 42's traced callables at d = 2, 3 and 4 (Van der Pol,
the rigid body, the coupled oscillators; its draws, the same shape),
computed with the package (and chip_smoke.py's callables) of the checkout
at ROOT.

    python3 tools/torch_fd_digests.py ROOT

ROOT is a checkout with ``adjoint_ode_adaptivity_tpu_torch/`` (for example
``git archive <commit> | tar -x -C build/parent``); its kernels build into
ROOT/build/torch_kernels/. Prints one JSON object, the keys of
chip_smoke.py's ``PARENT_DIGESTS`` for these kernels; phase 42 asserts that
this checkout's registry modes give the pinned parent's bits.
"""
import hashlib
import json
import sys

import numpy as np


def digest(tensors) -> str:
    """sha256 (16 hex digits) of the tensors' bytes in order (chip_smoke.py's)."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(dev) -> dict:
    """The digests on the card ``dev``, by chip_smoke.py's PARENT_DIGESTS
    keys, with the package first on sys.path."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, b, s, rf, dt = 102_400, 1024, 43, 4, 2.0 / 16  # chip_smoke.py FD_ENSEMBLE, FD_STUDY
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)  # chip_smoke.py fd_inputs' draws, in its order
    times = np.full((b, s + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, s + 1, b)):
        times[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.uniform(0.0, 2.0, n_act - 1)), [2.0]])
    u0 = torch.tensor(np.random.default_rng(0).uniform(-3, 3, n), **f32)
    u0_vec = torch.tensor(np.random.default_rng(21).uniform(-1, 1, (n, 2)), **f32)
    u0_pm = torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, b), **f32)
    dt_pm = torch.tensor(np.diff(times, axis=1), **f32).contiguous()
    out = {
        f"F1 {n}": digest([fe.make_cuda_fd_ensemble("du/dt=sin(u)", 16, rf, dt, device=dev)(u0)]),
        f"F2 {n}": digest([fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", 16, rf, dt,
                                                        device=dev)(u0_vec)]),
        f"F3 {b}": digest(fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", s, rf, "strided",
                                                              device=dev)(dt_pm, u0_pm)),
    }
    import chip_smoke as cs

    for d, (comps, jac) in {2: (cs.vdp_comps, cs.vdp_jac),
                            **{d: v[1:] for d, v in cs.USER_VECTOR_D.items()}}.items():
        u0d = torch.tensor(np.random.default_rng(40 + d).uniform(-1.5, 1.5, (n, d)), **f32)
        run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=16,
                                           ref_factor=rf, dt=dt, device=dev)
        out[f"F2 traced d={d} {n}"] = digest([run(u0d)])
    return out


def main(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(json.dumps(digests(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
