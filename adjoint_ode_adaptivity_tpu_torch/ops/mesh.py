"""1D mesh generation, connectivity, and the full DG discretization.

Reference parity: ``utils/MeshGen1D.m``, ``utils/Connect1D.m``,
``utils/BuildMaps1D.m``, ``utils/StartUp1D.m``, ``utils/GeometricFactors1D.m``,
``utils/Normals1D.m`` — but instead of a bag of MATLAB globals, everything is
assembled once (float64, host NumPy) into an immutable
:class:`Discretization1D` NamedTuple. Every field is bit-identical to the JAX
package's ``ops/mesh.py``; device tensors are made from it by
``march/advec.py::advec_operators`` and the CUDA entry points.

Notes:
- In 1D the interior face pairing is a pure index shift along the element
  axis; the eager RHS and the CUDA kernels use that shift instead of
  gathering through ``vmapM``/``vmapP``. The general maps are still built —
  they define the semantics and serve the tests.
- ``x`` and all operators are laid out ``(Np, K)``: the element axis K is the
  contiguous one, so neighbouring CUDA threads read neighbouring elements.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from adjoint_ode_adaptivity_tpu_torch.ops.jacobi import jacobi_gl
from adjoint_ode_adaptivity_tpu_torch.ops.operators import (
    dmatrix_1d,
    lift_1d,
    vandermonde_1d,
)

NODETOL = 1e-10

__all__ = ["mesh_gen_1d", "connect_1d", "build_maps_1d", "Discretization1D", "startup_1d"]


def mesh_gen_1d(xmin: float, xmax: float, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Equidistant K-element mesh: vertex coordinates VX and element→vertex EToV."""
    vx = np.linspace(xmin, xmax, k + 1)
    etov = np.stack([np.arange(k), np.arange(1, k + 1)], axis=1)
    return vx, etov


def mesh_from_vertices(vx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mesh from an arbitrary (sorted) vertex vector — non-uniform spatial
    meshes for h-adaptive DG (the reference only ever builds equidistant
    grids; adaptivity there lives in time)."""
    vx = np.asarray(vx, dtype=np.float64)
    if np.any(np.diff(vx) <= 0):
        raise ValueError("vertices must be strictly increasing")
    k = len(vx) - 1
    etov = np.stack([np.arange(k), np.arange(1, k + 1)], axis=1)
    return vx, etov


def connect_1d(etov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Element-to-element (EToE) and element-to-face (EToF) connectivity.

    Faces of element k: face 0 = left vertex, face 1 = right vertex. Boundary
    faces connect to themselves (same convention as the reference toolkit).
    """
    k = etov.shape[0]
    nfaces = 2
    etoe = np.tile(np.arange(k)[:, None], (1, nfaces))
    etof = np.tile(np.arange(nfaces)[None, :], (k, 1))
    # vertex -> (element, face) incidence
    nv = int(etov.max()) + 1
    touching: list[list[tuple[int, int]]] = [[] for _ in range(nv)]
    for e in range(k):
        for f in range(nfaces):
            touching[etov[e, f]].append((e, f))
    for entries in touching:
        if len(entries) == 2:
            (e1, f1), (e2, f2) = entries
            etoe[e1, f1], etof[e1, f1] = e2, f2
            etoe[e2, f2], etof[e2, f2] = e1, f1
    return etoe, etof


def build_maps_1d(
    x: np.ndarray, fmask: np.ndarray, etoe: np.ndarray, etof: np.ndarray
) -> dict[str, np.ndarray]:
    """Volume-node index maps for face traces (vmapM/vmapP) and boundaries.

    ``x`` is (Np, K); fmask the two endpoint node indices. Interior pairing
    requires coincident coordinates (|Δx| < NODETOL), as in
    ``utils/BuildMaps1D.m:27-33``.
    """
    np_, k = x.shape
    nfaces = 2
    nodeids = np.arange(np_ * k).reshape(k, np_).T  # column-major: node n of elem k
    vmap_m = np.zeros((nfaces, k), dtype=np.int64)
    vmap_p = np.zeros((nfaces, k), dtype=np.int64)
    for e in range(k):
        for f in range(nfaces):
            vmap_m[f, e] = nodeids[fmask[f], e]
    xf = x.T.ravel()  # flat volume-node coordinates matching nodeids
    for e in range(k):
        for f in range(nfaces):
            e2, f2 = etoe[e, f], etof[e, f]
            vid_m = vmap_m[f, e]
            vid_p = vmap_m[f2, e2]
            if (xf[vid_m] - xf[vid_p]) ** 2 < NODETOL:
                vmap_p[f, e] = vid_p
            else:  # self-connected boundary face
                vmap_p[f, e] = vid_m
    # flatten in the face-major order used by nx/Fscale: (Nfaces, K) -> F order
    vmap_m_flat = vmap_m.T.ravel()
    vmap_p_flat = vmap_p.T.ravel()
    map_b = np.nonzero(vmap_m_flat == vmap_p_flat)[0]
    vmap_b = vmap_m_flat[map_b]
    return {
        "vmap_m": vmap_m_flat,
        "vmap_p": vmap_p_flat,
        "vmap_b": vmap_b,
        "map_b": map_b,
        "map_i": 0,
        "map_o": 2 * k - 1,
        "vmap_i": 0,
        "vmap_o": np_ * k - 1,
    }


class Discretization1D(NamedTuple):
    """Static nodal-DG discretization: the ``StartUp1D`` output.

    All array fields are host NumPy float64/int64 arrays; the device-side
    operator bundles copy what they need onto an explicit device.
    """

    n: int  # polynomial order
    np_: int  # nodes per element (n+1)
    k: int  # number of elements
    r: np.ndarray  # (Np,) reference GL nodes
    v: np.ndarray  # (Np, Np) Vandermonde
    inv_v: np.ndarray
    dr: np.ndarray  # (Np, Np) differentiation matrix
    lift: np.ndarray  # (Np, 2) surface lift
    vx: np.ndarray  # (K+1,) vertex coords
    etov: np.ndarray  # (K, 2)
    x: np.ndarray  # (Np, K) physical nodes
    rx: np.ndarray  # (Np, K) dr/dx
    jac: np.ndarray  # (Np, K) dx/dr
    nx: np.ndarray  # (2, K) outward face normals
    fscale: np.ndarray  # (2, K) 1/J at faces
    fmask: np.ndarray  # (2,) endpoint node indices
    etoe: np.ndarray  # (K, 2)
    etof: np.ndarray  # (K, 2)
    vmap_m: np.ndarray  # (2K,)
    vmap_p: np.ndarray  # (2K,)
    vmap_b: np.ndarray
    map_b: np.ndarray
    map_i: int
    map_o: int
    vmap_i: int
    vmap_o: int


def startup_1d(
    n: int, xmin: float, xmax: float, k: int, vx: np.ndarray | None = None
) -> Discretization1D:
    """Build the complete 1D DG discretization (order n, K elements).

    Mirrors ``utils/StartUp1D.m`` but returns an immutable pytree instead of
    mutating globals. Pass ``vx`` for a non-uniform mesh (xmin/xmax/k are
    then ignored for vertex placement).
    """
    if vx is not None:
        vx, etov = mesh_from_vertices(vx)
        k = len(vx) - 1
    else:
        vx, etov = mesh_gen_1d(xmin, xmax, k)
    r = jacobi_gl(0.0, 0.0, n)
    np_ = n + 1
    v = vandermonde_1d(n, r)
    dr = dmatrix_1d(n, r, v)
    lift = lift_1d(np_, v)
    va, vb = etov[:, 0], etov[:, 1]
    x = vx[va][None, :] + 0.5 * (r[:, None] + 1.0) * (vx[vb] - vx[va])[None, :]
    xr = dr @ x
    jac = xr
    rx = 1.0 / jac
    fmask = np.array(
        [int(np.argmin(np.abs(r + 1))), int(np.argmin(np.abs(r - 1)))], dtype=np.int64
    )
    nx = np.zeros((2, k))
    nx[0, :] = -1.0
    nx[1, :] = 1.0
    fscale = 1.0 / jac[fmask, :]
    etoe, etof = connect_1d(etov)
    maps = build_maps_1d(x, fmask, etoe, etof)
    return Discretization1D(
        n=n,
        np_=np_,
        k=k,
        r=r,
        v=v,
        inv_v=np.linalg.inv(v),
        dr=dr,
        lift=lift,
        vx=vx,
        etov=etov,
        x=x,
        rx=rx,
        jac=jac,
        nx=nx,
        fscale=fscale,
        fmask=fmask,
        etoe=etoe,
        etof=etof,
        **maps,
    )
