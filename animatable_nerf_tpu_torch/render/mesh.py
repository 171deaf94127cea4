"""Mesh extraction: a field swept over a dense point grid in tiles on the
device, and the isosurface on the host.

JAX counterpart: animatable_nerf_tpu/render/mesh.py (`density_grid_sweep`
:21-33, `marching_cubes` :78 through the native extractor,
`largest_component` :168-190, `vertex_normals` :193-206; reference
lib/networks/renderer/aninerf_mesh_renderer.py and sdf_mesh_renderer.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import marching_tets

SWEEP_TILE = 65536


def density_grid_sweep(field_fn, pts, tile: int = SWEEP_TILE):
    """`field_fn((tile, 3)) -> (tile,)` over the flattened grid pts (N,
    3), one call per tile of `tile` points, the last tile zero-padded,
    as JAX's lax.map over its padded tiles: the point filter's argmin
    forcing acts once per call, so the same tiling gives the same masks.
    Returns (N,)."""
    n = pts.shape[0]
    n_pad = -(-n // tile) * tile
    padded = torch.zeros((n_pad, 3), dtype=pts.dtype, device=pts.device)
    padded[:n] = pts
    out = torch.empty(n_pad, dtype=pts.dtype, device=pts.device)
    for s in range(0, n_pad, tile):
        out[s:s + tile] = field_fn(padded[s:s + tile])
    return out[:n]


def marching_cubes(volume: np.ndarray, level: float):
    """The isosurface {volume == level} of a (D, H, W) grid by the host
    extractor (csrc/mesh_native.cpp): (vertices (V, 3) float32 in grid
    units, faces (F, 3) int64)."""
    return marching_tets(volume, level)


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """The largest connected component of a mesh (sdf_mesh_renderer.py
    keeps the biggest piece, :77-80): its vertices, in their order, and
    its faces reindexed."""
    if len(faces) == 0:
        return verts, faces
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    ncomp, labels = csgraph.connected_components(adj, directed=False)
    if ncomp <= 1:
        return verts, faces
    vmask = labels == np.bincount(labels).argmax()
    remap = -np.ones(n, dtype=np.int64)
    remap[vmask] = np.arange(vmask.sum())
    fmask = vmask[faces].all(-1)
    return verts[vmask], remap[faces[fmask]]


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (V, 3) float32 (the mesh
    rasters' shading): each face's edge cross product (twice its area)
    summed into its vertices in float64 by np.add.at, then normalized."""
    vn = np.zeros_like(verts, dtype=np.float64)
    if len(faces) == 0:
        return vn.astype(np.float32)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)
