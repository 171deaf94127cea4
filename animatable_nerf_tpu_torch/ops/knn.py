"""Nearest-vertex kernels: the KNN inverse-distance blend (kernel K2) and
the nearest-vertex distance (kernel K3), plus the per-frame distance
grid that K3 builds.

Replaces the TPU kernels of animatable_nerf_tpu/ops/knn_pallas.py:
`knn_blend_pallas` :55 (body `_knn_select_body` :583-624) and
`min_dist_pallas` :129 (body `_min_dist_kernel` :113); and ports
`build_pdist_payload` :179. `knn_blend` and `min_dist` launch the
hand-written CUDA kernels of csrc/knn.cu for CUDA tensors and take
`knn_blend_plain` / `min_dist_plain` for CPU tensors; there is no
fallback from one to the other. Both are forward-only: their outputs
are data, no gradient crosses them (JAX models/pdf.py:157-159).

The library is built with nvcc into `build/` at the checkout root at
first use (ops/build.py; plain C interface, bound with ctypes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.grid import pack_corner_volume
from .build import build_library

# the Pallas body's knock-out: a selected vertex's d2 + _BIG stays finite
# and above every real distance
_BIG = 3.0e38
PLAIN_CHUNK = 4096  # query rows per (rows, M) distance matrix


def _sq_dists(src, ref):
    """(n, 3), (m, 3) -> (n, m) f32 squared distances by differences,
    summed as (dx*dx + dy*dy) + dz*dz like the Pallas bodies."""
    dx = src[:, 0:1] - ref[None, :, 0]
    dy = src[:, 1:2] - ref[None, :, 1]
    dz = src[:, 2:3] - ref[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def knn_blend_plain(src, ref, values, k: int = 5, eps: float = 1e-8,
                    chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K2 (the Pallas `_knn_select_body`): k
    rounds of (min, lowest index among the minima, knock out with
    +3e38), IDW weights 1/(d + eps), accumulated nearest first.

    src (N, 3), ref (M, 3), values (M, C) -> (vals (N, C), wdist (N, 1)).
    The query axis is cut into `chunk` rows so the (N, M) matrix never
    exists whole."""
    n, m, c = src.shape[0], ref.shape[0], values.shape[1]
    # row m is the zero row the Pallas one-hot gathers when no column
    # is a minimum (a NaN query)
    vals_pad = torch.cat([values, values.new_zeros(1, c)])
    col = torch.arange(m, device=src.device)
    out_vals, out_wd = [], []
    for s in range(0, n, chunk):
        cur = _sq_dists(src[s:s + chunk], ref)
        rows = torch.arange(cur.shape[0], device=src.device)
        acc_vals = src.new_zeros(cur.shape[0], c)
        acc_disp = src.new_zeros(cur.shape[0], 1)
        acc_wd = src.new_zeros(cur.shape[0], 1)
        for _ in range(k):
            dmin = cur.amin(dim=1, keepdim=True)
            idx = torch.where(cur <= dmin, col, m).amin(dim=1)
            d = torch.sqrt(dmin)
            disp = 1.0 / (d + eps)
            acc_vals = acc_vals + disp * vals_pad[idx]
            acc_disp = acc_disp + disp
            acc_wd = acc_wd + disp * d
            hit = idx < m
            cur[rows[hit], idx[hit]] += _BIG
        out_vals.append(acc_vals / acc_disp)
        out_wd.append(acc_wd / acc_disp)
    if not out_vals:
        return src.new_zeros(0, c), src.new_zeros(0, 1)
    return torch.cat(out_vals), torch.cat(out_wd)


def min_dist_plain(src, ref, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K3 (the Pallas `_min_dist_kernel`):
    (N, 3), (M, 3) -> (N,) sqrt of the smallest squared distance."""
    outs = [torch.sqrt(_sq_dists(src[s:s + chunk], ref).amin(dim=1))
            for s in range(0, src.shape[0], chunk)]
    return torch.cat(outs) if outs else src.new_zeros(0)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library("knn")))
    lib.knn_min_dist.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.knn_blend.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.knn_max_k.argtypes = []
    for fn in (lib.knn_min_dist, lib.knn_blend, lib.knn_max_k):
        fn.restype = ctypes.c_int
    return lib


def _check_points(name, src, ref):
    for label, t in (("src", src), ("ref", ref)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: {label} must be an (n, 3) float32 tensor")
    if ref.device != src.device:
        raise ValueError(f"{name}: src and ref must lie on one device")


def _device_tensors(name, *tensors):
    """The CUDA path's checks: contiguous tensors on a CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def knn_blend(src, ref, values, k: int = 5, eps: float = 1e-8):
    """The K2 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).

    src (N, 3) queries, ref (M, 3) vertices, values (M, C) per-vertex
    values, all float32 -> (vals (N, C), wdist (N, 1)): the IDW blend of
    the k nearest vertices' values and distances (JAX
    core/knn.py:37 `sample_blend_closest_points`)."""
    _check_points("knn_blend", src, ref)
    if (values.dtype != torch.float32 or values.dim() != 2
            or values.shape[0] != ref.shape[0] or values.device != src.device):
        raise ValueError("knn_blend: values must be an (M, C) float32 tensor "
                         "on src's device")
    if not 1 <= k <= ref.shape[0]:
        raise ValueError(f"knn_blend: k={k} needs 1 <= k <= M={ref.shape[0]}")
    if src.device.type == "cpu":
        return knn_blend_plain(src, ref, values, k, eps)
    _device_tensors("knn_blend", src, ref, values)
    lib = _library()
    if k > lib.knn_max_k():
        raise ValueError(f"knn_blend: the kernel takes k <= {lib.knn_max_k()}")
    n, m, c = src.shape[0], ref.shape[0], values.shape[1]
    vals = torch.empty(n, c, device=src.device, dtype=torch.float32)
    wdist = torch.empty(n, 1, device=src.device, dtype=torch.float32)
    if n == 0:
        return vals, wdist
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.knn_blend(src.data_ptr(), ref.data_ptr(), values.data_ptr(),
                           n, m, c, k, eps, vals.data_ptr(), wdist.data_ptr(),
                           stream)
    if rc != 0:
        raise RuntimeError(f"knn_blend: kernel launch failed (CUDA error {rc})")
    knn_blend.launches += 1
    return vals, wdist


def min_dist(src, ref):
    """The K3 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).
    src (N, 3), ref (M, 3) float32 -> (N,) nearest-vertex distance."""
    _check_points("min_dist", src, ref)
    if ref.shape[0] < 1:
        raise ValueError("min_dist: needs at least one vertex")
    if src.device.type == "cpu":
        return min_dist_plain(src, ref)
    _device_tensors("min_dist", src, ref)
    lib = _library()
    n, m = src.shape[0], ref.shape[0]
    out = torch.empty(n, device=src.device, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.knn_min_dist(src.data_ptr(), ref.data_ptr(), n, m,
                              out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_dist: kernel launch failed (CUDA error {rc})")
    min_dist.launches += 1
    return out


# launches of the CUDA kernels in this process (the CPU path never counts)
knn_blend.launches = 0
min_dist.launches = 0


def _linspace(start, stop, num: int):
    """jnp.linspace's float32 formula: start*(1 - t) + stop*t with
    t = i/(num-1), the last node exactly `stop`."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=start.device) / div
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def pdist_grid_nodes(vertices, res: int = 96, pad: float = 0.05):
    """The res^3 nodes (x-major, (res^3, 3)) of the distance grid over
    the vertices' box padded by `pad`, and the box (mn, mx)."""
    mn = vertices.amin(dim=0) - pad
    mx = vertices.amax(dim=0) + pad
    axes = [_linspace(mn[a], mx[a], res) for a in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3), mn, mx


def build_pdist_payload(vertices, res: int = 96, pad: float = 0.05):
    """Per-frame conservative nearest-vertex distance grid, corner-packed
    (JAX ops/knn_pallas.py:179 `build_pdist_payload`): K3 at every node
    of a res^3 grid over the vertices' box padded by `pad`.

    Returns (packed (res-1,)^3 x 8 bf16, margin () f32 = half the cell
    diagonal, bounds (2, 3) f32), read by models/common.py
    `grid_pdist_keep`."""
    nodes, mn, mx = pdist_grid_nodes(vertices, res, pad)
    d = min_dist(nodes, vertices.contiguous()).reshape(res, res, res)
    packed = pack_corner_volume(d[..., None]).to(torch.bfloat16)
    cell = (mx - mn) / (res - 1.0)
    margin = 0.5 * torch.linalg.norm(cell)
    return packed, margin, torch.stack([mn, mx])
