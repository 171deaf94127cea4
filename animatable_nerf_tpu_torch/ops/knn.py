"""Nearest-vertex kernels: the KNN inverse-distance blend (kernel K2),
the nearest-vertex distance (K3), the k-th-nearest distance (K4), K2's
blend over culled Morton blocks (K5) and over per-cell candidate lists
(K6), plus the per-frame grids and tables they serve.

Replaces the TPU kernels of animatable_nerf_tpu/ops/knn_pallas.py:
`knn_blend_pallas` :55 (body `_knn_select_body` :583-624),
`min_dist_pallas` :129 (body `_min_dist_kernel` :113), `kth_distance`
:240 (body `_kth_dist_kernel` :221), `knn_blend_blocked` :460 (body
`_knn_blocked_kernel` :354) and `knn_blend_celled` :760 (body
`_knn_celled_kernel` :748); and ports `build_pdist_payload` :179,
`build_d5_payload` :278, `build_knn_blocks` :320 and `build_cell_knn`
:627. Each wrapper launches its hand-written CUDA kernel of csrc/knn.cu
for CUDA tensors and takes its `*_plain` version for CPU tensors; there
is no fallback from one to the other. All are forward-only: their
outputs are data, no gradient crosses them (JAX models/pdf.py:157-159);
K2 alone also has a differentiable form (`knn_blend_differentiable`),
for the aligned families' canonical prior, whose backward is plain
PyTorch on the k vertices its launch selected.

The library is built with nvcc into `build/` at the checkout root at
first use (ops/build.py; plain C interface, bound with ctypes). K2, K5
and K3/K4 read vertex layouts (`sweep_layout`, `blocked_layout`,
`grid_layout`) that the wrappers build on a frame's first call and keep
while the vertex tensor's identity and version stay (`per_version`).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ..core.grid import pack_corner_volume
from ..core.numerics import safe_sqrt
from .build import build_library

# the Pallas body's knock-out: a selected vertex's d2 + _BIG stays finite
# and above every real distance
_BIG = 3.0e38
# padded vertices live here: never a neighbour
_FAR_COORD = 1.0e6
PLAIN_CHUNK = 4096  # query rows per (rows, M) distance matrix
# K5's queries per tile, one CUDA block each (kBlockedTile in csrc/knn.cu)
BLOCKED_TILE = 256
# vertices per box inside a K5 block (blocked_layout; kRun in csrc/knn.cu):
# a block is a whole number of runs; also K3's and K4's run (grid_layout)
RUN = 32
CELLED_TILE = 64  # K6's queries per tile: kCellThreads in csrc/knn.cu


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sq_dists(src, ref_t):
    """(n, 3) queries against ref_t (3, m), or (n, 3, m) per query ->
    (n, m) f32 squared distances by differences, summed as
    (dx*dx + dy*dy) + dz*dz like the Pallas bodies."""
    dx = src[:, 0:1] - ref_t[..., 0, :]
    dy = src[:, 1:2] - ref_t[..., 1, :]
    dz = src[:, 2:3] - ref_t[..., 2, :]
    return dx * dx + dy * dy + dz * dz


def _select_blend(cur, values_at, k: int, eps: float):
    """The Pallas `_knn_select_body` on one chunk of squared distances
    cur (n, m), which it overwrites: k rounds of (min, lowest column among
    the minima, knock out with +3e38), IDW weights 1/(d + eps),
    accumulated nearest first. torch.min returns the first of equal
    minima, which is the lowest column. values_at(idx) gives the (n, C)
    value rows of columns idx. A NaN query's row stays NaN, as in the
    Pallas body. Returns (vals (n, C), wdist (n, 1), the selected
    columns (n, k) int64, nearest first)."""
    rows = torch.arange(cur.shape[0], device=cur.device)
    acc_vals = acc_disp = acc_wd = 0.0
    picked = []
    for _ in range(k):
        dmin, idx = torch.min(cur, dim=1, keepdim=True)
        d = torch.sqrt(dmin)
        disp = 1.0 / (d + eps)
        acc_vals = acc_vals + disp * values_at(idx[:, 0])
        acc_disp = acc_disp + disp
        acc_wd = acc_wd + disp * d
        cur[rows, idx[:, 0]] += _BIG
        picked.append(idx)
    return acc_vals / acc_disp, acc_wd / acc_disp, torch.cat(picked, dim=1)


def knn_blend_plain(src, ref, values, k: int = 5, eps: float = 1e-8,
                    chunk: int = PLAIN_CHUNK, indices: bool = False):
    """Plain PyTorch version of K2 (the Pallas `_knn_select_body`).

    src (N, 3), ref (M, 3), values (M, C) -> (vals (N, C), wdist (N, 1)),
    and with `indices` also the k selected vertices (N, k) int32, nearest
    first (ties to the lowest index; -1 for a query with a NaN
    coordinate). The query axis is cut into `chunk` rows so the (N, M)
    matrix never exists whole."""
    c = values.shape[1]
    outs = [_select_blend(_sq_dists(src[s:s + chunk], ref.T),
                          lambda idx: values[idx], k, eps)
            for s in range(0, src.shape[0], chunk)]
    if not outs:
        outs = [(src.new_zeros(0, c), src.new_zeros(0, 1),
                 torch.zeros(0, k, dtype=torch.long, device=src.device))]
    vals = torch.cat([v for v, _, _ in outs])
    wdist = torch.cat([w for _, w, _ in outs])
    if not indices:
        return vals, wdist
    idx = torch.cat([i for _, _, i in outs]).to(torch.int32)
    nan_query = torch.isnan(src).any(dim=1, keepdim=True)
    return vals, wdist, torch.where(nan_query, -1, idx)


def min_dist_plain(src, ref, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K3 (the Pallas `_min_dist_kernel`):
    (N, 3), (M, 3) -> (N,) sqrt of the smallest squared distance."""
    outs = [torch.sqrt(_sq_dists(src[s:s + chunk], ref.T).amin(dim=1))
            for s in range(0, src.shape[0], chunk)]
    return torch.cat(outs) if outs else src.new_zeros(0)


def kth_distance_plain(src, ref, k: int = 5, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K4 (the Pallas `_kth_dist_kernel`):
    (N, 3), (M, 3) -> (N,) sqrt of the k-th smallest squared distance,
    duplicate vertices counted separately."""
    outs = [torch.sqrt(torch.topk(_sq_dists(src[s:s + chunk], ref.T), k,
                                  dim=1, largest=False).values[:, k - 1])
            for s in range(0, src.shape[0], chunk)]
    return torch.cat(outs) if outs else src.new_zeros(0)


def per_version(build):
    """Memoize build(t, *args) on the tensor t's identity, its `_version`
    and args, one entry: a frame's vertex layout is built on the frame's
    first call and reused by the rest, and built anew after an in-place
    change. `.builds` counts the builds."""
    slot = {}

    @functools.wraps(build)
    def cached(t, *args):
        key = slot.get("key")
        if key is None or key[0]() is not t or key[1:] != (t._version, args):
            slot["value"] = build(t, *args)
            slot["key"] = (weakref.ref(t), t._version, args)
            cached.builds += 1
        return slot["value"]

    cached.builds = 0
    return cached


def _rows(points, index):
    """(M, 4) float32 rows: points (M, 3) and index (M,) as int32 bits."""
    rows = points.new_empty(points.shape[0], 4)
    rows[:, :3] = points
    rows.view(torch.int32)[:, 3] = index.to(torch.int32)
    return rows


def sweep_layout(ref):
    """K2's vertex layout: ref (M, 3) sorted along the axis of its box's
    largest extent, as (M, 4) float32 rows (x, y, z, the original index
    as int32 bits), and that axis, a (1,) int32 tensor. Device ops only,
    no host sync."""
    axis = torch.argmax(ref.amax(dim=0) - ref.amin(dim=0)).reshape(1)
    order = torch.argsort(ref.index_select(1, axis)[:, 0], stable=True)
    return _rows(ref[order], order), axis.to(torch.int32)


def _boxes(points, size: int):
    """Boxes of consecutive runs of `size` rows of points (Mp, 3),
    (Mp / size, 8) [lo3, hi3, the longest axis, 0]."""
    runs = points.reshape(-1, size, 3)
    lo, hi = runs.amin(dim=1), runs.amax(dim=1)
    axis = torch.argmax(hi - lo, dim=1, keepdim=True).to(torch.float32)
    return torch.cat([lo, hi, axis, torch.zeros_like(axis)], dim=1)


def blocked_layout(verts_sorted, block: int):
    """K5's vertex layout from `build_knn_blocks`' verts_sorted (Mp, 3):
    the rows as (Mp, 4) float32 (x, y, z, the sorted position as int32
    bits); each block's box, and each RUN rows' box, over all rows, pads
    included, with its longest axis ([lo3, hi3, axis, 0], (Mp / block,
    8) and (Mp / RUN, 8)). Device ops only."""
    position = torch.arange(verts_sorted.shape[0], device=verts_sorted.device)
    return (_rows(verts_sorted, position), _boxes(verts_sorted, block),
            _boxes(verts_sorted, RUN))


def grid_layout(ref):
    """K3's and K4's vertex layout, shared by both: ref (M, 3) in Morton
    order (`_morton_order`), padded to whole runs of RUN rows at +inf, as
    (Mp, 4) float32 rows (x, y, z, 0); and each run's box over its real
    rows, with its longest axis, (Mp / RUN, 8) [lo3, hi3, axis, 0]. A
    pad's squared distance to any finite query is +inf, which never
    enters a value; the last run holds a real row, so every box is
    finite. The wrappers build the same on the card in three launches
    (`_grid_layout_cuda`)."""
    m = ref.shape[0]
    mp = _round_up(m, RUN)
    pts = ref.new_full((mp, 3), float("inf"))
    pts[:m] = ref[_morton_order(ref)]
    real = (torch.arange(mp, device=ref.device) < m)[:, None]
    lo = pts.reshape(-1, RUN, 3).amin(dim=1)
    hi = torch.where(real, pts, float("-inf")).reshape(-1, RUN, 3).amax(dim=1)
    axis = torch.argmax(hi - lo, dim=1, keepdim=True).to(torch.float32)
    rows = torch.cat([pts, pts.new_zeros(mp, 1)], dim=1)
    return rows, torch.cat([lo, hi, axis, torch.zeros_like(axis)], dim=1)


def _grid_layout_cuda(ref):
    """`grid_layout` of a CUDA tensor, bit for bit, in three launches in
    place of the ~70 small ops `grid_layout` issues (a frame builds it
    once, and its cost counts in that frame's grid builds): the Morton
    keys (csrc/knn.cu `grid_keys_kernel`), their stable argsort, and the
    rows and run boxes (`grid_runs_kernel`). No host sync."""
    lib = _library()
    m = ref.shape[0]
    mp = _round_up(m, RUN)
    keys = torch.empty(m, dtype=torch.int32, device=ref.device)
    _launch("grid_layout", ref.device, lib.knn_grid_keys, ref.data_ptr(), m,
            keys.data_ptr())
    order = torch.argsort(keys, stable=True)
    rows = torch.empty(mp, 4, dtype=torch.float32, device=ref.device)
    runs = torch.empty(mp // RUN, 8, dtype=torch.float32, device=ref.device)
    _launch("grid_layout", ref.device, lib.knn_grid_runs, ref.data_ptr(),
            order.data_ptr(), m, rows.data_ptr(), runs.data_ptr())
    return rows, runs


_sweep_layout = per_version(sweep_layout)
_blocked_layout = per_version(blocked_layout)
_grid_layout = per_version(_grid_layout_cuda)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library("knn")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.knn_min_dist.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.knn_kth_dist.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.knn_grid_keys.argtypes = [ptr, i32, ptr, ptr]
    lib.knn_grid_runs.argtypes = [ptr, ptr, i32, ptr, ptr, ptr]
    lib.knn_blend.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32,
                              ptr, ptr, ptr, ptr, ptr]
    lib.knn_blocked.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                i32, i32, i32, f32, ptr, ptr, ptr, ptr]
    lib.knn_celled.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32,
                               ptr, ptr, ptr]
    for fn in (lib.knn_max_k, lib.knn_blocked_tile, lib.knn_blocked_run):
        fn.argtypes = []
    for fn in (lib.knn_min_dist, lib.knn_kth_dist, lib.knn_grid_keys,
               lib.knn_grid_runs, lib.knn_blend, lib.knn_blocked,
               lib.knn_celled, lib.knn_max_k, lib.knn_blocked_tile,
               lib.knn_blocked_run):
        fn.restype = ctypes.c_int
    if (lib.knn_blocked_tile(), lib.knn_blocked_run()) != (BLOCKED_TILE, RUN):
        raise RuntimeError("csrc/knn.cu's K5 tile and run differ from "
                           "BLOCKED_TILE and RUN")
    return lib


def _check_points(name, src, ref):
    for label, t in (("src", src), ("ref", ref)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: {label} must be an (n, 3) float32 tensor")
    if ref.device != src.device:
        raise ValueError(f"{name}: src and ref must lie on one device")


def _check_values(name, values, rows, device):
    if (values.dtype != torch.float32 or values.dim() != 2
            or values.shape[0] != rows or values.device != device):
        raise ValueError(f"{name}: values must be an ({rows}, C) float32 "
                         "tensor on src's device")


def _check_k(name, k, m):
    if not 1 <= k <= m:
        raise ValueError(f"{name}: k={k} needs 1 <= k <= M={m}")


def _device_library(name, k, *tensors):
    """The CUDA path's checks (contiguous tensors on a CUDA device, k
    within the kernels' templates) and the kernel library."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    lib = _library()
    if k > lib.knn_max_k():
        raise ValueError(f"{name}: the kernel takes k <= {lib.knn_max_k()}")
    return lib


def _launch(name, device, fn, *args):
    """Run a library launch function on `device`'s current stream."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


def knn_blend(src, ref, values, k: int = 5, eps: float = 1e-8,
              indices: bool = False):
    """The K2 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).

    src (N, 3) queries, ref (M, 3) vertices, values (M, C) per-vertex
    values, all float32 -> (vals (N, C), wdist (N, 1)): the IDW blend of
    the k nearest vertices' values and distances (JAX
    core/knn.py:37 `sample_blend_closest_points`). With `indices`, also
    the k selected vertices (N, k) int32, nearest first (the kernel's
    optional output; -1 for a NaN query). Data only: for a gradient, see
    `knn_blend_differentiable`."""
    _check_blend(src, ref, values, k)
    if src.device.type == "cpu":
        return knn_blend_plain(src, ref, values, k, eps, indices=indices)
    out = _knn_blend_cuda(src, ref, values, k, eps, indices=indices)
    if src.shape[0]:
        knn_blend.launches += 1
    return out


def _check_blend(src, ref, values, k):
    _check_points("knn_blend", src, ref)
    _check_values("knn_blend", values, ref.shape[0], src.device)
    _check_k("knn_blend", k, ref.shape[0])


def _knn_blend_cuda(src, ref, values, k, eps, counts=None, indices=False):
    """K2's launch on the sorted layout of ref (built once per version of
    ref); `counts` selects the counting build, `indices` the (N, k)
    int32 output of the selected vertices."""
    lib = _device_library("knn_blend", k, src, ref, values)
    n, m, c = src.shape[0], ref.shape[0], values.shape[1]
    vals = torch.empty(n, c, device=src.device, dtype=torch.float32)
    wdist = torch.empty(n, 1, device=src.device, dtype=torch.float32)
    idx = (torch.empty(n, k, device=src.device, dtype=torch.int32)
           if indices else None)
    out = (vals, wdist) + ((idx,) if indices else ())
    if n == 0:
        return out
    rows, axis = _sweep_layout(ref)
    _launch("knn_blend", src.device, lib.knn_blend, src.data_ptr(),
            rows.data_ptr(), axis.data_ptr(), values.data_ptr(), n, m, c, k,
            eps, vals.data_ptr(), wdist.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if counts is None else counts.data_ptr())
    return out


def idw_blend(src, ref, values, idx, eps: float = 1e-8):
    """K2's blend over given neighbours, differentiable: src (N, 3), the
    selected vertices idx (N, k) of ref (M, 3), values (M, C) -> (vals
    (N, C), wdist (N, 1)), as JAX core/knn.py:78-89 forms them from its
    top_k selection: distances by `safe_sqrt` (a zero gradient at
    distance 0, where a query lies on a vertex), weights 1/(d + eps)
    normalized over the k, the blend and the weighted distance. The
    selection is data: no gradient crosses it."""
    idx = idx.long()
    diff = src[:, None, :] - ref[idx]
    d = safe_sqrt((diff * diff).sum(dim=-1))
    disp = 1.0 / (d + eps)
    weights = disp / disp.sum(dim=-1, keepdim=True)
    wdist = (d * weights).sum(dim=-1, keepdim=True)
    return (values[idx] * weights[..., None]).sum(dim=-2), wdist


class KNNBlendFunction(torch.autograd.Function):
    """K2 with a gradient. The forward is `knn_blend` with its selected
    vertices (on the card one launch of the kernel with its index
    output); the backward recomputes `idw_blend` on those k vertices in
    plain PyTorch and takes its vjp, as JAX differentiates its XLA
    `sample_blend_closest_points` (core/knn.py:78-89): the gradient
    reaches the queries (and the vertices and values, where they need
    one) through the distances and the blend, never through the
    selection. No backward kernel: the JAX package has none either."""

    @staticmethod
    def forward(ctx, src, ref, values, k, eps):
        vals, wdist, idx = knn_blend(src, ref, values, k, eps, indices=True)
        ctx.save_for_backward(src, ref, values, idx)
        ctx.eps = eps
        ctx.mark_non_differentiable(idx)
        return vals, wdist, idx

    @staticmethod
    def backward(ctx, g_vals, g_wdist, _):
        src, ref, values, idx = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((src, ref, values), wanted)]
            vals, wdist = idw_blend(*inputs, idx, ctx.eps)
            grads = torch.autograd.grad(
                (vals, wdist), [t for t in inputs if t.requires_grad],
                (g_vals, g_wdist), allow_unused=True)
        it = iter(grads)
        return tuple(next(it) if need else None for need in wanted) + (None,
                                                                       None)


def knn_blend_differentiable(src, ref, values, k: int = 5, eps: float = 1e-8):
    """`knn_blend` with a gradient (`KNNBlendFunction`): (vals, wdist)."""
    _check_blend(src, ref, values, k)
    vals, wdist, _ = KNNBlendFunction.apply(src, ref, values, k, eps)
    return vals, wdist


def knn_blend_counts(src, ref, values, eps: float = 1e-8):
    """K2 at k = 5 in its counting build, for measurement (not counted as
    a launch): a (2,) int64 tensor of the (query, vertex) pairs whose
    reject test ran and of those that went on to the full distance."""
    _check_blend(src, ref, values, 5)
    counts = torch.zeros(2, dtype=torch.int64, device=src.device)
    _knn_blend_cuda(src, ref, values, 5, eps, counts)
    return counts


def min_dist(src, ref):
    """The K3 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).
    src (N, 3), ref (M, 3) float32 -> (N,) nearest-vertex distance."""
    _check_points("min_dist", src, ref)
    _check_k("min_dist", 1, ref.shape[0])
    if src.device.type == "cpu":
        return min_dist_plain(src, ref)
    out = _grid_dist_cuda("min_dist", src, ref, 1)
    if src.shape[0]:
        min_dist.launches += 1
    return out


def kth_distance(src, ref, k: int = 5):
    """The K4 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).
    src (N, 3), ref (M, 3) float32 -> (N,) distance to the k-th nearest
    vertex, duplicates counted separately."""
    _check_points("kth_distance", src, ref)
    _check_k("kth_distance", k, ref.shape[0])
    if src.device.type == "cpu":
        return kth_distance_plain(src, ref, k)
    out = _grid_dist_cuda("kth_distance", src, ref, k)
    if src.shape[0]:
        kth_distance.launches += 1
    return out


def _grid_dist_cuda(name, src, ref, k, counts=None):
    """K3's (k = 1) or K4's launch on the run layout of ref (built once
    per version of ref, shared by both); `counts` selects the counting
    build."""
    lib = _device_library(name, k, src, ref)
    n = src.shape[0]
    out = torch.empty(n, device=src.device, dtype=torch.float32)
    if n == 0:
        return out
    rows, runs = _grid_layout(ref)
    counts_ptr = None if counts is None else counts.data_ptr()
    if k == 1:
        _launch(name, src.device, lib.knn_min_dist, src.data_ptr(),
                rows.data_ptr(), runs.data_ptr(), n, runs.shape[0],
                out.data_ptr(), counts_ptr)
    else:
        _launch(name, src.device, lib.knn_kth_dist, src.data_ptr(),
                rows.data_ptr(), runs.data_ptr(), n, runs.shape[0], k,
                out.data_ptr(), counts_ptr)
    return out


def grid_dist_counts(src, ref, k: int):
    """K3 (k = 1) or K4 at k = 5 in its counting build, for measurement
    (not counted as a launch): a (4,) int64 tensor of the (warp, run)
    pairs the warps ranked and tested before they stopped, those they
    swept, the (query, vertex) pairs whose one-axis reject ran and those
    that went on to the full distance."""
    if k not in (1, 5):
        raise ValueError(f"grid_dist_counts: the counting builds take k = 1 "
                         f"or 5, not {k}")
    _check_points("grid_dist_counts", src, ref)
    _check_k("grid_dist_counts", k, ref.shape[0])
    counts = torch.zeros(4, dtype=torch.int64, device=src.device)
    _grid_dist_cuda("grid_dist_counts", src, ref, k, counts)
    return counts


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


def build_d5_payload(vertices, res: int = 64, pad: float = 0.05, k: int = 5):
    """Per-frame grid of k-th-nearest-vertex distances, corner-packed
    (JAX ops/knn_pallas.py:278 `build_d5_payload`): K4 at every node of
    the grid `build_pdist_payload` uses for the same res and pad.
    d_k(., V) is 1-Lipschitz, so models/common.py `grid_d5_upper` reads
    a certified upper bound from it, which drives K5's cull.

    Returns (packed (res-1,)^3 x 8 bf16, bounds (2, 3) f32)."""
    nodes, mn, mx = pdist_grid_nodes(vertices, res, pad)
    d = kth_distance(nodes, vertices.contiguous(), k).reshape(res, res, res)
    packed = pack_corner_volume(d[..., None]).to(torch.bfloat16)
    return packed, torch.stack([mn, mx])


def morton_key(q):
    """Interleave integer coordinates q (n, 3) of up to 10 bits into
    Morton keys (n,) (JAX ops/knn_pallas.py:305 `_morton_key`). Computed
    in int64: every key fits in 30 bits, as in JAX's uint32."""
    def spread(x):
        x = x.to(torch.int64)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _morton_order(points, bits: int = 8):
    """The stable sort of points (n, 3) by the Morton key of their
    `bits`-bit coordinates over their own box (JAX :333-335, :488-493)."""
    mn = points.amin(dim=0)
    scale = (2.0 ** bits - 1.0) / torch.clamp(points.amax(dim=0) - mn, min=1e-9)
    q = torch.clamp((points - mn) * scale, 0, 2 ** bits - 1).to(torch.int32)
    return torch.argsort(morton_key(q), stable=True)


def build_knn_blocks(vertices, values, block: int = 128, bits: int = 8):
    """Morton-sorted vertices in blocks of `block`, with each block's box,
    for K5's cull (JAX ops/knn_pallas.py:320 `build_knn_blocks`).

    Returns (verts_sorted (Mp, 3) padded at 1e6, values_sorted (Mp, C)
    zero-padded, bboxes (Mp / block, 8) f32 [lo3, hi3, 0, 0]). A box
    covers its block's real vertices only; a block of pads alone gets
    lo = +inf, hi = -inf, which K5 culls always."""
    m = vertices.shape[0]
    order = _morton_order(vertices, bits)
    mp = _round_up(m, block)
    vs = vertices.new_full((mp, 3), _FAR_COORD)
    vs[:m] = vertices[order]
    ws = values.new_zeros(mp, values.shape[1])
    ws[:m] = values[order]
    valid = (torch.arange(mp, device=vertices.device) < m)[:, None]
    lo = torch.where(valid, vs, float("inf")).reshape(-1, block, 3).amin(dim=1)
    hi = torch.where(valid, vs, float("-inf")).reshape(-1, block, 3).amax(dim=1)
    return vs, ws, torch.cat([lo, hi, lo.new_zeros(lo.shape[0], 2)], dim=-1)


def blocked_tiles(src, d5ub, bboxes):
    """K5's tiling, shared by the kernel and its plain version (JAX
    :483-516): the queries in Morton order, zero-padded to whole tiles
    of BLOCKED_TILE;
    each tile's box and radius (the max of its queries' d5ub); and the
    vertex blocks' boxes with non-finite entries moved to 1e6.

    Returns (order (N,), src_p (Np, 3), meta (Np / BLOCKED_TILE, 8) [lo3,
    hi3, radius, 0], bb (B, 8))."""
    n, tile = src.shape[0], BLOCKED_TILE
    order = _morton_order(src)
    n_pad = _round_up(max(n, 1), tile)
    src_p = src.new_zeros(n_pad, 3)
    src_p[:n] = src[order]
    d5_p = d5ub.new_zeros(n_pad)
    d5_p[:n] = d5ub[order]
    st = src_p.reshape(-1, tile, 3)
    meta = torch.cat([st.amin(dim=1), st.amax(dim=1),
                      d5_p.reshape(-1, tile).amax(dim=1, keepdim=True),
                      src.new_zeros(st.shape[0], 1)], dim=-1)
    bb = torch.where(torch.isfinite(bboxes), bboxes, _FAR_COORD)
    return order, src_p, meta, bb


def blocked_cull(meta, bb):
    """(n_tiles, B) bool: the vertex blocks each tile sweeps, those whose
    box lies within the tile radius of the tile's box (JAX :386-396)."""
    g = torch.clamp(torch.maximum(bb[None, :, 0:3] - meta[:, None, 3:6],
                                  meta[:, None, 0:3] - bb[None, :, 3:6]),
                    min=0.0)
    d2b = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    return d2b <= meta[:, 6:7] * meta[:, 6:7]


def _check_blocked(src, d5ub, verts_sorted, values_sorted, bboxes, k):
    """K5's input checks; returns the vertices per block, verts_sorted's
    rows over bboxes' rows, a whole number of RUN."""
    _check_points("knn_blend_blocked", src, verts_sorted)
    _check_values("knn_blend_blocked", values_sorted, verts_sorted.shape[0],
                  src.device)
    _check_k("knn_blend_blocked", k, verts_sorted.shape[0])
    if (d5ub.shape != (src.shape[0],) or bboxes.dim() != 2
            or bboxes.shape[0] == 0 or bboxes.shape[1] != 8
            or d5ub.dtype != torch.float32 or bboxes.dtype != torch.float32
            or d5ub.device != src.device or bboxes.device != src.device):
        raise ValueError("knn_blend_blocked: d5ub must be (N,) and bboxes "
                         "(B, 8), float32 on src's device")
    block = verts_sorted.shape[0] // bboxes.shape[0]
    if verts_sorted.shape[0] != block * bboxes.shape[0]:
        raise ValueError("knn_blend_blocked: the vertex rows must be whole "
                         "blocks, one per bboxes row")
    if block % RUN:
        raise ValueError(f"knn_blend_blocked: a block of {block} vertices is "
                         f"not a whole number of runs of {RUN}")
    return block


def _unsort(order, *sorted_outs):
    """Rows of the sorted outputs back to input order."""
    n = order.shape[0]
    return tuple(torch.empty_like(t[:n]).index_copy_(0, order, t[:n])
                 for t in sorted_outs)


def knn_blend_blocked_plain(src, d5ub, verts_sorted, values_sorted, bboxes,
                            k: int = 5, eps: float = 1e-8,
                            chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K5 (the Pallas `_knn_blocked_kernel`):
    the same tiling and cull, the columns of each tile's culled blocks
    set to +inf, then K2's k rounds on the sorted vertices, whose
    positions break ties. Exact (equal to K2 up to ties between equal
    distances) wherever d5ub >= the true k-th distance."""
    block = _check_blocked(src, d5ub, verts_sorted, values_sorted, bboxes, k)
    c, tile = values_sorted.shape[1], BLOCKED_TILE
    if src.shape[0] == 0:
        return src.new_zeros(0, c), src.new_zeros(0, 1)
    order, src_p, meta, bb = blocked_tiles(src, d5ub, bboxes)
    keep = blocked_cull(meta, bb)
    chunk = max(tile, chunk // tile * tile)
    outs = []
    for s in range(0, src_p.shape[0], chunk):
        cur = _sq_dists(src_p[s:s + chunk], verts_sorted.T)
        cols = keep[s // tile:(s + cur.shape[0]) // tile].repeat_interleave(
            tile, dim=0).repeat_interleave(block, dim=1)
        cur.masked_fill_(~cols, float("inf"))
        outs.append(_select_blend(cur, lambda idx: values_sorted[idx], k, eps))
    return _unsort(order, torch.cat([v for v, _, _ in outs]),
                   torch.cat([w for _, w, _ in outs]))


def knn_blend_blocked(src, d5ub, verts_sorted, values_sorted, bboxes,
                      k: int = 5, eps: float = 1e-8):
    """The K5 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise). Host-free on
    the card: the sort, tiling and un-sort are device ops.

    src (N, 3) queries, d5ub (N,) upper bounds of each query's k-th
    nearest distance (models/common.py `grid_d5_upper`), and
    `build_knn_blocks`' verts_sorted (Mp, 3), values_sorted (Mp, C),
    bboxes (B, 8) -> (vals (N, C), wdist (N, 1)): K2's blend, with ties
    broken by Morton position (JAX ops/knn_pallas.py:460). A block is
    Mp / B vertices (128 from `build_knn_blocks`)."""
    if src.device.type == "cpu":
        return knn_blend_blocked_plain(src, d5ub, verts_sorted, values_sorted,
                                       bboxes, k, eps)
    if src.shape[0] == 0:
        _check_blocked(src, d5ub, verts_sorted, values_sorted, bboxes, k)
        c = values_sorted.shape[1]
        return src.new_empty(0, c), src.new_empty(0, 1)
    out = _knn_blocked_cuda(src, d5ub, verts_sorted, values_sorted, bboxes,
                            k, eps)
    knn_blend_blocked.launches += 1
    return out


def _knn_blocked_cuda(src, d5ub, verts_sorted, values_sorted, bboxes, k, eps,
                      counts=None):
    """K5's launch on the float4 layout of verts_sorted (built once per
    version); `counts` selects the counting build. N > 0."""
    block = _check_blocked(src, d5ub, verts_sorted, values_sorted, bboxes, k)
    lib = _device_library("knn_blend_blocked", k, src, verts_sorted,
                          values_sorted)
    if block > 1024:
        raise ValueError("knn_blend_blocked: the kernel takes blocks of at "
                         f"most 1024 vertices, not {block}")
    c = values_sorted.shape[1]
    order, src_p, meta, bb = blocked_tiles(src, d5ub, bboxes)
    rows, boxes, subs = _blocked_layout(verts_sorted, block)
    vals = torch.empty(src_p.shape[0], c, device=src.device, dtype=torch.float32)
    wdist = torch.empty(src_p.shape[0], 1, device=src.device,
                        dtype=torch.float32)
    _launch("knn_blend_blocked", src.device, lib.knn_blocked,
            src_p.data_ptr(), meta.data_ptr(), bb.data_ptr(), rows.data_ptr(),
            boxes.data_ptr(), subs.data_ptr(), values_sorted.data_ptr(),
            meta.shape[0], bb.shape[0], block, c, k, eps, vals.data_ptr(),
            wdist.data_ptr(),
            None if counts is None else counts.data_ptr())
    return _unsort(order, vals, wdist)


def knn_blend_blocked_counts(src, d5ub, verts_sorted, values_sorted, bboxes,
                             eps: float = 1e-8):
    """K5 at k = 5 in its counting build, for measurement (not counted as
    a launch): a (2,) int64 tensor of the (query, vertex) pairs whose
    one-axis reject ran and of those that went on to the full distance
    (the pairs of blocks the tile culled, or a warp skipped by its box
    test, are in neither)."""
    counts = torch.zeros(2, dtype=torch.int64, device=src.device)
    _knn_blocked_cuda(src, d5ub, verts_sorted, values_sorted, bboxes, 5, eps,
                      counts)
    return counts


def build_cell_knn(vertices, values, res=(12, 12, 12), cap: int = 2048,
                   slot_cap: int = 512, k: int = 5, th: float = 0.1,
                   pad: float = None):
    """Per-cell candidate lists for K6 (JAX ops/knn_pallas.py:627
    `build_cell_knn`), with K3 and K4 at the cell centres.

    A res grid of cells over the vertices' box padded by `pad`. The first
    `slot_cap` cells that can hold a point within `th` of a vertex
    (d1(centre) < th + half diagonal + 1e-4) get a slot whose list holds,
    in ascending vertex order, every vertex within d5(centre) + half
    diagonal + 1e-4 of the cell box: the k nearest of every point of the
    cell (d5 is 1-Lipschitz). Lists hold `cap` entries, pads at 1e6 with
    zero values. Every other cell maps to the fallback slot S, vertex 0
    alone.

    Returns ({cknn_verts (S+1, 3, cap), cknn_vals (S+1, cap, C),
    cknn_lut res int32 (cell -> slot), cknn_bounds (2, 3)}, overflow):
    overflow (a bool tensor) is true when more than `slot_cap` cells
    qualify or a list exceeds `cap`; the lists are then incomplete."""
    rx, ry, rz = res
    if rx * ry * rz < slot_cap:
        raise ValueError(f"build_cell_knn: {rx * ry * rz} cells is fewer "
                         f"than slot_cap={slot_cap}")
    if pad is None:
        pad = th + 1e-3
    if pad < th:
        # queries outside the grid clamp to a border cell, which is exact
        # only if the border shell reaches past th
        raise ValueError(f"build_cell_knn requires pad >= th ({pad} < {th})")
    dev = vertices.device
    verts = vertices.contiguous()
    m = verts.shape[0]
    mn = verts.amin(dim=0) - pad
    mx = verts.amax(dim=0) + pad
    cell = (mx - mn) / torch.tensor([rx, ry, rz], dtype=torch.float32,
                                    device=dev)
    hd = 0.5 * torch.linalg.norm(cell)
    axes = [mn[a] + (torch.arange(r, dtype=torch.float32, device=dev) + 0.5)
            * cell[a] for a, r in enumerate(res)]
    centers = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                          dim=-1).reshape(-1, 3)

    d1c = min_dist(centers, verts)
    d5c = kth_distance(centers, verts, k)
    possible = d1c < th + hd + 1e-4
    n_possible = possible.sum()
    rank = torch.cumsum(possible.to(torch.int32), 0) - 1
    lut = torch.where(possible & (rank < slot_cap), rank, slot_cap)

    # slot -> cell (the stable possible-first order matches `rank`)
    slot_cell = torch.argsort((~possible).to(torch.int32), stable=True)[:slot_cap]
    slot_real = torch.arange(slot_cap, device=dev) < n_possible
    lo = centers[slot_cell] - 0.5 * cell
    hi = lo + cell
    r_s = torch.where(slot_real, d5c[slot_cell] + hd + 1e-4, -1.0)

    # vertex-to-box squared distance per (slot, vertex)
    g = torch.clamp(torch.maximum(lo[:, None] - verts[None],
                                  verts[None] - hi[:, None]), min=0.0)
    d2box = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    keep = (d2box <= (r_s * r_s)[:, None]) & slot_real[:, None]
    counts = keep.sum(dim=-1)
    overflow = (n_possible > slot_cap) | torch.any(
        torch.where(slot_real, counts, 0) > cap)

    # order-preserving compaction of each slot's list to `cap` entries
    idx = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)[:, :cap]
    if idx.shape[1] < cap:  # fewer vertices than entries: pads only
        idx = torch.cat([idx, idx.new_zeros(slot_cap, cap - m)], dim=1)
    valid = (torch.arange(cap, device=dev)[None, :]
             < torch.clamp(counts, max=cap)[:, None])[..., None]
    cverts = torch.where(valid, verts[idx], _FAR_COORD)
    cvals = torch.where(valid, values[idx], 0.0)

    # the fallback slot S: vertex 0 alone
    fb_v = verts.new_full((1, cap, 3), _FAR_COORD)
    fb_v[0, 0] = verts[0]
    fb_w = values.new_zeros(1, cap, values.shape[1])
    fb_w[0, 0] = values[0]
    payload = {
        "cknn_verts": torch.cat([cverts, fb_v]).transpose(1, 2).contiguous(),
        "cknn_vals": torch.cat([cvals, fb_w]),
        "cknn_lut": lut.to(torch.int32).reshape(rx, ry, rz),
        "cknn_bounds": torch.stack([mn, mx]),
    }
    return payload, overflow


def cell_slots(src, cknn_lut, cknn_bounds):
    """(N,) int64: each query's slot, from the cell it falls in, border
    cells for queries outside the grid (JAX :806-818)."""
    rx, ry, rz = cknn_lut.shape
    mn, mx = cknn_bounds[0], cknn_bounds[1]
    cell = (mx - mn) / torch.tensor([rx, ry, rz], dtype=torch.float32,
                                    device=src.device)
    top = torch.tensor([rx - 1, ry - 1, rz - 1], device=src.device)
    ijk = torch.minimum(torch.clamp(torch.floor((src - mn) / cell).to(torch.int64),
                                    min=0), top)
    return cknn_lut.reshape(-1)[(ijk[:, 0] * ry + ijk[:, 1]) * rz
                                + ijk[:, 2]].to(torch.int64)


def _check_celled(src, cknn_verts, cknn_vals, cknn_lut, cknn_bounds, k):
    name = "knn_blend_celled"
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != 3:
        raise ValueError(f"{name}: src must be an (n, 3) float32 tensor")
    if (cknn_verts.dim() != 3 or cknn_verts.shape[1] != 3
            or cknn_vals.dim() != 3
            or cknn_vals.shape[:2] != (cknn_verts.shape[0], cknn_verts.shape[2])
            or cknn_verts.dtype != torch.float32
            or cknn_vals.dtype != torch.float32):
        raise ValueError(f"{name}: lists must be (S+1, 3, cap) and "
                         "(S+1, cap, C) float32 tensors")
    if (cknn_lut.dim() != 3 or cknn_lut.dtype != torch.int32
            or cknn_bounds.shape != (2, 3)):
        raise ValueError(f"{name}: the lut must be a 3-d int32 grid and the "
                         "bounds (2, 3)")
    if any(t.device != src.device
           for t in (cknn_verts, cknn_vals, cknn_lut, cknn_bounds)):
        raise ValueError(f"{name}: every tensor must lie on src's device")
    _check_k(name, k, cknn_verts.shape[2])


def knn_blend_celled_plain(src, cknn_verts, cknn_vals, cknn_lut, cknn_bounds,
                           k: int = 5, eps: float = 1e-8, chunk: int = 1024):
    """Plain PyTorch version of K6 (the Pallas `_knn_celled_kernel`): K2's
    k rounds over every entry of each query's slot list, whose positions
    break ties."""
    _check_celled(src, cknn_verts, cknn_vals, cknn_lut, cknn_bounds, k)
    c = cknn_vals.shape[2]
    slot = cell_slots(src, cknn_lut, cknn_bounds)
    outs = []
    for s in range(0, src.shape[0], chunk):
        sl = slot[s:s + chunk]
        outs.append(_select_blend(_sq_dists(src[s:s + chunk], cknn_verts[sl]),
                                  lambda idx, sl=sl: cknn_vals[sl, idx], k, eps))
    if not outs:
        return src.new_zeros(0, c), src.new_zeros(0, 1)
    return (torch.cat([v for v, _, _ in outs]),
            torch.cat([w for _, w, _ in outs]))


def celled_tiles(slot, n_slots: int):
    """K6's routing (JAX :820-851, without its padded copies): each slot's
    run of queries, in slot-sorted order, cut into tiles of at most
    CELLED_TILE. Returns (n_tiles, 3) int32 [slot, first sorted row, rows],
    sized for the worst case without a host sync; the tiles past the last
    run have 0 rows."""
    tile = CELLED_TILE
    count = torch.bincount(slot, minlength=n_slots)
    start = torch.cumsum(count, 0) - count
    n_tiles = -(-count // tile)
    tile_end = torch.cumsum(n_tiles, 0)
    t = torch.arange(slot.shape[0] // tile + n_slots + 1, device=slot.device)
    s = torch.clamp(torch.searchsorted(tile_end, t, right=True), max=n_slots - 1)
    r0 = (t - (tile_end[s] - n_tiles[s])) * tile
    rows = torch.where(t < tile_end[-1],
                       torch.clamp(count[s] - r0, min=0, max=tile), 0)
    return torch.stack([s, start[s] + r0, rows], dim=1).to(torch.int32)


def knn_blend_celled(src, cknn_verts, cknn_vals, cknn_lut, cknn_bounds,
                     k: int = 5, eps: float = 1e-8):
    """The K6 contract on `src`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise).

    src (N, 3) queries and `build_cell_knn`'s lists -> (vals (N, C),
    wdist (N, 1)): K2's blend over each query's cell list (JAX
    ops/knn_pallas.py:760). Equal to K2 to the bit for every query whose
    list is complete, which `build_cell_knn` certifies for every query
    that can pass the 0.1 filter; elsewhere wdist >= K2's and the blend
    is a convex combination. The queries are sorted by slot so each CUDA
    block of CELLED_TILE threads serves one slot."""
    if src.device.type == "cpu":
        return knn_blend_celled_plain(src, cknn_verts, cknn_vals, cknn_lut,
                                      cknn_bounds, k, eps)
    _check_celled(src, cknn_verts, cknn_vals, cknn_lut, cknn_bounds, k)
    lib = _device_library("knn_blend_celled", k, src, cknn_verts, cknn_vals)
    n, c = src.shape[0], cknn_vals.shape[2]
    if n == 0:
        return src.new_empty(0, c), src.new_empty(0, 1)
    slot = cell_slots(src, cknn_lut, cknn_bounds)
    order = torch.argsort(slot, stable=True)
    tiles = celled_tiles(slot, cknn_verts.shape[0])
    src_s = src[order].contiguous()
    vals = torch.empty(n, c, device=src.device, dtype=torch.float32)
    wdist = torch.empty(n, 1, device=src.device, dtype=torch.float32)
    _launch("knn_blend_celled", src.device, lib.knn_celled, src_s.data_ptr(),
            tiles.data_ptr(), cknn_verts.data_ptr(), cknn_vals.data_ptr(),
            tiles.shape[0], cknn_verts.shape[2], c, k, eps,
            vals.data_ptr(), wdist.data_ptr())
    knn_blend_celled.launches += 1
    return _unsort(order, vals, wdist)


# launches of the CUDA kernels in this process (the CPU path never counts)
knn_blend.launches = 0
min_dist.launches = 0
kth_distance.launches = 0
knn_blend_blocked.launches = 0
knn_blend_celled.launches = 0
