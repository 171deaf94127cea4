"""Kernels K2 and K3 (ops/knn.py) and the distance grid they serve,
against the JAX package on the CPU: the plain versions against the
Pallas kernels run in interpret mode, the port's grid build and pass-1
keep against JAX's, and the K2 contract against the JAX matmul-form
`sample_blend_closest_points`.

Tolerances:
  * plain versions against the Pallas bodies: rtol = atol = 1e-6, the
    same float32 operations in the same order (XLA may still fuse);
  * against the matmul form |s|^2 - 2 s.r + |r|^2: rtol = atol = 1e-5,
    its cancellation moves d by ~1e-7 (no near ties in these inputs);
  * the bf16 grid: one bf16 ulp (2^-8 relative), since a torch node may
    differ from jnp.linspace's by a float32 ulp before rounding;
  * the CPU rehearsals of K2's and K5's loops (emulations of the kernels'
    sweeps in float32): bit-equal to the plain versions, which form the
    same distances by the same rounded operations and select by the same
    order; against the Pallas K2 in interpret mode the same neighbours
    bit for bit (a blend of one-hot rows shows which were chosen) and
    the blend within rtol = atol = 1e-6, as above (XLA's division and
    products round in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from knn_cases import BLOCKED_CASES, KINDS, blocked_inputs, knn_inputs

from animatable_nerf_tpu.core.grid import (
    grid_corner_distance_bound as j_bound,
    pack_corner_volume as j_pack,
)
from animatable_nerf_tpu.core.knn import (
    sample_blend_closest_points as j_sample_blend,
)
from animatable_nerf_tpu.models.common import grid_pdist_keep as j_keep
from animatable_nerf_tpu.ops.knn_pallas import (
    build_pdist_payload as j_build_pdist,
    knn_blend_pallas,
    min_dist_pallas,
)

from animatable_nerf_tpu_torch.core.grid import (
    grid_corner_distance_bound,
    pack_corner_volume,
)
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.models.common import grid_pdist_keep
from animatable_nerf_tpu_torch.ops import knn

PALLAS_TOL = dict(rtol=1e-6, atol=1e-6)
MATMUL_TOL = dict(rtol=1e-5, atol=1e-5)


def cloud(n, m, c, seed, dup=0):
    """Seeded queries around a seeded vertex cloud; the last `dup`
    vertices are exact copies of vertex 0, and the first queries sit
    exactly on vertex 0, so the lowest-index tie-break decides them."""
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    if dup:
        ref[-dup:] = ref[0]
    src = (ref[rng.randint(0, m, n)]
           + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    if dup:
        src[:4] = ref[0]
    vals = rng.uniform(0, 1, (m, c)).astype(np.float32)
    return src, ref, vals


@pytest.mark.parametrize("n,m,c,dup", [(200, 97, 24, 0), (64, 300, 24, 3),
                                       (31, 5, 4, 2)])
def test_knn_blend_plain_matches_pallas(n, m, c, dup):
    src, ref, vals = cloud(n, m, c, 1, dup)
    j_vals, j_wd = knn_blend_pallas(jnp.asarray(src), jnp.asarray(ref),
                                    jnp.asarray(vals), interpret=True)
    t_vals, t_wd = knn.knn_blend_plain(torch.tensor(src), torch.tensor(ref),
                                       torch.tensor(vals), chunk=64)
    np.testing.assert_allclose(t_vals.numpy(), np.asarray(j_vals), **PALLAS_TOL)
    np.testing.assert_allclose(t_wd.numpy(), np.asarray(j_wd), **PALLAS_TOL)
    if dup:
        # a query on vertex 0 and its copies: IDW weight 1e8 each, the
        # blend is the lowest-index copies' mean
        copies = [0] + list(range(m - dup, m))[:4]
        np.testing.assert_allclose(t_vals[0].numpy(), vals[copies].mean(0),
                                   rtol=1e-5)


def test_min_dist_plain_matches_pallas():
    src, ref, _ = cloud(300, 97, 1, 2)
    ref_d = min_dist_pallas(jnp.asarray(src), jnp.asarray(ref), interpret=True)
    got = knn.min_dist_plain(torch.tensor(src), torch.tensor(ref), chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_d), **PALLAS_TOL)


def test_sample_blend_matches_jax_contract():
    """The K2 contract against the JAX package's own (matmul-form) XLA
    implementation, which is what JAX runs off the TPU."""
    src, ref, vals = cloud(500, 700, 24, 3)
    j_vals, j_wd = j_sample_blend(jnp.asarray(src), jnp.asarray(ref),
                                  jnp.asarray(vals))
    t_vals, t_wd = sample_blend_closest_points(
        torch.tensor(src), torch.tensor(ref), torch.tensor(vals))
    np.testing.assert_allclose(t_vals.numpy(), np.asarray(j_vals), **MATMUL_TOL)
    np.testing.assert_allclose(t_wd.numpy(), np.asarray(j_wd), **MATMUL_TOL)


def test_wrappers_take_the_plain_version_on_the_cpu():
    src, ref, vals = (torch.tensor(a) for a in cloud(40, 30, 24, 4))
    before = (knn.knn_blend.launches, knn.min_dist.launches)
    v, d = knn.knn_blend(src, ref, vals)
    pv, pd = knn.knn_blend_plain(src, ref, vals)
    assert torch.equal(v, pv) and torch.equal(d, pd)
    assert torch.equal(knn.min_dist(src, ref), knn.min_dist_plain(src, ref))
    assert (knn.knn_blend.launches, knn.min_dist.launches) == before
    empty = src[:0]
    assert knn.knn_blend(empty, ref, vals)[0].shape == (0, 24)
    assert knn.min_dist(empty, ref).shape == (0,)
    with pytest.raises(ValueError, match="k=5"):
        knn.knn_blend(src, ref[:4], vals[:4])
    with pytest.raises(ValueError):
        knn.knn_blend(src.double(), ref, vals)
    with pytest.raises(ValueError):
        knn.min_dist(src[:, :2], ref)


def test_corner_pack_and_bound_match_jax():
    rng = np.random.RandomState(5)
    vol = rng.uniform(0, 1, (6, 7, 5, 1)).astype(np.float32)
    got = pack_corner_volume(torch.tensor(vol))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pack(jnp.asarray(vol))))
    pts01 = rng.uniform(-0.2, 1.2, (400, 3)).astype(np.float32)
    cell = np.array([0.1, 0.07, 0.12], np.float32)
    ref = j_bound(j_pack(jnp.asarray(vol)), jnp.asarray(pts01), jnp.asarray(cell))
    lb = grid_corner_distance_bound(got, torch.tensor(pts01), torch.tensor(cell))
    np.testing.assert_allclose(lb.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _verts(seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(120, 3) * 0.3).astype(np.float32)


def test_pdist_payload_matches_jax():
    verts = _verts()
    j_packed, j_margin, j_bounds = j_build_pdist(jnp.asarray(verts), res=16)
    packed, margin, bounds = knn.build_pdist_payload(torch.tensor(verts), res=16)
    assert packed.dtype == torch.bfloat16 and packed.shape == (15, 15, 15, 8)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(j_bounds))
    np.testing.assert_allclose(float(margin), float(j_margin), rtol=1e-6)
    got = packed.float().numpy()
    ref = np.asarray(j_packed.astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)


def test_grid_pdist_keep_matches_jax_and_is_conservative():
    verts = _verts()
    j_packed, j_margin, j_bounds = j_build_pdist(jnp.asarray(verts), res=16)
    rng = np.random.RandomState(12)
    lo, hi = np.asarray(j_bounds)
    pts = rng.uniform(lo - 0.3, hi + 0.3, (4000, 3)).astype(np.float32)
    j_frame = {"pdist_packed": j_packed, "pdist_bounds": j_bounds}
    ref = np.asarray(j_keep(jnp.asarray(pts), j_frame, 0.1))
    # the same (JAX-built) grid through the port's reader
    t_frame = {
        "pdist_packed": torch.tensor(np.asarray(j_packed.astype(jnp.float32))
                                     ).to(torch.bfloat16),
        "pdist_bounds": torch.tensor(np.asarray(j_bounds)),
    }
    got = grid_pdist_keep(torch.tensor(pts), t_frame, 0.1).numpy()
    np.testing.assert_array_equal(got, ref)
    # the port's own grid keeps every point within 0.1 of a vertex
    packed, _, bounds = knn.build_pdist_payload(torch.tensor(verts), res=16)
    own = grid_pdist_keep(torch.tensor(pts),
                          {"pdist_packed": packed, "pdist_bounds": bounds}, 0.1)
    exact = knn.min_dist_plain(torch.tensor(pts), torch.tensor(verts)) < 0.1
    assert bool(exact.any()) and not bool((exact & ~own).any())
    assert own.sum() < len(pts)


# ---- CPU rehearsals of K2's and K5's sweeps (csrc/knn.cu)

INT_MAX = 2 ** 31 - 1
WALK_ROWS = 2  # kWalkRows in csrc/knn.cu


def squares(q, p):
    """The kernels' three squares (dx*dx, dy*dy, dz*dz), rows of q
    against rows of p, each operation rounded on its own."""
    d = q - p
    return d[..., 0] * d[..., 0], d[..., 1] * d[..., 1], d[..., 2] * d[..., 2]


def sq_dist(q, p):
    xx, yy, zz = squares(q, p)
    return (xx + yy) + zz


def sorted_rows(ref, axis):
    """`knn.sweep_layout`'s rows with the axis given, not chosen."""
    order = torch.argsort(ref[:, axis], stable=True)
    return knn._rows(ref[order], order)


def topk_offer(bd, bi, d2, idx, offer, lex):
    """The kernels' insert (`topk_insert`, or `topk_insert_lex` when lex)
    for every query at once: the k best (bd, bi) sorted ascending take
    (d2, idx) where `offer` and it precedes the k-th; an entry stays in
    front of it unless the entry comes after it: a larger d2, or with lex
    an equal d2 and a larger index."""
    after = bd > d2[:, None]
    if lex:
        after |= (bd == d2[:, None]) & (bi > idx[:, None])
    enter = (offer & after[:, -1])[:, None]
    k = bd.shape[1]
    pos = (k - after.sum(1))[:, None]
    slot = torch.arange(k)[None]
    new_d = torch.where(slot < pos, bd, torch.where(
        slot == pos, d2[:, None], torch.cat([bd[:, :1], bd[:, :-1]], 1)))
    new_i = torch.where(slot < pos, bi, torch.where(
        slot == pos, idx[:, None], torch.cat([bi[:, :1], bi[:, :-1]], 1)))
    return torch.where(enter, new_d, bd), torch.where(enter, new_i, bi)


def blend(bd, bi, values, eps, nan_rows):
    """`blend_write`: the IDW blend of the k best, nearest first; NaN
    rows for NaN queries."""
    acc_vals = acc_disp = acc_wd = 0.0
    for s in range(bd.shape[1]):
        d = torch.sqrt(bd[:, s:s + 1])
        disp = 1.0 / (d + eps)
        acc_vals = acc_vals + disp * values[bi[:, s].clamp(max=len(values) - 1)]
        acc_disp = acc_disp + disp
        acc_wd = acc_wd + disp * d
    vals, wd = acc_vals / acc_disp, acc_wd / acc_disp
    vals[nan_rows] = float("nan")
    wd[nan_rows] = float("nan")
    return vals, wd


def box_gap2(points, boxes):
    """`box_gap2`: the largest square gap on an axis from points to boxes
    [lo3, hi3, ...]."""
    lo, hi = boxes[..., 0:3], boxes[..., 3:6]
    gap = torch.where(points < lo, points - lo,
                      torch.where(points > hi, points - hi, 0.0))
    return (gap * gap).amax(-1)


def sweep_runs(src, bd, bi, rows, runs, first, count, sub, idle):
    """`sweep_runs` for every query at once: each query's rows [first,
    first + count) (rows (x, y, z, index bits)) in runs of `sub` with
    their boxes in `runs`; a run behind the gap test, then per row the
    reject on the run's longest axis and the lexicographic insert. Lanes
    where `idle` take no part (a warp whose lanes are all idle skips the
    run: no pair runs). Returns (bd, bi, pairs tested, full distances)."""
    index = rows.view(torch.int32)[:, 3].long()
    tested = full = 0
    for t in range(0, int(count.max()), sub):
        at = first + t
        box = runs[(at // sub).clamp(max=len(runs) - 1)]
        live = ~(idle | (t >= count) | (box_gap2(src, box) > bd[:, -1]))
        axis = box[:, 6].long()[:, None]
        qa = src.gather(1, axis)[:, 0]
        for j in range(sub):
            on = live & (t + j < count)
            row = (at + j).clamp(max=len(rows) - 1)
            p = rows[row, :3]
            da = qa - p.gather(1, axis)[:, 0]
            take = on & ~(da * da > bd[:, -1])
            bd, bi = topk_offer(bd, bi, sq_dist(src, p), index[row], take,
                                lex=True)
            tested += int(on.sum())
            full += int(take.sum())
    return bd, bi, tested, full


def emulate_k2(src, ref, values, k, eps=1e-8, axis=None):
    """K2's walk (`knn_blend_kernel`) in float32, over all queries at
    once, one step at a time: the rows of `knn.sweep_layout` (or sorted
    along `axis`), each query's start by binary search on the sorted
    axis, WALK_ROWS vertices up then down per step, a way ending at its
    first vertex whose axis square exceeds the k-th best, the full
    distance and the lexicographic insert by original index for the
    rest. Returns
    ((vals, wdist), vertices reached, full distances)."""
    if axis is None:
        rows, ax = knn.sweep_layout(ref)
        axis = int(ax)
    else:
        rows = sorted_rows(ref, axis)
    v, vid = rows[:, :3], rows.view(torch.int32)[:, 3].long()
    n, m = src.shape[0], v.shape[0]
    qa = src[:, axis].contiguous()
    nan_rows = torch.isnan(src).any(1)
    bd = torch.full((n, k), float("inf"))
    bi = torch.full((n, k), INT_MAX, dtype=torch.int64)
    start = torch.searchsorted(v[:, axis].contiguous(), qa)
    cur = {1: start, -1: start - 1}
    go = {1: (start < m) & ~nan_rows, -1: (start > 0) & ~nan_rows}
    tested = full = 0
    while bool(go[1].any() or go[-1].any()):
        for step in (1,) * WALK_ROWS + (-1,) * WALK_ROWS:
            live = go[step]
            j = cur[step].clamp(0, m - 1)
            p = v[j]
            da = qa - p[:, axis]
            take = live & ~(da * da > bd[:, -1])
            bd, bi = topk_offer(bd, bi, sq_dist(src, p), vid[j], take, lex=True)
            tested += int(live.sum())
            full += int(take.sum())
            cur[step] = torch.where(take, cur[step] + step, cur[step])
            go[step] = take & (cur[step] >= 0) & (cur[step] < m)
    return blend(bd, bi, values, eps, nan_rows), tested, full


def emulate_k5(src, d5ub, verts_sorted, values_sorted, bboxes, k, eps=1e-8):
    """K5's sweep (`knn_blocked_kernel`) in float32, over all queries at
    once: the tiles and cull of `knn.blocked_tiles`/`blocked_cull` (warp
    0's kept list), the rows and boxes of `knn.blocked_layout`; each
    warp of 32 queries takes its kept blocks nearest first (by the gap
    from its centroid to the block's box); per block the exact gap test
    against each query's k-th best, then `sweep_runs` over the block's
    runs of `knn.RUN` vertices, inserting by sorted position.
    Returns ((vals, wdist), pairs whose reject ran, full distances)."""
    tile, block = knn.BLOCKED_TILE, verts_sorted.shape[0] // bboxes.shape[0]
    order, src_p, meta, bb = knn.blocked_tiles(src, d5ub, bboxes)
    keep = knn.blocked_cull(meta, bb)
    rows, sboxes, subs = knn.blocked_layout(verts_sorted, block)
    n_p, n_blocks = src_p.shape[0], bboxes.shape[0]
    warp_of = torch.arange(n_p) // 32
    centroid = src_p.reshape(-1, 32, 3).mean(1)
    kept = keep[torch.arange(centroid.shape[0]) * 32 // tile]
    key = torch.nan_to_num(box_gap2(centroid[:, None], sboxes[None]), nan=0.0)
    ranked = torch.argsort(torch.where(kept, key, float("inf")), dim=1,
                           stable=True)
    bd = torch.full((n_p, k), float("inf"))
    bi = torch.full((n_p, k), INT_MAX, dtype=torch.int64)
    tested = full = 0
    for i in range(n_blocks):
        b = ranked[warp_of, i]
        idle = ~kept[warp_of, b] | (box_gap2(src_p, sboxes[b]) > bd[:, -1])
        bd, bi, te, fu = sweep_runs(src_p, bd, bi, rows, subs, b * block,
                                    torch.full_like(b, block), knn.RUN, idle)
        tested, full = tested + te, full + fu
    bi[bi == INT_MAX] = 0  # a tile that kept no block: column 0, as plain
    vals, wd = blend(bd, bi, values_sorted, eps, torch.isnan(src_p).any(1))
    return knn._unsort(order, vals, wd), tested, full


def assert_reject_is_exact(src, ref):
    """The inequality the rejects rest on: under float32 rounding,
    (a + b) + c >= each of a, b, c >= 0, over every pair of finite
    query and vertex."""
    xx, yy, zz = squares(src[:, None], ref[None])
    d2 = (xx + yy) + zz
    fine = ~torch.isnan(src).any(1)
    for part in (xx, yy, zz, xx + yy):
        assert bool((d2[fine] >= part[fine]).all())


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_k2_sweep_emulation_matches_plain_and_pallas(kind, k):
    src, ref, vals = (torch.tensor(a) for a in knn_inputs(kind, 200, 600, 24, 31))
    want = knn.knn_blend_plain(src, ref, vals, k)
    (got, tested, full) = emulate_k2(src, ref, vals, k)
    assert_bits_equal(got, want)
    for axis in range(3):  # whichever axis the walk's rows are sorted on
        assert_bits_equal(emulate_k2(src, ref, vals, k, axis=axis)[0], want)
    assert_reject_is_exact(src, ref)
    assert full <= tested <= src.shape[0] * ref.shape[0]
    if kind == "cloud":  # the walk reaches a band of the sorted axis only
        assert tested < 0.25 * src.shape[0] * ref.shape[0]
    if kind == "far":
        # XLA on the CPU contracts JAX's d2 into FMAs (it differs from the
        # separately rounded one in the last bit on ~20% of pairs), and
        # 1e3 away the nearest distances lie within an ulp of each other,
        # so JAX's own choice differs from the plain version's there
        return
    j_vals, j_wd = knn_blend_pallas(jnp.asarray(src.numpy()),
                                    jnp.asarray(ref.numpy()),
                                    jnp.asarray(vals.numpy()), k=k,
                                    interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(j_vals), **PALLAS_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(j_wd), **PALLAS_TOL)
    # the same neighbours as the Pallas kernel, ties included: blending
    # one-hot rows, a channel is > 0 exactly where its vertex was chosen
    eye = np.eye(ref.shape[0], dtype=np.float32)
    j_sel, _ = knn_blend_pallas(jnp.asarray(src.numpy()),
                                jnp.asarray(ref.numpy()), jnp.asarray(eye),
                                k=k, interpret=True)
    chosen = emulate_k2(src, ref, torch.tensor(eye), k)[0][0] > 0
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(j_sel) > 0)
    assert int(chosen.sum()) == k * int((~torch.isnan(src).any(1)).sum())


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind,radius", BLOCKED_CASES)
def test_k5_sweep_emulation_matches_plain(kind, radius, k):
    """One whole tile of queries; 600 vertices make 5 Morton blocks of
    128, the last with 40 pads at 1e6; the tile's kept list is empty
    (radius 0 away from the cloud), full (radius 10) or certified (each
    query's k-th distance)."""
    src, ref, vals, d5ub = (torch.tensor(a) for a in blocked_inputs(
        kind, radius, knn.BLOCKED_TILE, 600, 24, k, 32))
    blocks = knn.build_knn_blocks(ref, vals)
    assert bool((blocks[0][600:] == 1e6).all())
    want = knn.knn_blend_blocked_plain(src, d5ub, *blocks, k=k)
    got, tested, full = emulate_k5(src, d5ub, *blocks, k)
    assert_bits_equal(got, want)
    assert_reject_is_exact(src, blocks[0])
    keep = knn.blocked_cull(*knn.blocked_tiles(src, d5ub, blocks[2])[2:])
    assert full <= tested <= int(keep.sum()) * knn.BLOCKED_TILE * 128
    if radius == "zero":
        assert not bool(keep.any()) and tested == 0
    elif radius == "huge":
        assert bool(keep.all())
    elif kind == "corner":
        # the certified radius keeps some blocks and culls others, and
        # K5 then equals the flat blend
        assert 0 < int(keep.sum()) < keep.numel()
        assert_bits_equal(got, knn.knn_blend_plain(src, ref, vals, k))


def test_sweep_layout_sorts_along_the_longest_axis():
    _, ref, _ = (torch.tensor(a) for a in knn_inputs("cloud", 1, 300, 1, 33))
    rows, axis = knn.sweep_layout(ref)
    assert axis.dtype == torch.int32 and int(axis) == 1  # y, the longest
    idx = rows.view(torch.int32)[:, 3].long()
    assert torch.equal(torch.sort(idx).values, torch.arange(300))
    assert torch.equal(rows[:, :3], ref[idx])
    assert bool((rows[1:, 1] >= rows[:-1, 1]).all())
    flat = ref * torch.tensor([1.0, 0.0, 1.0])  # no extent on y: x now
    assert int(knn.sweep_layout(flat)[1]) == 0


def test_layouts_are_built_once_per_tensor_version():
    """The wrappers' layout caches: one build for a frame's calls, a new
    one after an in-place change or for another tensor."""
    _, ref, _ = (torch.tensor(a) for a in knn_inputs("cloud", 1, 300, 1, 34))
    cached = knn.per_version(knn.sweep_layout)
    first = cached(ref)
    assert cached(ref) is first and cached.builds == 1
    ref.mul_(2.0)
    moved = cached(ref)
    assert moved is not first and cached.builds == 2
    assert torch.equal(moved[0][:, :3], knn.sweep_layout(ref)[0][:, :3])
    cached(ref.clone())
    assert cached.builds == 3
    blocks = knn.build_knn_blocks(ref, torch.ones(300, 1))
    rows, boxes, subs = knn.blocked_layout(blocks[0], 128)
    assert rows.shape == (384, 4) and boxes.shape == (3, 8)
    assert subs.shape == (12, 8) and knn.RUN == 32
    assert torch.equal(rows[:, :3], blocks[0])
    assert torch.equal(rows.view(torch.int32)[:, 3].long(), torch.arange(384))
    # the boxes hold every row, the pads at 1e6 included, and a block's
    # box holds its runs' boxes
    assert float(boxes[2, 3:6].min()) == 1e6 and float(subs[11, 0]) == 1e6
    assert torch.equal(subs.reshape(3, 4, 8)[:, :, :3].amin(1), boxes[:, :3])
    assert torch.equal(subs.reshape(3, 4, 8)[:, :, 3:6].amax(1), boxes[:, 3:6])
    # K5 takes blocks of whole runs only
    src = ref[:4].contiguous()
    with pytest.raises(ValueError, match="whole number of runs"):
        knn.knn_blend_blocked(src, torch.ones(4), blocks[0][:200],
                              torch.ones(200, 1), blocks[2][:2])
