"""Kernels K3 and K4 (ops/knn.py `min_dist`, `kth_distance`): a CPU
rehearsal of their walk over Morton-sorted runs of vertices
(csrc/knn.cu `grid_walk`), against the plain versions and against the
JAX package, on tests/knn_cases.py's kinds, a lattice over the capsule
subject's T-pose vertices, and fewer vertices than a run.

Tolerances:
  * the emulation against the plain versions: bit-equal. Both form each
    squared distance by the same rounded float32 operations, the walk
    skips only pairs that cannot change a value (its rejects are exact:
    the gaps' squares summed as d2 is summed are <= d2, bit for bit),
    and the k-th smallest value does not depend on the order in which
    vertices arrive;
  * against the Pallas K3 in interpret mode and JAX's K4 (its XLA twin,
    which JAX runs off the TPU): rtol = atol = 1e-6, the same float32
    operations, which XLA may fuse. The "far" kind is left out there:
    XLA on the CPU contracts JAX's d2 into FMAs, and 1e3 away that moves
    which of the near-equal distances is the k-th.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from knn_cases import KINDS, knn_inputs

from animatable_nerf_tpu.ops import knn_pallas as jk

from animatable_nerf_tpu_torch.ops import knn

TOL = dict(rtol=1e-6, atol=1e-6)
LANES = 32  # queries per warp in the kernel
TVERTICES = (Path(__file__).resolve().parents[1]
             / "data/synthetic/capsule/lbs/tvertices.npy")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation issues many small ops: beside the suite's other
    workers, torch's intra-op threads would oversubscribe the cores and
    slow them many times over, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def span_gap(qlo, qhi, lo, hi):
    """`span_gap` (and `axis_gap` with qlo = qhi): the signed difference
    from an interval of queries to the nearer face of a box, 0 where
    they overlap, per axis."""
    return torch.where(qhi < lo, qhi - lo,
                       torch.where(qlo > hi, qlo - hi, torch.zeros_like(lo)))


def gap_sq(g):
    """`gap_sq`: the gaps (..., 3) squared and summed as d2 is summed."""
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def sq_dist(q, p):
    d = q - p
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def emulate_grid_walk(src, ref, k):
    """K3's (k = 1) and K4's walk in float32, every warp at once, one run
    at a time: `knn.grid_layout`'s rows and run boxes; each warp of 32
    consecutive queries ranks the runs by the gap from its live queries'
    box (ties: the owning lane, run % 32, then the run), and takes them
    in that order until the next key is >= the largest k-th best over its
    lanes; a lane takes part in a run only if its own gap to the run's
    box is below its k-th best; each row then gets the reject on the
    run's longest axis before its full distance, and enters the k best
    values if below the k-th. Lanes past N and NaN queries take no part.
    Returns (out (N,), [(warp, run) pairs ranked, swept, (query, vertex)
    pairs tested, full distances])."""
    rows, runs = knn.grid_layout(ref)
    n, n_runs = src.shape[0], runs.shape[0]
    n_p = -(-n // LANES) * LANES
    q = src.new_zeros(n_p, 3)
    q[:n] = src
    nan_query = torch.isnan(q).any(1)
    live = (torch.arange(n_p) < n) & ~nan_query
    inf = float("inf")
    bd = torch.where(live, inf, -1.0)[:, None].repeat(1, k)
    warp_live = live.reshape(-1, LANES)
    qw = q.reshape(-1, LANES, 3)
    lo = torch.where(warp_live[..., None], qw, inf).amin(1)
    hi = torch.where(warp_live[..., None], qw, -inf).amax(1)
    keys = gap_sq(span_gap(lo[:, None], hi[:, None], runs[None, :, 0:3],
                           runs[None, :, 3:6]))
    r = torch.arange(n_runs)
    tie = torch.argsort((r % LANES) * n_runs + r)
    order = tie[torch.argsort(keys[:, tie], dim=1, stable=True)]
    ordered_keys = keys.gather(1, order)
    warp_of = torch.arange(n_p) // LANES
    active = warp_live.any(1)
    counts = [0, 0, 0, 0]
    for i in range(n_runs):
        top = torch.where(live, bd[:, -1], 0.0).reshape(-1, LANES).amax(1)
        active &= ordered_keys[:, i] < top
        if not bool(active.any()):
            break
        run = order[:, i][warp_of]
        box = runs[run]
        need = active[warp_of] & (gap_sq(span_gap(q, q, box[:, 0:3],
                                                  box[:, 3:6])) < bd[:, -1])
        axis = box[:, 6].long()[:, None]
        qa = q.gather(1, axis)[:, 0]
        counts[0] += int(active.sum())
        counts[1] += int(need.reshape(-1, LANES).any(1).sum())
        counts[2] += knn.RUN * int(need.sum())
        for j in range(knn.RUN):
            p = rows[run * knn.RUN + j, :3]
            da = qa - p.gather(1, axis)[:, 0]
            take = need & (da * da < bd[:, -1])
            best = torch.sort(torch.cat([bd, sq_dist(q, p)[:, None]], 1),
                              dim=1).values[:, :k]
            bd = torch.where(take[:, None], best, bd)
            counts[3] += int(take.sum())
    out = torch.where(nan_query, float("nan"), torch.sqrt(bd[:, -1]))
    return out[:n], counts


def plain(src, ref, k):
    return (knn.min_dist_plain(src, ref) if k == 1
            else knn.kth_distance_plain(src, ref, k))


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def assert_run_gaps_are_exact(src, ref):
    """The inequality the walk's rejects rest on: each query's gap to a
    run's box, squared and summed as d2 is, is <= d2 to every vertex of
    the run, bit for bit."""
    rows, runs = knn.grid_layout(ref)
    q = src[~torch.isnan(src).any(1)][:, None]
    g2 = gap_sq(span_gap(q, q, runs[None, :, 0:3], runs[None, :, 3:6]))
    d2 = sq_dist(q, rows[None, :, :3]).reshape(q.shape[0], -1, knn.RUN)
    assert bool((g2 <= d2.amin(2)).all())


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_grid_walk_emulation_matches_plain_and_jax(kind, k):
    """200 queries (no whole number of warps), 600 vertices (18 runs and
    24 pads at +inf)."""
    src, ref, _ = (torch.tensor(a) for a in knn_inputs(kind, 200, 600, 1, 41))
    want = plain(src, ref, k)
    got, counts = emulate_grid_walk(src, ref, k)
    assert_bits_equal(got, want)
    assert_run_gaps_are_exact(src, ref)
    ranked, swept, tested, full = counts
    assert swept <= ranked <= 7 * 19 and full <= tested
    if kind == "far":  # see the module docstring
        return
    s, r = jnp.asarray(src.numpy()), jnp.asarray(ref.numpy())
    if k == 1:
        jax_out = jk.min_dist_pallas(s, r, interpret=True)
    else:
        jax_out = jk.kth_distance(s, r, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)


@pytest.mark.parametrize("k", [1, 5])
def test_grid_walk_on_a_capsule_lattice(k):
    """A 16^3 lattice (x-major, as `pdist_grid_nodes` makes it) over the
    capsule subject's T-pose vertices (6890): bit-equal, and the walk
    reaches few of the pairs."""
    verts = torch.tensor(np.load(TVERTICES))
    nodes, _, _ = knn.pdist_grid_nodes(verts, 16)
    got, counts = emulate_grid_walk(nodes, verts, k)
    assert_bits_equal(got, plain(nodes, verts, k))
    pairs = nodes.shape[0] * verts.shape[0]
    assert counts[3] <= counts[2] < 0.15 * pairs


@pytest.mark.parametrize("k", [1, 5])
def test_grid_walk_with_fewer_vertices_than_a_run(k):
    """m = 5: one run of 5 vertices and 27 pads at +inf, which never
    enter a value (with k = 5 the answer is the farthest vertex)."""
    src, ref, _ = (torch.tensor(a) for a in knn_inputs("duplicates", 70, 5, 1, 42))
    got, _ = emulate_grid_walk(src, ref, k)
    assert_bits_equal(got, plain(src, ref, k))
    assert bool(torch.isfinite(got).all())


def test_grid_layout_morton_runs_and_boxes():
    verts = torch.tensor(np.load(TVERTICES))
    rows, runs = knn.grid_layout(verts)
    m = verts.shape[0]
    assert rows.shape == (6912, 4) and runs.shape == (216, 8)
    # a permutation of the vertices in Morton order, then pads at +inf
    assert torch.equal(rows[:m, :3], verts[knn._morton_order(verts)])
    assert bool(torch.isinf(rows[m:, :3]).all()) and bool((rows[:, 3] == 0).all())
    # each box holds its run's real rows, and is finite
    real = rows[:, :3].reshape(-1, knn.RUN, 3)
    inside = (real >= runs[:, None, 0:3]) & (real <= runs[:, None, 3:6])
    assert bool((inside | torch.isinf(real)).all())
    assert bool(torch.isfinite(runs).all())
    assert torch.equal(runs[-1, 3:6], verts[knn._morton_order(verts)][-(m % 32):]
                       .amax(0))
    extent = runs[:, 3:6] - runs[:, 0:3]
    assert torch.equal(runs[:, 6].long(), extent.argmax(1))


def test_grid_wrappers_take_the_plain_versions_on_the_cpu():
    src, ref, _ = (torch.tensor(a) for a in knn_inputs("cloud", 50, 300, 1, 43))
    before = (knn.min_dist.launches, knn.kth_distance.launches)
    assert torch.equal(knn.min_dist(src, ref), knn.min_dist_plain(src, ref))
    assert torch.equal(knn.kth_distance(src, ref, 3),
                       knn.kth_distance_plain(src, ref, 3))
    assert (knn.min_dist.launches, knn.kth_distance.launches) == before
    # the counting builds run on the card only, at k = 1 or 5
    with pytest.raises(ValueError, match="k = 1 or 5"):
        knn.grid_dist_counts(src, ref, 3)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        knn.grid_dist_counts(src, ref, 5)
