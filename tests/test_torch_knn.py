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
    differ from jnp.linspace's by a float32 ulp before rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
