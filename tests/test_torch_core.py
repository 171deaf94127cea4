"""The PyTorch port's core math against the JAX package, on the CPU.

Same inputs (numpy, seeded) through both; float32 math is held to
rtol = atol = 1e-5 (tests/test_ops.py's tolerance) unless stated.
"""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animatable_nerf_tpu.core import composite as j_comp
from animatable_nerf_tpu.core import encoding as j_enc
from animatable_nerf_tpu.core import grid as j_grid
from animatable_nerf_tpu.core import lbs as j_lbs
from animatable_nerf_tpu.core import rays as j_rays
from animatable_nerf_tpu.core import skeleton as j_skel
from animatable_nerf_tpu.models import common as j_common

from animatable_nerf_tpu_torch.core import composite as t_comp
from animatable_nerf_tpu_torch.core import encoding as t_enc
from animatable_nerf_tpu_torch.core import grid as t_grid
from animatable_nerf_tpu_torch.core import lbs as t_lbs
from animatable_nerf_tpu_torch.core import rays as t_rays
from animatable_nerf_tpu_torch.core import skeleton as t_skel
from animatable_nerf_tpu_torch.models import common as t_common

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


@pytest.mark.parametrize("multires", [0, 4, 10])
def test_positional_encoding(multires):
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    got = t_enc.positional_encoding(_t(x), multires)
    ref = j_enc.positional_encoding(jnp.asarray(x), multires)
    assert got.shape[-1] == t_enc.encoding_dim(multires, 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("det_eps", [0.0, 1e-6])
def test_inverse_3x3(det_eps):
    rng = np.random.RandomState(1)
    m = rng.randn(64, 3, 3).astype(np.float32)
    # near-singular: rank-1 plus a tiny perturbation, and an exact zero
    u, v = rng.randn(8, 3, 1), rng.randn(8, 1, 3)
    m[:8] = (u @ v + 1e-4 * rng.randn(8, 3, 3)).astype(np.float32)
    m[8] = 0.0
    got = _np(t_lbs.inverse_3x3(_t(m), det_eps=det_eps))
    ref = np.asarray(j_lbs.inverse_3x3(jnp.asarray(m), det_eps=det_eps))
    # entries scale like 1/det near singularity: compare relative to the
    # largest entry of each matrix (exact zeros divide by 0 without eps)
    finite = np.isfinite(ref).all(axis=(1, 2))
    assert (np.isfinite(got).all(axis=(1, 2)) == finite).all()
    scale = np.maximum(np.abs(ref[finite]).max(axis=(1, 2), keepdims=True), 1.0)
    np.testing.assert_allclose(got[finite] / scale, ref[finite] / scale, **TOL)
    if det_eps:
        assert finite.all()


def _random_pose(rng):
    joints = rng.randn(24, 3).astype(np.float32) * 0.3
    parents = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12,
                        13, 14, 16, 17, 18, 19, 20, 21])
    poses = (rng.randn(24, 3) * 0.4).astype(np.float32)
    return poses, joints, parents


def test_rigid_transforms_and_rodrigues():
    rng = np.random.RandomState(2)
    poses, joints, parents = _random_pose(rng)
    got, gj = t_skel.rigid_transforms_host(poses, joints, parents, True)
    ref, rj = j_skel.rigid_transforms_host(poses, joints, parents, True)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(gj, rj, **TOL)
    np.testing.assert_allclose(
        t_skel.big_pose_A(joints, parents),
        np.asarray(j_skel.big_pose_A(joints, parents)), **TOL,
    )
    np.testing.assert_allclose(
        _np(t_skel.batch_rodrigues(_t(poses))),
        np.asarray(j_skel.batch_rodrigues(poses)), **TOL,
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rodrigues_matches_cv2(dtype):
    """rodrigues_np is cv2.Rodrigues: same float64 formula, same output
    type. Bit-equal for float32 input (what the dataset passes); float64
    results differ by a few ulp (another evaluation order inside cv2)."""
    rng = np.random.RandomState(3)
    rvecs = [np.zeros(3), np.array([1e-9, 0, 0]), np.array([np.pi, 0, 0])]
    rvecs += list(rng.randn(50, 3) * 2)
    for r in rvecs:
        r = r.astype(dtype)
        got = t_skel.rodrigues_np(r)
        ref = cv2.Rodrigues(r)[0]
        assert got.dtype == ref.dtype
        if dtype == np.float32:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=8 * np.finfo(dtype).eps)


def test_lbs_warps():
    rng = np.random.RandomState(4)
    poses, joints, parents = _random_pose(rng)
    A = j_skel.rigid_transforms_host(poses, joints, parents)
    n = 500
    pts = rng.randn(n, 3).astype(np.float32)
    logits = rng.randn(n, 24).astype(np.float32) * 3
    bw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    Rh = cv2.Rodrigues(rng.randn(3).astype(np.float32))[0].astype(np.float32)
    Th = rng.randn(1, 3).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_lbs.world_points_to_pose_points(_t(pts), _t(Rh), _t(Th))),
        np.asarray(j_lbs.world_points_to_pose_points(pts, Rh, Th)), **TOL,
    )
    np.testing.assert_allclose(
        _np(t_lbs.pose_points_to_tpose_points(_t(pts), _t(bw), _t(A))),
        np.asarray(j_lbs.pose_points_to_tpose_points(pts, bw, A)), **TOL,
    )


@pytest.mark.parametrize("channels,bf16", [(25, False), (1, True)])
def test_grid_lookup_matches_packed(channels, bf16):
    """Trilinear lookup vs pts_sample_blend_weights_packed: points
    inside, exactly on the bounds and outside (border clamp)."""
    rng = np.random.RandomState(5)
    vol = rng.randn(9, 11, 6, channels).astype(np.float32)
    bounds = np.array([[-0.4, -0.9, -0.2], [0.5, 0.8, 0.3]], np.float32)
    inside = rng.uniform(bounds[0], bounds[1], (400, 3))
    on = np.where(rng.rand(60, 3) < 0.5, bounds[0], bounds[1])
    outside = rng.uniform(bounds[0] - 1.0, bounds[1] + 1.0, (300, 3))
    pts = np.concatenate([inside, on, outside]).astype(np.float32)
    packed = j_grid.pack_corner_volume(jnp.asarray(vol))
    tvol = _t(vol)
    if bf16:
        packed = packed.astype(jnp.bfloat16)
        tvol = tvol.to(torch.bfloat16)
    ref = j_grid.pts_sample_blend_weights_packed(
        jnp.asarray(pts), packed, jnp.asarray(bounds), n_channels=channels
    )
    got = t_grid.pts_sample_blend_weights(_t(pts), tvol, _t(bounds))
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **TOL)
    if not bf16:
        unpacked = j_grid.pts_sample_blend_weights(pts, vol, bounds)
        np.testing.assert_allclose(_np(got), np.asarray(unpacked), **TOL)


def _camera(rng, H=128, W=128, dist=5.0):
    K = np.array([[1.6 * W, 0, W / 2], [0, 1.6 * W, H / 2], [0, 0, 1.0]])
    R = cv2.Rodrigues(rng.randn(3) * 0.2)[0]
    T = np.array([[0.1], [-0.2], [dist]])
    return K, R, T


def test_rays_and_near_far():
    """Same numpy code: bit-equal rays, near/far and masks."""
    rng = np.random.RandomState(6)
    K, R, T = _camera(rng, 40, 52)
    bounds = np.array([[-0.5, -0.8, -0.3], [0.4, 0.9, 0.35]], np.float32)
    go, gd = t_rays.get_rays_np(40, 52, K, R, T)
    ro, rd = j_rays.get_rays_np(40, 52, K, R, T)
    np.testing.assert_array_equal(go, ro)
    np.testing.assert_array_equal(gd, rd)
    got = t_rays.get_near_far_np(bounds, go.reshape(-1, 3), gd.reshape(-1, 3))
    ref = j_rays.get_near_far_np(bounds, ro.reshape(-1, 3), rd.reshape(-1, 3))
    assert ref[2].sum() > 100
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", range(4))
def test_bound_2d_mask_matches_cv2(seed):
    """get_bound_2d_mask without cv2 vs the JAX one (cv2.fillPoly) on
    boxes whose projection lies in the image, and fill_poly vs
    cv2.fillPoly on random in-image polygons."""
    rng = np.random.RandomState(10 + seed)
    for _ in range(25):
        K, R, T = _camera(rng, dist=rng.uniform(4.0, 8.0))
        lo = rng.uniform(-0.6, 0.0, 3)
        bounds = np.stack([lo, lo + rng.uniform(0.1, 0.8, 3)]).astype(np.float32)
        pose = np.concatenate([R, T], axis=1)
        ref = j_rays.get_bound_2d_mask(bounds, K, pose, 128, 128)
        got = t_rays.get_bound_2d_mask(bounds, K, pose, 128, 128)
        assert ref.sum() > 0
        np.testing.assert_array_equal(got, ref)
    for _ in range(200):
        H, W = rng.randint(4, 48, 2)
        n = rng.randint(3, 7)
        pts = np.stack([rng.randint(0, W, n), rng.randint(0, H, n)], -1)
        ref = np.zeros((H, W), np.uint8)
        cv2.fillPoly(ref, [pts], 1)
        got = t_rays.fill_poly(np.zeros((H, W), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, ref)


def test_raw2outputs():
    rng = np.random.RandomState(7)
    raw = rng.rand(33, 64, 4).astype(np.float32)
    raw[..., 3] *= (rng.rand(33, 64) < 0.3)
    z = np.sort(rng.uniform(2, 6, (33, 64)), -1).astype(np.float32)
    got = t_comp.raw2outputs(_t(raw), _t(z))
    ref = j_comp.raw2outputs(jnp.asarray(raw), jnp.asarray(z))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def test_composite_compacted_matches_jax():
    """Scatter + raw2outputs vs the JAX segmented-scan compositing of
    the same survivor stream (differs by ~1e-10 per skipped sample)."""
    rng = np.random.RandomState(8)
    n_rays, n_samples = 40, 64
    keep = rng.rand(n_rays * n_samples) < 0.2
    keep[: n_samples] = False  # one ray without survivors
    sidx = np.nonzero(keep)[0].astype(np.int32)
    k = len(sidx)
    rgb = rng.rand(k, 3).astype(np.float32)
    alpha = rng.rand(k).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (n_rays, n_samples)), -1).astype(np.float32)
    cap = k + 37  # dead slots, as the JAX capacity leaves them
    pad = cap - k
    j_sidx = np.concatenate([sidx, np.full(pad, n_rays * n_samples, np.int32)])
    valid = np.arange(cap) < k
    ref = j_comp.composite_compacted(
        jnp.asarray(j_sidx), jnp.asarray(valid),
        jnp.asarray(np.pad(rgb, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(alpha, (0, pad))),
        jnp.asarray(np.pad(z.reshape(-1)[sidx], (0, pad))),
        n_rays, n_samples,
    )
    got = t_comp.composite_compacted(
        _t(sidx).long(), _t(rgb), _t(alpha), _t(z), n_rays, n_samples
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def test_point_filter_helpers():
    rng = np.random.RandomState(9)
    vals = rng.rand(300).astype(np.float32)
    vals[[3, 7]] = np.nan
    vals[11] = -np.inf
    for th in (0.2, -5.0):  # survivors, and none (argmin forced alone)
        got = _np(t_common.keep_mask_with_argmin(_t(vals.copy()), th))
        ref = np.asarray(j_common.keep_mask_with_argmin(jnp.asarray(vals), th))
        np.testing.assert_array_equal(got, ref)
    ties = np.full(50, 3.0, np.float32)
    np.testing.assert_array_equal(
        _np(t_common.keep_mask_with_argmin(_t(ties), 1.0)),
        np.asarray(j_common.keep_mask_with_argmin(jnp.asarray(ties), 1.0)),
    )
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    bounds = np.array([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]], np.float32)
    pts[:5] = bounds[0]  # on the bounds: outside (strict)
    np.testing.assert_array_equal(
        _np(t_common.inside_bounds(_t(pts), _t(bounds))),
        np.asarray(j_common.inside_bounds(pts, bounds)),
    )
    vol = rng.rand(7, 9, 5).astype(np.float32)
    np.testing.assert_allclose(
        float(t_common.volume_lipschitz_bound(_t(vol), _t(bounds))),
        float(j_common.volume_lipschitz_bound(jnp.asarray(vol), jnp.asarray(bounds))),
        **TOL,
    )
    sigma = rng.randn(100).astype(np.float32)
    dists = rng.rand(100).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_common.raw_alpha_from_sigma(_t(sigma), _t(dists))),
        np.asarray(j_common.raw_alpha_from_sigma(sigma, dists)), **TOL,
    )
