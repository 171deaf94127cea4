"""The port's SDF-PDF pieces against the JAX package on the same params
(carried across by compat/jax_params.py `sdf_pdf_state_dict`): the
displacement field, the SDF network and its normals, the color network,
VolSDF opacity, the LBS warps and the model's warp and eval head.

Tolerances: rtol = atol = 1e-5 (float32; 8x256 and 9x256 stacks summed
in another order), 1e-4 for the SDF normals (a backward pass through
nine softplus(100 x) layers, whose slopes sigmoid(100 x) amplify the
forward's rounding), 1e-6 for the LBS warps alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu.compat.torch_export import export_sdf_pdf
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data.dataset import TPosePDFDataset as JTPosePDFDataset
from animatable_nerf_tpu.core import lbs as j_lbs
from animatable_nerf_tpu.core.sdf import sigma_to_alpha as j_alpha
from animatable_nerf_tpu.core.sdf import volsdf_sigma as j_sigma
from animatable_nerf_tpu.core.skeleton import rigid_transforms
from animatable_nerf_tpu.fields.fields import (
    ColorNetwork as JColorNetwork,
    GeometricFieldNetwork as JGeometricFieldNetwork,
    ResidualField as JResidualField,
)
from animatable_nerf_tpu.models.pdf import SDFPDF as JSDFPDF

from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.data.dataset import TPosePDFDataset
from animatable_nerf_tpu_torch.compat.jax_params import sdf_pdf_state_dict
from animatable_nerf_tpu_torch.core import lbs
from animatable_nerf_tpu_torch.core.sdf import sigma_to_alpha, volsdf_sigma
from animatable_nerf_tpu_torch.models.pdf import SDFPDF

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LBS_TOL = dict(rtol=1e-6, atol=1e-6)
CKPT = "data/trained_model/deform/synthetic_sdf_pdf/latest.flax"
N_LATENTS = 4


def _inputs(n=128, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    vd = rng.randn(n, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    return pts, vd, pose


def _perturb(tree, rng, scale=0.05):
    """Move every leaf off its init (the geometric init zeroes the PE
    columns, which would leave them untested)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + scale * np.asarray(rng.randn(*np.shape(a)), np.float32), tree)


@pytest.fixture(scope="module")
def models():
    pts, vd, pose = _inputs()
    key = jax.random.PRNGKey(3)
    rng = np.random.RandomState(4)
    feat = rng.randn(len(pts), 256).astype(np.float32)
    tree = {
        "resd_field": JResidualField().init(key, pts, pose)["params"],
        "sdf_network": JGeometricFieldNetwork().init(key, pts)["params"],
        "beta_network": {"beta": np.float32(0.1)},
        "color_network": JColorNetwork(num_latents=N_LATENTS).init(
            key, pts, vd, vd, feat, jnp.int32(0))["params"],
    }
    tree = _perturb(tree, rng)
    tree["beta_network"]["beta"] = np.float32(0.5)
    port = SDFPDF(num_latents=N_LATENTS)
    port.load_state_dict(sdf_pdf_state_dict(tree), strict=True)
    port.requires_grad_(False)
    return tree, port


def test_residual_field_matches_flax(models):
    tree, port = models
    pts, _, pose = _inputs(seed=1)
    ref = JResidualField().apply({"params": tree["resd_field"]}, pts, pose)
    with torch.no_grad():
        got = port.residual(torch.tensor(pts), torch.tensor(pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_sdf_network_and_normals_match_flax(models):
    tree, port = models
    pts, _, _ = _inputs(seed=2)
    jm = JGeometricFieldNetwork()
    variables = {"params": tree["sdf_network"]}
    ref = jm.apply(variables, pts)
    ref_grad = jax.grad(lambda p: jnp.sum(jm.apply(variables, p)[:, 0]))(pts)
    with torch.no_grad():
        sdf, feat, grad = port._sdf_and_grad(torch.tensor(pts))
    assert ref.shape == (len(pts), 257) and feat.shape == (len(pts), 256)
    np.testing.assert_allclose(sdf.numpy(), np.asarray(ref[:, :1]), **TOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref[:, 1:]), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), **GRAD_TOL)
    assert float(np.abs(np.asarray(ref_grad)).max()) > 0.1


@pytest.mark.parametrize("latent_index", [0, 3])
def test_color_network_matches_flax(models, latent_index):
    tree, port = models
    pts, vd, _ = _inputs(seed=3)
    rng = np.random.RandomState(5)
    normals = rng.randn(len(pts), 3).astype(np.float32)
    feat = rng.randn(len(pts), 256).astype(np.float32)
    ref = JColorNetwork(num_latents=N_LATENTS).apply(
        {"params": tree["color_network"]}, pts, normals, vd, feat,
        jnp.int32(latent_index))
    with torch.no_grad():
        got = port.tpose_human.color_network(
            *(torch.tensor(a) for a in (pts, normals, vd, feat)), latent_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_volsdf_opacity_matches_jax():
    sdf = np.linspace(-0.3, 0.3, 601).astype(np.float32)
    for beta in (0.003, 0.1):
        ref = j_alpha(j_sigma(jnp.asarray(sdf), beta))
        got = sigma_to_alpha(volsdf_sigma(torch.tensor(sdf), torch.tensor(beta)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _frame(seed=6):
    """Seeded pose, bone transforms and blend weights on the capsule
    subject's skeleton."""
    rng = np.random.RandomState(seed)
    joints = np.load("data/synthetic/capsule/lbs/joints.npy").astype(np.float32)
    parents = np.load("data/synthetic/capsule/lbs/parents.npy")
    poses = (rng.randn(24, 3) * 0.3).astype(np.float32)
    A = np.asarray(rigid_transforms(poses, joints, parents), np.float32)
    big = np.zeros((24, 3), np.float32)
    big[1, 2], big[2, 2] = 0.5, -0.5
    big_A = np.asarray(rigid_transforms(big, joints, parents), np.float32)
    logits = rng.randn(128, 24).astype(np.float32) * 2
    bw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return {"A": A, "big_A": big_A, "poses": poses.reshape(-1), "bw": bw}


def test_lbs_warps_match_jax():
    f = _frame()
    pts, vd, _ = _inputs(seed=7)
    t = {k: torch.tensor(v) for k, v in f.items()}
    tp, tvd = torch.tensor(pts), torch.tensor(vd)
    R = f["A"][5, :3, :3]
    pairs = [
        (lbs.world_dirs_to_pose_dirs(tvd, torch.tensor(R)),
         j_lbs.world_dirs_to_pose_dirs(vd, R)),
        (lbs.pose_dirs_to_tpose_dirs(tvd, t["bw"], t["A"]),
         j_lbs.pose_dirs_to_tpose_dirs(vd, f["bw"], f["A"])),
        (lbs.tpose_points_to_pose_points(tp, t["bw"], t["A"]),
         j_lbs.tpose_points_to_pose_points(pts, f["bw"], f["A"])),
        (lbs.tpose_dirs_to_pose_dirs(tvd, t["bw"], t["A"]),
         j_lbs.tpose_dirs_to_pose_dirs(vd, f["bw"], f["A"])),
        *zip(lbs.backward_warp_points_dirs(tp, tvd, t["bw"], t["A"], t["big_A"]),
             j_lbs.backward_warp_points_dirs(pts, vd, f["bw"], f["A"], f["big_A"])),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LBS_TOL)
    assert lbs.backward_warp_points_dirs(tp, None, t["bw"], t["A"],
                                         t["big_A"])[1] is None


def test_model_warp_and_head_match_flax(models):
    tree, port = models
    f = _frame(seed=8)
    pts, vd, _ = _inputs(seed=9)
    pts *= 0.5
    jm = JSDFPDF(num_latents=N_LATENTS)
    j_frame = {"A": f["A"], "big_A": f["big_A"], "poses": f["poses"],
               "latent_index": jnp.int32(2)}
    variables = {"params": tree}
    tpose, tdirs, _, _ = jm.apply(variables, pts, vd, j_frame, f["bw"],
                                  method=JSDFPDF._warp)
    raw = jm.apply(variables, tpose, tdirs, None, j_frame,
                   method=JSDFPDF._eval_head)
    t_frame = {k: torch.tensor(f[k]) for k in ("A", "big_A", "poses")}
    with torch.no_grad():
        got_tpose, got_dirs = port._warp(torch.tensor(pts), torch.tensor(vd),
                                         torch.tensor(f["bw"]), t_frame)
        rgb, alpha = port._eval_head(torch.tensor(np.asarray(tpose)),
                                     torch.tensor(np.asarray(tdirs)), 2)
    np.testing.assert_allclose(got_tpose.numpy(), np.asarray(tpose), **TOL)
    np.testing.assert_allclose(got_dirs.numpy(), np.asarray(tdirs), **TOL)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(raw[:, :3]), **TOL)
    # alpha ~1e-4 here: 1 - exp(-x) resolves it in steps of one float32
    # ulp of 1.0 (1.2e-7), so hold it to that, not to 1e-5
    np.testing.assert_allclose(alpha.numpy(), np.asarray(raw[:, 3]),
                               rtol=1e-5, atol=1.2e-7)
    assert float(np.asarray(raw[:, 3]).min()) > 1e-5


def test_tracked_checkpoint_strict_loads_with_reference_names():
    params = read_checkpoint(CKPT)["params"]
    state = sdf_pdf_state_dict(params)
    port = SDFPDF(num_latents=N_LATENTS)
    port.load_state_dict(state, strict=True)
    # the JAX exporter takes the flax tree, whose SDF layers are a list
    # (the msgpack file stores them as a {"0": ...} dict)
    inner = dict(params["params"])
    layers = inner["sdf_network"]["layers"]
    inner["sdf_network"] = {"layers": [layers[str(i)] for i in range(len(layers))]}
    ref = export_sdf_pdf(inner)
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(v).reshape(state[k].shape),
                                      err_msg=k)


def test_pdf_dataset_items_match_jax():
    """Test-split items of the capsule subject, array by array: equal
    except the bone transforms (24 chained float32 4x4 products summed
    in another order, rtol/atol 1e-6)."""
    cfg = "configs/synthetic_sdf_pdf.yaml"
    tc = load_config(cfg, [], run_type="evaluate")
    jc = j_load_config(cfg, [], run_type="evaluate")
    tc.eval = jc.eval = True
    t_ds, j_ds = TPosePDFDataset(tc, "test"), JTPosePDFDataset(jc, "test")
    assert len(t_ds) == len(j_ds) == 4
    for index in (0, 3):
        got, ref = t_ds[index], j_ds[index]
        assert set(got) == set(ref)
        assert got["pvertices"].shape == (6890, 3)
        for k in ref:
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert g.shape == r.shape, k
            if k in ("A", "big_A"):
                np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(g, r, err_msg=k)
