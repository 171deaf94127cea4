"""The port's field modules against the flax modules on the same params
(carried across by compat/jax_params.py), and strict weight loading.

Tolerance: rtol = atol = 1e-5 (float32; full-width 8x256 trunks summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu.compat.torch_export import export_aninerf
from animatable_nerf_tpu.fields.fields import BlendWeightField as JBlendWeightField
from animatable_nerf_tpu.fields.fields import TPoseNeRF as JTPoseNeRF

from animatable_nerf_tpu_torch.compat import jax_params
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.fields.fields import BlendWeightField, TPoseNeRF
from animatable_nerf_tpu_torch.models.aninerf import AniNeRF

TOL = dict(rtol=1e-5, atol=1e-5)
CKPT = "data/trained_model/deform/synthetic/latest.flax"


def _inputs(n=96, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    logits = rng.randn(n, 24).astype(np.float32)
    smpl_bw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    vd = rng.randn(n, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, smpl_bw.astype(np.float32), vd


@pytest.mark.parametrize("latent_index", [0, 3])
def test_blend_weight_field_matches_flax(latent_index):
    pts, smpl_bw, _ = _inputs()
    jm = JBlendWeightField(num_latents=5)
    params = jm.init(jax.random.PRNGKey(1), pts, smpl_bw, jnp.int32(0))
    ref = jm.apply(params, pts, smpl_bw, jnp.int32(latent_index))
    tm = BlendWeightField(num_latents=5)
    tm.load_state_dict(
        jax_params.to_tensors(jax_params.bw_field_state_dict(params["params"])),
        strict=True,
    )
    with torch.no_grad():
        got = tm(torch.tensor(pts), torch.tensor(smpl_bw), latent_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_tpose_nerf_matches_flax():
    pts, _, vd = _inputs(seed=1)
    jm = JTPoseNeRF(num_latents=4)
    params = jm.init(jax.random.PRNGKey(2), pts, vd, jnp.int32(0))
    sigma_ref, rgb_ref = jm.apply(params, pts, vd, jnp.int32(2))
    tm = TPoseNeRF(num_latents=4)
    tm.load_state_dict(
        jax_params.to_tensors(jax_params.tpose_nerf_state_dict(params["params"])),
        strict=True,
    )
    with torch.no_grad():
        sigma, rgb = tm(torch.tensor(pts), torch.tensor(vd), 2)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_ref), **TOL)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), **TOL)


def test_checkpoint_loads_strictly_with_reference_names():
    """The tracked checkpoint strict-loads into the port's AniNeRF, whose
    names are exactly those the JAX exporter writes for the reference
    network; a missing or an extra key fails."""
    params = read_checkpoint(CKPT)["params"]
    sd = jax_params.aninerf_state_dict(params)
    model = AniNeRF(num_train_frames=4)
    model.load_state_dict(sd, strict=True)
    exported = export_aninerf(params)
    assert set(exported) == set(model.state_dict())
    for k, v in exported.items():
        np.testing.assert_array_equal(np.asarray(v).reshape(sd[k].shape), sd[k].numpy())
    missing = dict(sd)
    missing.pop("tpose_human.rgb_fc.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        AniNeRF(num_train_frames=4).load_state_dict(missing, strict=True)
    extra = {**sd, "novel_pose_bw.bw_fc.bias": torch.zeros(24)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        AniNeRF(num_train_frames=4).load_state_dict(extra, strict=True)
