"""The reference's losses (train/perceptual.py) and the VGG converter
(tools/convert_vgg_weights.py) of the port against the JAX package's,
on the CPU, on seeded inputs and JAX's seeded weights.

  * taps, `perceptual_loss`, `vgg_perceptual_loss` (plain, masked, Gram),
    `ssim_loss`, `gan_loss` and `NLayerDiscriminator`: within
    LOSS_RTOL = 1e-5 (relative; float32 convolutions summed in another
    order), taps within TAP_TOL of their scale;
  * the converter: the .npz of both packages' converters from the same
    seeded .pth, bit for bit, and each package reads the other's file.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu.train import perceptual as jp

from animatable_nerf_tpu_torch.compat.jax_params import discriminator_state_dict
from animatable_nerf_tpu_torch.tools import convert_vgg_weights as tcv
from animatable_nerf_tpu_torch.train import perceptual as tp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import convert_vgg_weights as jcv  # noqa: E402

LOSS_RTOL = 1e-5
TAP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(shape, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.rand(*shape) * scale).astype(np.float32) for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def _taps_close(got, want):
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TAP_TOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("channels", [3, 4])
def test_vgg19_head_and_perceptual_loss(channels):
    x, t = _pair((2, 24, 20, channels), 0)
    jparams = jp.random_vgg19_head(0)
    params = tp.random_vgg19_head(0)
    _taps_close(tp.vgg19_head_taps(params, _nchw(x[..., :3])),
                jp.vgg19_head_taps(jparams, jnp.asarray(x[..., :3])))
    feat, l1 = tp.perceptual_loss(params, _nchw(x), _nchw(t))
    jfeat, jl1 = jp.perceptual_loss(jparams, jnp.asarray(x), jnp.asarray(t))
    _close(feat, jfeat)
    _close(l1, jl1)


@pytest.mark.parametrize("case", ["plain", "mask", "gram"])
def test_vgg16_gray_taps_and_losses(case):
    x, t = _pair((1, 16, 16, 3), 1, 255.0)
    mask = (np.random.RandomState(2).rand(1, 16, 16, 1) > 0.5).astype(np.float32)
    jparams = jp.random_vgg16_gray(0)
    params = tp.random_vgg16_gray(0)
    if case == "plain":
        _taps_close(tp.vgg16_gray_taps(params, _nchw(x)),
                    jp.vgg16_gray_taps(jparams, jnp.asarray(x)))
    kw = {"layer_weights": (1.0, 0.5, 0.25, 2.0, 1.0)}
    if case == "mask":
        kw["mask"] = mask
    if case == "gram":
        kw.update(mask=mask, is_gram=True)
    jl = jp.vgg_perceptual_loss(jparams, jnp.asarray(x), jnp.asarray(t), **kw)
    if "mask" in kw:
        kw["mask"] = _nchw(mask)
    got = tp.vgg_perceptual_loss(params, _nchw(x), _nchw(t), **kw)
    assert len(got) == len(jl) == 5
    for g, w in zip(got, jl):
        _close(g, w)


def test_ssim_and_gan_losses():
    x, t = _pair((2, 20, 24, 3), 3)
    _close(tp.ssim_loss(_nchw(x), _nchw(t), loss_weight=0.5),
           jp.ssim_loss(jnp.asarray(x), jnp.asarray(t), loss_weight=0.5))
    np.testing.assert_array_equal(tp.gaussian_window(), jp.gaussian_window())
    r = np.random.RandomState(4)
    preds = [r.rand(2, 1, 5, 5).astype(np.float32) * 0.9 + 0.05 for _ in range(3)]
    t_preds = [torch.from_numpy(p) for p in preds]
    j_preds = [jnp.asarray(p) for p in preds]
    for real in (True, False):
        for lsgan in (True, False):
            _close(tp.gan_loss(t_preds[0], real, lsgan),
                   jp.gan_loss(j_preds[0], real, lsgan))
            _close(tp.gan_loss(t_preds, real, lsgan),
                   jp.gan_loss(j_preds, real, lsgan))
            _close(tp.gan_loss([t_preds[:2], t_preds[1:]], real, lsgan),
                   jp.gan_loss([j_preds[:2], j_preds[1:]], real, lsgan))


@pytest.mark.parametrize("interm,sigmoid", [(False, True), (True, True)])
def test_nlayer_discriminator(interm, sigmoid):
    x = np.random.RandomState(5).rand(1, 16, 16, 3).astype(np.float32)
    kw = dict(input_nc=3, ndf=8, n_layers=3, use_sigmoid=sigmoid,
              get_interm_feat=interm)
    jmodel = jp.NLayerDiscriminator(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = tp.NLayerDiscriminator(**kw)
    model.load_state_dict(discriminator_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    with torch.no_grad():
        got = model(_nchw(x))
    want = jmodel.apply(jparams, jnp.asarray(x))
    got, want = (got, want) if interm else ([got], [want])
    assert len(got) == len(want) == (5 if interm else 1)
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=LOSS_RTOL * max(np.abs(w).max(), 1.0))


# ------------------------------------------------------------ converter
def _vgg19_pth(path):
    """A torchvision-layout vgg19 state dict: JAX's seeded head under
    features.{0,2,5,7}, and a later layer the converter must skip."""
    arrays = tp.random_vgg19_head_arrays(7)
    sd = {}
    for ci, mi in enumerate(tcv.VGG19_HEAD_IDX):
        sd[f"features.{mi}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(arrays[f"conv{ci}_w"], (3, 2, 0, 1))))
        sd[f"features.{mi}.bias"] = torch.from_numpy(arrays[f"conv{ci}_b"])
    sd["features.10.weight"] = torch.zeros(256, 128, 3, 3)
    torch.save(sd, path)
    return arrays


def _vgg16_pth(path):
    arrays = tp.random_vgg16_gray_arrays(8)
    sd, ci = {}, 0
    for bi, widths in enumerate(tp.VGG16_GRAY_BLOCKS):
        for wi in range(len(widths)):
            name = f"vgg_layers.conv{bi + 1}_{wi + 1}"
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(arrays[f"conv{ci}_w"], (3, 2, 0, 1))))
            sd[f"{name}.bias"] = torch.from_numpy(arrays[f"conv{ci}_b"])
            ci += 1
    torch.save({"state_dict": sd}, path)
    return arrays


@pytest.mark.parametrize("arch", ["vgg19_head", "vgg16_gray"])
def test_converter_npz_bit_equal_to_jax(arch, tmp_path):
    pth = str(tmp_path / "w.pth")
    arrays = (_vgg19_pth if arch == "vgg19_head" else _vgg16_pth)(pth)
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tcv.main(["--arch", arch, "--pth", pth, "--out", port_npz])
    jcv.np.savez(jax_npz, **getattr(jcv, f"convert_{arch}")(pth))
    got, want = np.load(port_npz), np.load(jax_npz)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # each package reads the other's file
    for k, v in tp.load_vgg_npz(jax_npz).items():
        want_k = want[k] if v.ndim == 1 else np.transpose(want[k], (3, 2, 0, 1))
        np.testing.assert_array_equal(v.numpy(), want_k)
    for k, v in jp.load_vgg_npz(port_npz).items():
        np.testing.assert_array_equal(np.asarray(v), got[k])
