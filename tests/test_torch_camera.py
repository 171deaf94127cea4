"""Real cameras on the CPU: the port's numpy camera operations
(data/camera.py) against OpenCV, and the port's datasets, evaluate and
train step on a distorted copy of a synthetic root (data/distorted_copy.py:
lens distortion on every camera, masks at half their size) at `ratio
0.5`, against the JAX package on the same copy.

Tolerances:
  * `undistort`, `resize_nearest`, and `resize_area` at an integer
    factor: equal to cv2, bit for bit.
  * `resize_area` at another factor: within 1e-6 of cv2 on [0, 1]
    images (OpenCV sums the fractional areas in float32, the port in
    float64; measured 1.2e-7, one float32 step at 1).
  * The datasets' items: equal, the train ray draw too for one seed;
    the bone transforms A (24 chained float32 4x4 products) within 1e-6.
  * The evaluate view: maps within 1e-4 and |dPSNR| <= 0.01 dB
    (tests/test_torch_slice.py's).
  * The train step: tests/test_torch_train.py's (loss rtol 1e-4, each
    gradient leaf within 1e-2 of its largest entry, Adam's update within
    1e-6 where the gradient is resolved and within 2 lr elsewhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv2

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.evaluators.image import ImageEvaluator as JImageEvaluator
from animatable_nerf_tpu.render.renderer import render_rays as j_render_rays
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.losses import compute_losses as j_compute_losses
from animatable_nerf_tpu.train.trainer import (
    RAY_KEYS,
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.jax_params import (
    aninerf_param_tree,
    aninerf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.data import camera
from animatable_nerf_tpu_torch.data.distorted_copy import (
    DISTORTION,
    config_opts,
    write_distorted_copy,
)
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

AREA_TOL = 1e-6
MAP_TOL = 1e-4
PSNR_TOL_DB = 0.01
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_RESOLVED_TOL = 1e-6
LR = 5e-4
N_RAND, N_SAMPLES = 64, 16
ANINERF_CFG = "configs/synthetic_novel_pose.yaml"
ANINERF_CKPT = "data/trained_model/deform/synthetic_2f/latest.flax"
PDF_CFG = "configs/synthetic_sdf_pdf.yaml"


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    """Distorted copies of the two synthetic roots, with the masks also
    as PNG files for the JAX package."""
    out = {}
    for subject in ("human", "capsule"):
        dst = str(tmp_path_factory.mktemp(f"camera_{subject}"))
        out[subject] = write_distorted_copy(f"data/synthetic/{subject}", dst,
                                            png_writer=cv2.imwrite)
    return out


# ------------------------------------------------------------ camera
def rig(H, W, seed):
    """A camera of the rig's kind on an H x W image (focal 1.6 W, the
    principal point off centre) and a seeded generator."""
    rng = np.random.RandomState(seed)
    K = np.array([[1.6 * W, 0.0, W / 2 + 3.25], [0.0, 1.6 * W * 1.002, H / 2 - 1.5],
                  [0.0, 0.0, 1.0]])
    return K, rng


@pytest.mark.parametrize("size", [128, 1024])
def test_undistort_float_rgb_matches_cv2(size):
    K, rng = rig(size, size, size)
    img = rng.rand(size, size, 3).astype(np.float32)
    got = camera.undistort(img, K, DISTORTION)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.undistort(img, K, DISTORTION))
    # the map's cache changes nothing
    np.testing.assert_array_equal(camera.undistort(img, K, DISTORTION), got)


@pytest.mark.parametrize("values", [(0, 1), (0, 1, 100), tuple(range(256))],
                         ids=["mask", "eroded_mask", "random_uint8"])
@pytest.mark.parametrize("size", [(128, 128), (1001, 1023)])
def test_undistort_uint8_matches_cv2(values, size):
    """Masks (0/1), train masks with erode_mask_edge's 100-valued band,
    and random uint8 images: cv2's integer remap."""
    K, rng = rig(*size, 7)
    msk = rng.choice(np.array(values, np.uint8), size)
    got = camera.undistort(msk, K, DISTORTION)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.undistort(msk, K, DISTORTION))


def test_undistort_strong_distortion_reads_zero_outside():
    """Barrel and pincushion distortion strong enough that the map leaves
    the image: cv2's constant border of 0, tap by tap."""
    K = np.array([[300.0, 0.0, 253.7], [0.0, 297.0, 144.8], [0.0, 0.0, 1.0]])
    rng = np.random.RandomState(3)
    img = rng.rand(300, 500, 3).astype(np.float32)
    u8 = rng.randint(0, 256, (300, 500)).astype(np.uint8)
    for D in ([-0.4, 0.2, 0.01, -0.02, 0.05], [0.3, -0.1, 0.0, 0.0, 0.0]):
        D = np.array(D).reshape(5, 1)
        np.testing.assert_array_equal(camera.undistort(img, K, D),
                                      cv2.undistort(img, K, D))
        ref = cv2.undistort(u8, K, D)
        np.testing.assert_array_equal(camera.undistort(u8, K, D), ref)
    assert (ref == 0).mean() > 0.1


def test_zero_distortion_is_the_identity_in_cv2():
    """The datasets skip the undistort of a camera whose D is all zeros;
    cv2's map is then the identity (integer pixels, weights 1, 0, 0, 0),
    so cv2.undistort returns the image unchanged, float and uint8."""
    zero = np.zeros((5, 1))
    assert camera.is_identity(zero) and not camera.is_identity(DISTORTION)
    for size in [(128, 128), (1002, 1000)]:
        K, rng = rig(*size, 1)
        img = rng.rand(*size, 3).astype(np.float32)
        msk = rng.choice(np.array([0, 1, 100], np.uint8), size)
        np.testing.assert_array_equal(cv2.undistort(img, K, zero), img)
        np.testing.assert_array_equal(cv2.undistort(msk, K, zero), msk)
        np.testing.assert_array_equal(camera.undistort(img, K, zero), img)


@pytest.mark.parametrize("D", [np.zeros(4), np.zeros((8, 1)), np.zeros(14)])
def test_other_distortion_lengths_raise(D):
    with pytest.raises(ValueError, match="5 coefficients"):
        camera.is_identity(D)
    with pytest.raises(ValueError, match="5 coefficients"):
        camera.undistort(np.zeros((8, 8), np.uint8), np.eye(3), D)


@pytest.mark.parametrize("src,dst", [((1024, 1024), (512, 512)),
                                     ((1000, 1002), (500, 501)),
                                     ((128, 128), (64, 64)),
                                     ((90, 120), (30, 40))])
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_resize_area_integer_factor_matches_cv2(src, dst, channels):
    """The mean of the blocks in OpenCV's order: its SIMD pairs at 2x2 for
    1 and 4 channels (one channel's last W % 4 outputs in the scalar
    loop), its scalar loop otherwise."""
    rng = np.random.RandomState(sum(src) + channels)
    shape = src if channels == 0 else (*src, channels)
    img = rng.rand(*shape).astype(np.float32)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    if ref.ndim < img.ndim:  # cv2 drops a single channel's axis
        ref = ref[..., None]
    np.testing.assert_array_equal(camera.resize_area(img, *dst), ref)


@pytest.mark.parametrize("src,dst", [((1001, 1023), (500, 511)),
                                     ((129, 130), (64, 65))])
def test_resize_area_other_factor_within_tolerance(src, dst):
    img = np.random.RandomState(5).rand(*src, 3).astype(np.float32)
    got = camera.resize_area(img, *dst)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=AREA_TOL)


@pytest.mark.parametrize("src,dst", [((1000, 1002), (500, 501)),
                                     ((1001, 1023), (500, 511)),
                                     ((128, 128), (64, 64)),
                                     ((64, 64), (128, 128)),
                                     ((64, 64), (1024, 1024)),
                                     ((37, 53), (100, 71))])
def test_resize_nearest_matches_cv2(src, dst):
    msk = np.random.RandomState(src[0]).randint(0, 256, src).astype(np.uint8)
    np.testing.assert_array_equal(
        camera.resize_nearest(msk, *dst),
        cv2.resize(msk, dst[::-1], interpolation=cv2.INTER_NEAREST))


# ----------------------------------------------------------- datasets
def both_configs(cfg_file, root, split, extra=()):
    opts = config_opts(root) + ["N_rand", str(N_RAND), *extra]
    run_type = "evaluate" if split == "test" else ""
    jc = j_load_config(cfg_file, opts, run_type=run_type)
    tc = load_config(cfg_file, opts, run_type=run_type)
    if split == "test":
        jc.eval = tc.eval = True
    return jc, tc


@pytest.mark.parametrize("split", ["test", "train"])
@pytest.mark.parametrize("cfg_file,subject", [(ANINERF_CFG, "human"),
                                              (PDF_CFG, "capsule")],
                         ids=["TPoseDataset", "TPosePDFDataset"])
def test_items_match_jax(copies, cfg_file, subject, split):
    """Every item of the split on the distorted copy at ratio 0.5: the
    frames at half size with K halved, the masks taken from half size
    back to the image, undistorted (the train split's eroded band
    through the integer remap) and halved, equal to JAX's; and the
    loaded image, masks and K themselves."""
    jc, tc = both_configs(cfg_file, copies[subject], split)
    j_ds, t_ds = j_engine.make_dataset(jc, split), t_engine.make_dataset(tc, split)
    assert len(t_ds) == len(j_ds) > 1
    for index in range(len(t_ds)):
        j_ds._rng = np.random.RandomState(index)
        t_ds._rng = np.random.RandomState(index)
        got, want = t_ds[index], j_ds[index]
        assert set(got) == set(want)
        for k in want:
            g, r = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == r.shape, k
            if k in ("A", "big_A"):
                np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(g, r, err_msg=k)
        assert (int(got["H"]), int(got["W"])) == (64, 64)
        loaded = t_ds.load_image(index)
        for name, g, r in zip(("img", "msk", "orig_msk", "K"), loaded,
                              j_ds.load_image(index)):
            np.testing.assert_array_equal(g, r, err_msg=name)
    K = loaded[3]
    np.testing.assert_array_equal(K[:2], np.asarray(t_ds.cams["K"][loaded[6]])[:2] * 0.5)
    if split == "train":
        assert len(got["ray_o"]) == N_RAND
        # the eroded band, undistorted, is no longer only 0, 1 and 100
        assert len(np.unique(loaded[1])) > 3


def test_dataset_refuses_other_distortion_lengths(copies, tmp_path):
    """A camera whose D has other than 5 coefficients is refused when the
    dataset is built, before any image is read."""
    root = copies["human"]
    annots = np.load(f"{root}/annots.npy", allow_pickle=True).item()
    annots["cams"]["D"] = np.zeros((4, 4, 1))
    np.save(tmp_path / "annots.npy", annots)
    _, tc = both_configs(ANINERF_CFG, root, "test", [
        "test_dataset.ann_file", str(tmp_path / "annots.npy")])
    with pytest.raises(ValueError, match="5 coefficients"):
        t_engine.make_dataset(tc, "test")


# ----------------------------------------------------------- evaluate
def test_evaluate_view_matches_jax(copies, tmp_path, monkeypatch):
    """Test item 0 (frame 0, view 3) of the AniNeRF copy at ratio 0.5 from
    the tracked synthetic_2f weights: the JAX engine's render against the
    port's, and the port's CLI (`run.py --type evaluate`, cut to the one
    item) scored against the JAX evaluator on JAX's render."""
    from animatable_nerf_tpu_torch import run

    extra = ["N_samples", str(N_SAMPLES), "result_dir", str(tmp_path)]
    jc, tc = both_configs(ANINERF_CFG, copies["human"], "test", extra)
    j_eng = j_engine.Engine(jc)
    j_ds = j_engine.make_dataset(jc, "test")
    params = j_eng.load_params(j_eng.init_params(jax.random.PRNGKey(0), j_ds))
    j_item = j_ds[0]
    j_out, _ = j_eng.render_item(params, j_item)

    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params()
    t_out, _ = t_eng.render_item(t_engine.make_dataset(tc, "test")[0])
    for k in ("rgb_map", "acc_map"):
        assert t_out[k].shape == j_out[k].shape, k
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert t_out["acc_map"].max() > 0.5

    ref = JImageEvaluator(str(tmp_path)).evaluate(
        j_out["rgb_map"], np.asarray(j_item["rgb"]),
        np.asarray(j_item["mask_at_box"]), int(j_item["H"]), int(j_item["W"]),
        save_images=False)
    runs = []
    real = t_engine.run_evaluate
    monkeypatch.setattr(t_engine, "run_evaluate", lambda cfg, device: runs.append(
        real(cfg, device, max_items=1)))
    opts = config_opts(copies["human"]) + extra
    run.main(["--type", "evaluate", "--cfg_file", ANINERF_CFG, "--device", "cpu",
              *opts])
    (res,) = runs
    (item,) = res["items"]
    assert abs(item["psnr"] - ref["psnr"]) <= PSNR_TOL_DB


# -------------------------------------------------------------- train
def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_matches_jax(copies):
    """One AniNeRF train step on item 4 of the copy's train split (the
    eroded mask through the integer remap, half-size frames) from the
    synthetic_2f weights with a fresh Adam, against
    `Trainer._train_step`."""
    jc, tc = both_configs(ANINERF_CFG, copies["human"], "train",
                          ["N_samples", str(N_SAMPLES), "perturb", "0"])
    j_ds, t_ds = j_engine.make_dataset(jc, "train"), t_engine.make_dataset(tc, "train")
    j_ds._rng = np.random.RandomState(0)
    t_ds._rng = np.random.RandomState(0)
    jb = j_stack_batch([j_collate_rays(j_ds[4], N_RAND)])
    tb = stack_batch([collate_rays(t_ds[4], N_RAND)])
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-6, atol=1e-6, err_msg=k)

    params = flax_msgpack.read_checkpoint(ANINERF_CKPT)["params"]
    j_trainer = JTrainer(jc, j_engine.make_model(jc))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state0 = TrainState(p, j_trainer.tx.init(p), jnp.asarray(0))
    j_state, j_stats = jax.jit(j_trainer._train_step)(state0, jb,
                                                      jax.random.PRNGKey(0))

    def j_loss(q):
        fb = {k: jnp.asarray(v[0]) for k, v in jb.items()}
        rays = {k: fb[k] for k in RAY_KEYS if k in fb}
        ret = j_render_rays(j_trainer.model, q, rays, fb, j_trainer.settings,
                            key=jax.random.PRNGKey(0), train=True)
        return j_compute_losses(ret, rays, 0)[0]

    j_grads = jax.jit(jax.grad(j_loss))(p)

    model = t_engine.make_model(tc)
    model.load_state_dict(aninerf_state_dict(params), strict=True)
    trainer = Trainer(tc, model, "cpu")
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), float(j_stats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want_g = leaves(j_grads)
    got_g = leaves(aninerf_param_tree(
        {n: q.grad for n, q in trainer.model.named_parameters()}))
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        assert np.isfinite(got_g[k]).all(), k
        assert np.abs(got_g[k] - w).max() <= GRAD_REL * np.abs(w).max(), k

    p0 = leaves(params)
    trainer.apply_gradients()
    got = leaves(aninerf_param_tree(dict(trainer.model.named_parameters())))
    for k, w in leaves(j_state.params).items():
        resolved = np.abs(want_g[k]) > 100 * GRAD_REL * np.abs(want_g[k]).max()
        d = np.abs(got[k] - w)
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(w - p0[k]).max() <= LR * (1 + 1e-3), k
    assert int(j_state.step) == 1


def test_train_step_gradient_conditioning(copies):
    """Why chip_smoke.py holds the card's camera-copy train step to the
    CPU's by the whole gradient's L2 norm and not leaf by leaf: on its
    batch (item 4, 512 rays of 64 samples, the synthetic_2f weights),
    moving each ray_d by one float32 ulp moves some gradient leaf by more
    than 1% of its largest entry (measured 2.8%), the whole gradient by
    less than 1e-3 of its L2 norm (measured 3.3e-4)."""
    tc = load_config(ANINERF_CFG, config_opts(copies["human"]) + ["perturb", "0"])
    ds = t_engine.make_dataset(tc, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[4], int(tc.N_rand))])
    state = aninerf_state_dict(flax_msgpack.read_checkpoint(ANINERF_CKPT)["params"])

    def grads(b):
        model = t_engine.make_model(tc)
        model.load_state_dict(state, strict=True)
        loss, _, _ = Trainer(tc, model, "cpu").loss({k: v[0] for k, v in b.items()})
        loss.backward()
        return {n: q.grad.double() for n, q in model.named_parameters()
                if q.grad is not None}

    base = grads(batch)
    moved = grads(dict(batch, ray_d=np.nextafter(batch["ray_d"], np.float32(np.inf))))
    leaf = max(float((moved[n] - g).abs().max() / g.abs().max())
               for n, g in base.items())
    l2 = np.sqrt(sum(float(((moved[n] - g) ** 2).sum()) for n, g in base.items())
                 / sum(float((g ** 2).sum()) for g in base.values()))
    assert leaf > GRAD_REL
    assert l2 < 0.1 * GRAD_REL
