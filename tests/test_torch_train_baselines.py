"""The NHR and NT baselines' training, engine paths and data prep on the
CPU, against the JAX package.

  * `BaselineTrainer`: three steps of NT at tiny widths on the same
    frames and weights as JAX's `BaselineTrainer.train_step`; before each step the
    port's loss and stats at JAX's weights of that step within
    TRAIN_LOSS_RTOL = 1e-4 of JAX's; the port's own three steps leave the
    weights within 2 lr a step of JAX's (Adam divides each gradient by
    its own scale, so a gradient that float32 resolves differently can
    move a weight by up to lr in either direction, and the next step
    starts from there).
  * End to end, on a root of JAX's generator (300 vertices, 48x48, as
    tests/test_baseline_engine.py): the port's `run_train` for one epoch
    at make_model's widths, then its `run_evaluate`, each view's PSNR
    within EVAL_DB = 1e-3 dB of JAX's `_run_evaluate_baseline` of the
    port's checkpoint (JAX at full widths evaluates only, once a
    module).
  * Prep: `bw_volume` equals the generator's `lbs/bigpose_bw.npy`;
    `write_uv_maps` equals its `uv/` maps but on at most MAX_UV_PIXELS
    pixels a map (a projection on a rounding boundary, a depth within
    z_eps of another); `write_baseline_copy` at upsample 1 and 2.
  * The VGG19 objective (`train.vgg_weights`, JAX's seeded head in a
    converted .npz): NHR and NT from the same weights as JAX's
    `BaselineTrainer`, the loss and stats (`vgg_loss`, `l1_loss`)
    within TRAIN_LOSS_RTOL and the gradient of the loss within GRAD_REL
    as a whole and within VGG_LEAF_REL (plus a floor) a parameter;
    `run_train` with it writes its checkpoint.
  * The shipped configs of configs/baselines/ get past the model and
    stop for want of their H36M data; the run types the baselines lack
    are refused before any work.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data.synthetic import generate_synthetic_dataset
from animatable_nerf_tpu.train.baseline import BaselineState
from animatable_nerf_tpu.train.baseline import BaselineTrainer as JBaselineTrainer

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.data.baseline_prep import (
    bw_volume,
    write_baseline_copy,
    write_uv_maps,
)
from animatable_nerf_tpu_torch.data.decode_cache import DecodedImages, write_archive
from animatable_nerf_tpu_torch.train.baseline import BaselineTrainer
from animatable_nerf_tpu_torch.train.checkpoints import checkpoint_file
from animatable_nerf_tpu_torch.train.perceptual import random_vgg19_head_arrays

from test_torch_baselines import _np, _tiny

TRAIN_LOSS_RTOL = 1e-4
# the VGG19 objective's gradient against JAX's (measured on this root:
# the whole within 5.0e-5 of its norm for NT and 1.24e-3 for NHR; the
# worst parameter within 2.0e-4 and 1.05e-2 of its own norm). NHR's is
# held to tests/test_torch_baselines.py's ceiling under its ulp control,
# as its forward is ill-conditioned; the floor is for the biases before
# a batch norm, whose gradient is 0 but for rounding (NHR's, some 5e-7
# of a whole of 65)
GRAD_REL = 1e-2
VGG_LEAF_REL = {"nt": 1e-3, "nhr": 2e-2}
VGG_LEAF_FLOOR = 1e-6
EVAL_DB = 1e-3
MAX_UV_PIXELS = 4
IMAGE_SIZE = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the suite's other workers; module scope, so
    that it holds before the module-scoped fixtures."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """tests/test_baseline_engine.py's root: 2 frames, 2 views, 300
    vertices, 48x48, with the baselines' files; its decoded.npz for the
    port."""
    path = str(tmp_path_factory.mktemp("baseline_engine") / "human")
    generate_synthetic_dataset(path, n_frames=2, n_views=2,
                               image_size=IMAGE_SIZE, n_verts=300, n_blobs=64)
    write_archive(path)
    return path


def _opts(root, module, tmp, extra=()):
    dataset = "lib.datasets.h36m." + module
    return ["train_dataset.data_root", root,
            "train_dataset.ann_file", os.path.join(root, "annots.npy"),
            "test_dataset.data_root", root,
            "test_dataset.ann_file", os.path.join(root, "annots.npy"),
            "train_dataset_module", dataset, "test_dataset_module", dataset,
            "training_view", "[0]", "test_view", "[1]", "num_train_frame", "2",
            "H", str(IMAGE_SIZE), "W", str(IMAGE_SIZE), "ep_iter", "2",
            "train.epoch", "1", "exp_name", f"test_{module}",
            "record_dir", os.path.join(tmp, "record"),
            "trained_model_dir", os.path.join(tmp, "model"),
            "result_dir", os.path.join(tmp, "result"), *extra]


def _configs(root, module, tmp, extra=()):
    cfg_file = f"configs/synthetic_{module}.yaml"
    opts = _opts(root, module, str(tmp), extra)
    return load_config(cfg_file, opts), j_load_config(cfg_file, list(opts))


# ---------------------------------------------------------------- steps
@pytest.mark.parametrize("module", ["nt"])
def test_trainer_steps_equal_jax(module, root, tmp_path):
    """Steps on train items 0, 1, 0 from the same weights, on NT (the
    trainer is the same code for NHR, whose loss and gradient
    tests/test_torch_baselines.py holds at tiny widths). Before each
    step the port's loss and stats at JAX's current weights within
    TRAIN_LOSS_RTOL of JAX's step's; the port's own three steps leave
    each weight within 2 lr a step of JAX's."""
    cfg, jcfg = _configs(root, module, tmp_path)
    jmodel, make, _, to_state, to_tree = _tiny(module, IMAGE_SIZE)
    tds = t_engine.make_dataset(cfg, "train")
    jds = j_engine.make_dataset(jcfg, "train")
    items = [(jds[i], tds[i]) for i in (0, 1, 0)]
    torch.manual_seed(0)
    model, probe = make(), make()
    trainer = BaselineTrainer(cfg, model, "cpu")
    probe_trainer = BaselineTrainer(cfg, probe, "cpu")
    jtrainer = JBaselineTrainer(jcfg, jmodel)
    params = jax.tree_util.tree_map(np.array, to_tree(dict(model.named_parameters())))
    state = BaselineState(params, jtrainer.tx.init(params), jnp.asarray(0))
    for jitem, item in items:
        probe.load_state_dict(to_state(_np(state.params)), strict=True)
        with torch.no_grad():
            _, stats = probe_trainer.loss(probe_trainer.frame(item))
        state, jstats = jtrainer.train_step(state, jitem)
        for key, want in jstats.items():
            np.testing.assert_allclose(float(stats[key]), float(want),
                                       rtol=TRAIN_LOSS_RTOL, err_msg=key)
        trainer.train_step(item)
    lr = float(cfg.train.lr)
    want = to_state(_np(state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2 * lr * 3, rtol=0, err_msg=name)


def _vgg_npz(tmp_path):
    """JAX's `random_vgg19_head(0)` as the converters write it."""
    path = str(tmp_path / "vgg19_head.npz")
    np.savez(path, arch="vgg19_head", **random_vgg19_head_arrays(0))
    return path


def test_vgg_objective_refused_before_any_work(root, tmp_path):
    """Kept under its name: the VGG19 objective, once refused, now
    trains. `run_train` of NHR with `train.vgg_weights` takes its step
    (the recorder holds vgg_loss and l1_loss, finite) and writes
    latest.flax."""
    cfg, _ = _configs(root, "nhr", tmp_path,
                      ("train.vgg_weights", _vgg_npz(tmp_path), "ep_iter", "1"))
    trainer, recorder = t_engine.run_train(cfg, "cpu")
    assert trainer.step == 1 and trainer.vgg is not None
    assert checkpoint_file(cfg.trained_model_dir).endswith("latest.flax")
    stats = {k: v.median for k, v in recorder.scalars.items()}
    assert {"vgg_loss", "l1_loss"} <= set(stats)
    assert "pyr_loss" not in stats
    assert all(np.isfinite(v) for v in stats.values())


@pytest.mark.parametrize("module", ["nhr", "nt"])
def test_vgg_step_equals_jax(module, root, tmp_path):
    """Train item 0 from the same weights under the VGG19 objective: the
    port's loss and stats within TRAIN_LOSS_RTOL of JAX's, and its
    gradient (autograd of `BaselineTrainer.loss`, what `train_step`
    clips and hands to Adam) against `jax.grad` of JAX's `_loss`: the
    whole within GRAD_REL of its L2 norm, and each parameter's within
    VGG_LEAF_REL[module] of its own norm plus VGG_LEAF_FLOOR of the
    whole's."""
    cfg, jcfg = _configs(root, module, tmp_path,
                         ("train.vgg_weights", _vgg_npz(tmp_path)))
    jmodel, make, _, to_state, to_tree = _tiny(module, IMAGE_SIZE)
    item = t_engine.make_dataset(cfg, "train")[0]
    jitem = j_engine.make_dataset(jcfg, "train")[0]
    torch.manual_seed(0)
    model = make()
    trainer = BaselineTrainer(cfg, model, "cpu")
    jtrainer = JBaselineTrainer(jcfg, jmodel)
    params = jax.tree_util.tree_map(np.array, to_tree(dict(model.named_parameters())))
    (_, jstats), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss, has_aux=True))(
        params, jtrainer._frame(jitem), jtrainer._vgg)
    loss, stats = trainer.loss(trainer.frame(item))
    assert set(stats) == set(jstats) and "vgg_loss" in stats
    for key, want in jstats.items():
        np.testing.assert_allclose(float(stats[key].detach()), float(want),
                                   rtol=TRAIN_LOSS_RTOL, err_msg=key)
    loss.backward()
    want = {k: v.numpy() for k, v in to_state(_np(jgrads)).items()}
    # a parameter without a gradient (none reaches it) counts as 0
    got = {name: p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
           for name, p in model.named_parameters()}
    whole = np.sqrt(sum(float(np.sum(w ** 2)) for w in want.values()))
    err = np.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in got))
    assert err <= GRAD_REL * whole, err / whole
    for name, g in got.items():
        bound = (VGG_LEAF_REL[module] * np.linalg.norm(want[name])
                 + VGG_LEAF_FLOOR * whole)
        assert np.linalg.norm(g - want[name]) <= bound, name


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("module", ["nhr", "nt"])
def test_train_then_evaluate_equals_jax(module, root, tmp_path):
    """The port trains one epoch (ep_iter 1) from its seeded start and
    writes latest.flax; the port's evaluate and JAX's, on that file,
    agree on every view within EVAL_DB."""
    cfg, jcfg = _configs(root, module, tmp_path, ("ep_iter", "1"))
    trainer, recorder = t_engine.run_train(cfg, "cpu")
    assert trainer.step == 1 and recorder.step == 1
    path = checkpoint_file(cfg.trained_model_dir)
    assert path.endswith("latest.flax")
    ecfg, jecfg = _configs(root, module, tmp_path)
    res = t_engine.run_evaluate(ecfg, "cpu")
    assert os.listdir(os.path.join(ecfg.result_dir, "comparison"))
    with open(path, "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    jecfg.eval = True
    jecfg.result_dir = os.path.join(str(tmp_path), "jax_result")
    jres = j_engine._run_evaluate_baseline(jecfg, params, save_images=False)
    metrics = np.load(os.path.join(jecfg.result_dir, "metrics.npy"),
                      allow_pickle=True).item()
    got = [it["psnr"] for it in res["items"]]
    assert len(got) == len(metrics["psnr"]) == 2
    np.testing.assert_allclose(got, metrics["psnr"], atol=EVAL_DB, rtol=0)
    assert abs(res["psnr"] - jres["psnr"]) <= EVAL_DB


# ------------------------------------------------------------------ prep
def test_prep_equals_the_generator(root, tmp_path):
    lbs = os.path.join(root, "lbs")
    vol, _ = bw_volume(np.load(os.path.join(lbs, "bigpose_vertices.npy")),
                       np.load(os.path.join(lbs, "weights.npy")))
    np.testing.assert_array_equal(vol, np.load(os.path.join(lbs, "bigpose_bw.npy")))
    write_uv_maps(root, str(tmp_path))
    names = sorted(os.listdir(os.path.join(root, "uv")))
    assert names == sorted(os.listdir(tmp_path / "uv")) and len(names) == 4
    for name in names:
        want = np.load(os.path.join(root, "uv", name))
        got = np.load(tmp_path / "uv" / name)
        assert got.shape == want.shape == (IMAGE_SIZE, IMAGE_SIZE, 2)
        differ = (got != want).any(-1)
        assert differ.sum() <= MAX_UV_PIXELS, name
        assert (np.abs(want).sum(-1) > 0).sum() > 100


@pytest.mark.parametrize("upsample", [1, 2])
def test_baseline_copy_of_a_root(root, tmp_path, upsample):
    """write_baseline_copy: the generator's own bigpose_bw.npy, a uv map
    per frame and view, the rest linked; at upsample 2 the images
    repeated and K's first two rows doubled; a second write into the
    same directory refused (it would write through the first's links)."""
    dst = write_baseline_copy(root, str(tmp_path / "copy"), upsample=upsample)
    np.testing.assert_array_equal(
        np.load(os.path.join(dst, "lbs", "bigpose_bw.npy")),
        np.load(os.path.join(root, "lbs", "bigpose_bw.npy")))
    assert len(os.listdir(os.path.join(dst, "uv"))) == 4
    assert os.path.islink(os.path.join(dst, "vertices"))
    cams = [np.load(os.path.join(d, "annots.npy"), allow_pickle=True).item()["cams"]
            for d in (root, dst)]
    K = np.array(cams[0]["K"], np.float64)
    K[:, :2] *= upsample
    np.testing.assert_array_equal(np.asarray(cams[1]["K"], np.float64), K)
    src, out = DecodedImages(root), DecodedImages(dst)
    for key, img in src.items():
        want = img.repeat(upsample, axis=0).repeat(upsample, axis=1)
        np.testing.assert_array_equal(out.imread(os.path.join(dst, key)), want)
    with pytest.raises(FileExistsError, match="not empty"):
        write_baseline_copy(root, dst)


# -------------------------------------------------------- configs, refusals
@pytest.mark.parametrize("cfg_file", sorted(glob.glob("configs/baselines/*.yaml")))
def test_shipped_baseline_configs_reach_their_data(cfg_file):
    """Each of the 14 configs builds its model (at its own H, W, ratio;
    on the meta device, as the weights play no part) and stops only for
    want of its H36M root."""
    cfg = load_config(cfg_file, [])
    with torch.device("meta"):
        model = t_engine.make_model(cfg)
    assert type(model).__name__ in ("NHR", "NT")
    with pytest.raises(FileNotFoundError):
        t_engine.make_dataset(cfg, "test")


@pytest.mark.parametrize("run_type", ["visualize", "animation", "raster"])
def test_image_space_run_types_refused_before_any_work(run_type, tmp_path):
    cfg = load_config("configs/synthetic_nhr.yaml",
                      ["vis_posed_mesh", "True",
                       "result_dir", str(tmp_path / "result")],
                      run_type="evaluate")
    with pytest.raises(NotImplementedError, match="image-space baseline"):
        getattr(t_engine, f"run_{run_type}")(cfg, "cpu")
    assert not os.path.exists(tmp_path / "result")
