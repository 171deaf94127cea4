"""AniNeRF stage 2 (novel pose) on the CPU: the port against the JAX
package on the same inputs and weights (configs/synthetic_novel_pose.yaml:
stage 1 on frames 0-1, the novel-pose window on frames 2-3), at full
widths (8x256 trunks) with N_ANIM points per branch.

The JAX package draws its points with jax.random, which the port cannot
reproduce, so both packages' `uniform_box_points` are patched here to
return the same seeded numpy points (`FixedDraws`); nothing in either
package changes for it.

Tolerances:
  * The consistency pairs (`animation_from_pose`,
    `animation_from_canonical`): pbw and tbw within PAIR_TOL = 1e-4
    (float32: three chained 8x256 MLPs and an LBS inverse summed in
    another order; measured 8.2e-6), the selection masks equal.
  * Loss and stats: rtol LOSS_RTOL = 1e-4. `novel_pose_bw`'s gradient,
    per leaf: max |d| <= GRAD_REL x max |g|, GRAD_REL = 1e-2 (the
    canonical points' rounding multiplied by the positional encoding,
    as in tests/test_torch_train.py). No other parameter gets a
    gradient in the port; JAX's optimizer zeroes theirs.
  * One step of `AnimationTrainer`: the trained entries whose JAX
    gradient is resolved (above 100 x its leaf's gradient tolerance)
    within 1e-6 of JAX, every entry within 2 lr (Adam steps each entry
    by at most lr, its sign decided by the gradient's); every other leaf
    bit-identical to the start, in both packages.
  * Three steps: each step's loss within rtol 1e-4 of JAX's; the port's
    Adam fed JAX's gradients gives JAX's params within 1e-6; the frozen
    leaves bit-identical after three steps.
  * The partial load, the checkpoints and the codec: exact.
  * A `test_novel_pose` eval item (frame 2, view 3, 16 samples a ray):
    maps within 1e-4, the tile counts equal, |dPSNR| <= 0.01 dB.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.compat.torch_export import export_aninerf
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.train import animation as j_animation
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    load_params_partial as j_load_params_partial,
    save_checkpoint as j_save_checkpoint,
)
from animatable_nerf_tpu.train.trainer import (
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import run as t_run
from animatable_nerf_tpu_torch import train_net
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.jax_params import (
    aninerf_param_tree,
    aninerf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator
from animatable_nerf_tpu_torch.train import animation as t_animation
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    load_params_partial,
    save_checkpoint,
    write_fresh_start,
)
from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

CFG = "configs/synthetic_novel_pose.yaml"
STAGE1_DIR = "data/trained_model/deform/synthetic_2f"
ANIM_CKPT = "data/trained_model/deform/synthetic_2f_anim/latest.flax"
N_ANIM = 384
N_RAND = 64
OPTS = ["aninerf_animation", "True", "n_anim_samples", str(N_ANIM),
        "N_rand", str(N_RAND), "N_samples", "16"]
PAIR_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_RESOLVED_TOL = 1e-6
STEPS_PARAM_TOL = 1e-6
MAP_TOL = 1e-4
PSNR_TOL_DB = 0.01
LR = 5e-4
TRAINED = "novel_pose_bw"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: beside the suite's other workers, torch's intra-op
    threads would oversubscribe the cores. Module-scoped, so the
    module's fixtures run on one thread too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def trained_leaf(key):
    return f"'{TRAINED}'" in key


class FixedDraws:
    """`uniform_box_points` for both packages: the k-th call of each
    returns the k-th of one seeded sequence of numpy unit draws, scaled
    into the bounds it is given, so both see equal points."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.units = []
        self.calls = {"jax": 0, "port": 0, "again": 0}
        self.jax_calls = "jax"

    @contextlib.contextmanager
    def again(self):
        """JAX's draws inside this block count on a sequence of their
        own: a second JAX call on the points of a step."""
        self.jax_calls = "again"
        try:
            yield
        finally:
            self.jax_calls = "jax"

    def points(self, side, bounds, n):
        k = self.calls[side]
        self.calls[side] += 1
        while len(self.units) <= k:
            self.units.append(self.rng.rand(n, 3))
        b = np.asarray(bounds, np.float64)
        return (b[0] + (b[1] - b[0]) * self.units[k]).astype(np.float32)

    def patch(self, monkeypatch):
        monkeypatch.setattr(
            j_animation, "uniform_box_points",
            lambda key, bounds, n: jnp.asarray(
                self.points(self.jax_calls, bounds, n)))
        monkeypatch.setattr(
            t_animation, "uniform_box_points",
            lambda gen, bounds, n: torch.from_numpy(
                self.points("port", bounds.cpu(), n)).to(bounds.device))
        return self


@pytest.fixture(scope="module")
def cfgs():
    return j_load_config(CFG, OPTS), load_config(CFG, OPTS)


@pytest.fixture(scope="module")
def params():
    return flax_msgpack.read_checkpoint(ANIM_CKPT)["params"]


@pytest.fixture(scope="module")
def datasets(cfgs):
    jc, tc = cfgs
    return j_engine.make_dataset(jc, "train"), t_engine.make_dataset(tc, "train")


def batches(datasets, index, seed=0):
    """Item `index` of both stage-2 train splits (frames 2-3), collated."""
    j_ds, t_ds = datasets
    j_ds._rng = np.random.RandomState(seed)
    t_ds._rng = np.random.RandomState(seed)
    return (j_stack_batch([j_collate_rays(j_ds[index], N_RAND)]),
            stack_batch([collate_rays(t_ds[index], N_RAND)]))


class JaxSide:
    """JAX's AnimationTrainer from `params`, a fresh optimizer state."""

    def __init__(self, jc, params, probe):
        self.model = j_engine.make_model(jc)
        self.trainer = j_animation.AnimationTrainer(jc, self.model)
        self.init = self.trainer.init_state(jax.random.PRNGKey(42), probe)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        self.state0 = TrainState(p, self.trainer.tx.init(p), jnp.asarray(0))

    def loss_grad(self, jb, params):
        fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
        (loss, stats), grads = jax.value_and_grad(
            lambda p: j_animation.animation_loss(
                self.model, p, fb, jax.random.PRNGKey(0), N_ANIM),
            has_aux=True)(params)
        return float(loss), {k: float(v) for k, v in stats.items()}, grads

    def apply(self, state, grads):
        updates, opt_state = self.trainer.tx.update(grads, state.opt_state,
                                                    state.params)
        return TrainState(jax.tree_util.tree_map(lambda p, u: p + u,
                                                 state.params, updates),
                          opt_state, state.step + 1)


@pytest.fixture(scope="module")
def jax_side(cfgs, params, datasets):
    return JaxSide(cfgs[0], params, batches(datasets, 0)[0])


def port_trainer(tc, params):
    model = t_engine.make_model(tc)
    model.load_state_dict(aninerf_state_dict(params), strict=True)
    return t_animation.AnimationTrainer(tc, model, "cpu")


def model_params(model):
    return leaves(aninerf_param_tree(dict(model.named_parameters())))


def port_params(trainer):
    return model_params(trainer.model)


def port_grads(trainer):
    return {k: v for k, v in leaves(aninerf_param_tree(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in trainer.model.named_parameters()})).items()
        if trained_leaf(k)}


def set_grads(trainer, j_grads):
    named = aninerf_state_dict(j_grads)
    for name, p in trainer.model.named_parameters():
        if p.requires_grad:
            p.grad = named[name].reshape(p.shape).clone()


# ------------------------------------------------------------- model
def test_consistency_pairs_match_jax(cfgs, params, datasets, jax_side):
    """Both branches on seeded points of the frame's boxes, with the
    tracked stage-2 weights: the pairs and the selection masks."""
    jb, tb = batches(datasets, 4)
    fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
    trainer = port_trainer(cfgs[1], params)
    frame = trainer._frame({k: v[0] for k, v in tb.items()})
    draws = FixedDraws(5)
    wpts = draws.points("jax", fb["wbounds"], N_ANIM)
    tpts = draws.points("jax", fb["tbounds"], N_ANIM)
    from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points

    ppts = world_points_to_pose_points(torch.tensor(wpts), frame["R"],
                                       frame["Th"])
    m, p = jax_side.model, jax_side.state0.params
    want = (m.apply(p, jnp.asarray(ppts.numpy()), fb,
                    method=m.animation_from_pose),
            m.apply(p, jnp.asarray(tpts), fb,
                    method=m.animation_from_canonical))
    got = (trainer.model.animation_from_pose(ppts, frame),
           trainer.model.animation_from_canonical(torch.tensor(tpts), frame))
    for (jp, jt, jsel), (tp, tt, tsel) in zip(want, got):
        for g, w, name in ((tp, jp, "pbw"), (tt, jt, "tbw")):
            g = g.detach().numpy()
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=PAIR_TOL, err_msg=name)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        assert int(tsel.sum()) > 1


def test_density_matches_jax(params):
    """TPoseNeRF.density: the trunk and alpha_fc alone."""
    from animatable_nerf_tpu.fields import TPoseNeRF as JTPoseNeRF
    from animatable_nerf_tpu_torch.compat.jax_params import (
        to_tensors, tpose_nerf_state_dict)
    from animatable_nerf_tpu_torch.fields.fields import TPoseNeRF

    p = {"params": params["params"]["tpose_human"]}
    pts = np.random.RandomState(2).uniform(-0.6, 0.6, (200, 3)).astype(np.float32)
    jm = JTPoseNeRF(num_latents=2)
    want = jm.apply(p, jnp.asarray(pts), method=jm.density)
    tm = TPoseNeRF(2)
    tm.load_state_dict(to_tensors(tpose_nerf_state_dict(p["params"])))
    with torch.no_grad():
        got = tm.density(torch.tensor(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PAIR_TOL)


# -------------------------------------------------------------- loss
def test_loss_and_gradient_match_jax(monkeypatch, cfgs, params, datasets,
                                     jax_side):
    """The stage-2 loss of one frame and `novel_pose_bw`'s gradient,
    against jax.grad of JAX's animation_loss on the same points."""
    FixedDraws(1).patch(monkeypatch)
    jb, tb = batches(datasets, 1)
    j_loss, j_stats, j_grads = jax_side.loss_grad(jb, jax_side.state0.params)
    trainer = port_trainer(cfgs[1], params)
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    for name, p in trainer.model.named_parameters():
        assert (p.grad is not None) == name.startswith(TRAINED + "."), name
    want = {k: v for k, v in leaves(j_grads).items() if trained_leaf(k)}
    got = port_grads(trainer)
    assert set(got) == set(want) and len(want) == 19
    for k, w in want.items():
        scale = np.abs(w).max()
        assert np.isfinite(got[k]).all(), k
        assert np.abs(got[k] - w).max() <= GRAD_REL * scale, k


# ------------------------------------------------------------- steps
def test_train_step_matches_jax(monkeypatch, cfgs, params, datasets, jax_side):
    """One step of AnimationTrainer from the tracked weights and a fresh
    Adam: the loss, the trained field, and every frozen leaf as it was."""
    draws = FixedDraws(2).patch(monkeypatch)
    jb, tb = batches(datasets, 3)
    with draws.again():
        _, _, j_grads = jax_side.loss_grad(jb, jax_side.state0.params)
    j_state, j_stats = jax_side.trainer._train_step(
        jax_side.state0, jb, jax.random.PRNGKey(0))
    trainer = port_trainer(cfgs[1], params)
    stats = trainer.train_step(tb)
    np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                               rtol=LOSS_RTOL)
    p0, want_g = leaves(params), leaves(j_grads)
    got, want = port_params(trainer), leaves(j_state.params)
    for k, w in want.items():
        if not trained_leaf(k):
            np.testing.assert_array_equal(w, p0[k], err_msg=k)
            np.testing.assert_array_equal(got[k], p0[k], err_msg=k)
            continue
        resolved = np.abs(want_g[k]) > 100 * GRAD_REL * np.abs(want_g[k]).max()
        d = np.abs(got[k] - w)
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(got[k] - p0[k]).max() > 0, k
    assert trainer.step == trainer.updates == int(j_state.step) == 1


def test_three_steps_match_jax(monkeypatch, cfgs, params, datasets, jax_side):
    """Three steps on frames 2, 3, 2: each step's loss; the port's Adam
    fed JAX's gradients against JAX's optimizer; the frozen leaves."""
    draws = FixedDraws(3).patch(monkeypatch)
    trainer = port_trainer(cfgs[1], params)
    fed = port_trainer(cfgs[1], params)
    state = applied = jax_side.state0
    for index in (0, 4, 2):
        jb, tb = batches(datasets, index, index)
        state, j_stats = jax_side.trainer._train_step(state, jb,
                                                      jax.random.PRNGKey(0))
        stats = trainer.train_step(tb)
        np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                                   rtol=LOSS_RTOL)
        with draws.again():
            _, _, j_grads = jax_side.loss_grad(jb, applied.params)
        applied = jax_side.apply(applied, j_grads)
        set_grads(fed, j_grads)
        fed.apply_gradients()
    assert trainer.step == trainer.updates == int(state.step) == 3
    p0, want = leaves(params), leaves(applied.params)
    for k, g in port_params(fed).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)
    for side in (port_params(trainer), leaves(state.params)):
        for k, v in side.items():
            if not trained_leaf(k):
                np.testing.assert_array_equal(v, p0[k], err_msg=k)
    assert all(np.isfinite(v).all() for v in port_params(trainer).values())


# ---------------------------------------------------- loads and files
def test_init_aninerf_partial_load_matches_jax(cfgs, jax_side):
    """`init_aninerf`: the stage-1 file's leaves replace the init, the
    novel-pose field keeps it, as JAX's load_params_partial(strict=False)
    does with its own init."""
    _, tc = cfgs
    fresh = t_engine.make_model(tc)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in fresh.parameters():
            p.normal_()
    before = model_params(fresh)
    load_params_partial(STAGE1_DIR, fresh)
    got = model_params(fresh)
    template = jax_side.init.params
    want = leaves(j_load_params_partial(STAGE1_DIR, template, strict=False))
    stage1 = leaves(flax_msgpack.read_checkpoint(
        os.path.join(STAGE1_DIR, "latest.flax"))["params"])
    assert set(got) == set(want)
    n_kept = 0
    for k, w in want.items():
        if trained_leaf(k):
            n_kept += 1
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(w, leaves(template)[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            np.testing.assert_array_equal(got[k], stage1[k], err_msg=k)
    assert n_kept == 19
    # run_train's start: the same load after the seeded init
    for k, v in model_params(t_engine.initial_model(tc)).items():
        if not trained_leaf(k):
            np.testing.assert_array_equal(v, stage1[k], err_msg=k)


def test_missing_init_aninerf_raises_before_any_work(tmp_path):
    cfg = load_config(CFG, OPTS + ["init_aninerf", "no_such_run",
                                   "trained_model_dir", str(tmp_path / "m"),
                                   "record_dir", str(tmp_path / "r")])
    with pytest.raises(FileNotFoundError, match="init_aninerf"):
        t_engine.run_train(cfg, "cpu")
    assert not (tmp_path / "m").exists() and not (tmp_path / "r").exists()


def test_port_checkpoint_reads_in_jax(monkeypatch, tmp_path, cfgs, params,
                                      datasets, jax_side):
    """The port writes a stage-2 checkpoint after two steps; JAX's
    load_checkpoint with the AnimationTrainer's templates restores its
    params and its masked Adam state."""
    FixedDraws(4).patch(monkeypatch)
    trainer = port_trainer(cfgs[1], params)
    for index in (1, 5):
        trainer.train_step(batches(datasets, index)[1])
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 0,
                    trainer.step, {"step": 2}, latest=True)
    st = jax_side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path), st.params, st.opt_state)
    assert (epoch, step, rec) == (0, 2, {"step": 2})
    for k, v in port_params(trainer).items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    assert (jax.tree_util.tree_structure(j_opt)
            == jax.tree_util.tree_structure(st.opt_state))
    _, (adam, sched) = j_opt.inner_states["train"].inner_state
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    assert int(adam.count) == int(sched.count) == count == 2
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(aninerf_param_tree(mine))
        got = leaves(theirs)
        assert set(got) == {k for k in want if trained_leaf(k)}
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
            assert np.abs(v).max() > 0, k


def test_jax_checkpoint_resumes_in_port(monkeypatch, tmp_path, cfgs, params,
                                        datasets, jax_side):
    """JAX writes after a step; the port restores its params, the Adam
    state of the trained field (none for the frozen ones) and the
    counters."""
    FixedDraws(6).patch(monkeypatch)
    jb, _ = batches(datasets, 2)
    state, _ = jax_side.trainer._train_step(jax_side.state0, jb,
                                            jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = port_trainer(cfgs[1], params)
    out = load_checkpoint(str(tmp_path), trainer.model, trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    for k, v in port_params(trainer).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    trained = list(trainer.model.novel_pose_bw.parameters())
    assert len(trainer.optimizer.state) == len(trained) == 19
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    _, (adam, _) = state.opt_state.inner_states["train"].inner_state
    assert count == int(adam.count) == 1
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in leaves(aninerf_param_tree(mine)).items():
            if trained_leaf(k):
                np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_stage2_checkpoint_names_and_round_trip(params):
    """The tracked stage-2 file strict-loads into the port's AniNeRF with
    its novel-pose field, under the names JAX's exporter writes, and the
    param tree comes back leaf for leaf."""
    from animatable_nerf_tpu_torch.models.aninerf import AniNeRF

    sd = aninerf_state_dict(params)
    model = AniNeRF(num_train_frames=2, num_eval_frames=2)
    model.load_state_dict(sd, strict=True)
    assert set(export_aninerf(params)) == set(model.state_dict())
    assert sum(k.startswith(TRAINED + ".") for k in sd) == 19
    back = leaves(aninerf_param_tree(dict(model.named_parameters())))
    assert back.keys() == leaves(params).keys()
    for k, v in leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        AniNeRF(num_train_frames=2).load_state_dict(sd, strict=True)
    stage1 = {k: v for k, v in sd.items() if not k.startswith(TRAINED + ".")}
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(stage1, strict=True)


# ------------------------------------------------- engine and CLIs
@pytest.fixture(scope="module")
def novel_pose_item(tmp_path_factory):
    """Two steps of the port's train_net (stage 2, on the CPU) from the
    tracked stage-2 weights; the checkpoint it writes, evaluated on item
    0 of the novel-pose test split (frame 2, view 3) by the JAX engine
    and by the port's CLI."""
    root = tmp_path_factory.mktemp("stage2")
    opts = OPTS + ["exp_name", "s2", "trained_model_dir", str(root / "model"),
                   "record_dir", str(root / "record"), "train.epoch", "1",
                   "ep_iter", "2", "fix_random", "True", "log_interval", "1"]
    tc = load_config(CFG, opts)
    write_fresh_start(ANIM_CKPT, tc.trained_model_dir)
    train_net.main(["--cfg_file", CFG, "--device", "cpu", *opts])
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc.trained_model_dir, "latest.flax"))

    eval_opts = ["test_novel_pose", "True", "exp_name", "s2",
                 "trained_model_dir", str(root / "model"), "eval_tile", "1024",
                 "N_samples", "16", "result_dir", str(root / "result")]
    jc = j_load_config(CFG, eval_opts, run_type="evaluate")
    jc.eval = True
    j_eng = j_engine.Engine(jc)
    j_ds = j_engine.make_dataset(jc, "test")
    j_params = j_eng.load_params(j_eng.init_params(jax.random.PRNGKey(0), j_ds))
    j_item = j_ds[0]
    j_out, _ = j_eng.render_item(j_params, j_item)
    j_psnr = ImageEvaluator(str(root / "jax")).evaluate(
        j_out["rgb_map"], np.asarray(j_item["rgb"]),
        np.asarray(j_item["mask_at_box"]), int(j_item["H"]),
        int(j_item["W"]))["psnr"]

    rendered, runs = [], []
    real_eval, real_render = t_engine.run_evaluate, t_engine.Engine.render_item

    def render(eng, item):
        out = real_render(eng, item)
        rendered.append((out[0], dict(eng.stats), eng))
        return out

    def one_item(cfg, device):
        runs.append((cfg, device, real_eval(cfg, device, max_items=1)))

    mp = pytest.MonkeyPatch()
    mp.setattr(t_engine.Engine, "render_item", render)
    mp.setattr(t_engine, "run_evaluate", one_item)
    try:
        t_run.main(["--type", "evaluate", "--cfg_file", CFG, "--device", "cpu",
                    *eval_opts])
    finally:
        mp.undo()
    return {"raw": raw, "jax": j_out, "jax_psnr": j_psnr, "item": j_item,
            "port": rendered, "runs": runs}


def test_train_net_stage2_writes_a_checkpoint(novel_pose_item):
    raw = novel_pose_item["raw"]
    assert int(raw["step"]) == 2 and int(raw["epoch"]) == 0
    inner = raw["opt_state"]["inner_states"]["train"]["inner_state"]
    assert int(inner["1"]["0"]["count"]) == 2
    assert TRAINED in raw["params"]["params"]


def test_novel_pose_item_matches_jax(novel_pose_item):
    """The JAX engine's test_novel_pose render of the port's checkpoint
    against the port's CLI: maps, counts and PSNR."""
    (out, stats, eng), = novel_pose_item["port"]
    (cfg, device, res), = novel_pose_item["runs"]
    assert device == "cpu" and eng.novel_pose and cfg.test_novel_pose
    item = novel_pose_item["item"]
    assert int(item["frame_index"]) == 2 and int(item["cam_ind"]) == 3
    assert int(item["latent_index"]) == 1 and int(item["bw_latent_index"]) == 0
    j_out = novel_pose_item["jax"]
    for k in ("rgb_map", "acc_map"):
        assert out[k].shape == j_out[k].shape, k
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], j_out[k], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5
    assert stats["tiles"] > 1 and stats["n_survivors"] > stats["tiles"]
    got = res["items"][0]
    assert got["n_survivors"] == stats["n_survivors"]
    assert abs(got["psnr"] - novel_pose_item["jax_psnr"]) <= PSNR_TOL_DB


def test_novel_pose_warps_through_the_novel_pose_field(novel_pose_item):
    """The novel-pose frame holds bw_latent_index and warps through
    novel_pose_bw: swapping that field's latent rows changes the render."""
    (_, _, eng), = novel_pose_item["port"]
    item = novel_pose_item["item"]
    frame = eng._device_frame(item)
    assert frame["novel_pose"] and frame["bw_latent_index"] == 0
    pts = torch.tensor(np.random.RandomState(0).uniform(-0.3, 0.3, (50, 3)),
                       dtype=torch.float32)
    smpl = torch.full((50, 24), 1.0 / 24)
    with torch.no_grad():
        got = eng.model.pose_blend_weights(pts, smpl, frame)
        want = eng.model.novel_pose_bw.blend_weights(pts, smpl, 0)
        stage1 = eng.model.blend_weights(pts, smpl, 2)
    assert torch.equal(got, want) and not torch.equal(got, stage1)


@pytest.mark.parametrize("cfg_path,opts,run_type", [
    ("configs/synthetic_sdf_pdf.yaml", ["test_novel_pose", "True"], "evaluate"),
    ("configs/synthetic_nerf_pdf.yaml", ["test_novel_pose", "True"], "evaluate"),
    ("configs/synthetic_neus_pdf.yaml", ["test_novel_pose", "True"], "evaluate"),
    ("configs/synthetic_sdf_pdf.yaml", ["aninerf_animation", "True"], "train")])
def test_pdf_families_novel_pose_refused_before_any_work(cfg_path, opts,
                                                         run_type, tmp_path):
    """The displacement-field families' stage 2 and test_novel_pose
    raise before any work: the JAX package's own paths fail for them."""
    cfg = load_config(cfg_path, opts + ["trained_model_dir", str(tmp_path / "m"),
                                        "record_dir", str(tmp_path / "r")],
                      run_type=run_type)
    with pytest.raises(NotImplementedError, match="no working path"):
        if run_type == "train":
            t_engine.run_train(cfg, "cpu")
        else:
            t_engine.Engine(cfg, "cpu")
    assert not (tmp_path / "m").exists() and not (tmp_path / "r").exists()
