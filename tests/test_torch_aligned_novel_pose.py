"""The aligned families' novel poses on the CPU: the port against the JAX
package (animatable_nerf_tpu/models/aligned.py :161-205, :446-538;
train/animation.py) on the same inputs and the same weights, composed
from the tracked files (compat/compose.py `compose_novel_pose`:
configs/synthetic_aligned_<f>_novel_pose.yaml, two training frames and
the novel-pose window on frames 2-3), at full widths with N_ANIM points
a stage-2 branch and tiles of 64 rays of 16 samples.

JAX draws its stage-2 points with jax.random, which the port cannot
reproduce, so both packages' `uniform_box_points` are patched to return
the same seeded numpy points (tests/test_torch_animation.py
`FixedDraws`); nothing in either package changes for it.

Tolerances:
  * A novel-pose tile against JAX's `_eval_compacted(novel_pose=True)`:
    rgb, acc and depth within MAP_TOL = 1e-4 (depth relative to its
    largest value), the candidates JAX's pass-1 count (the tiles have no
    point within 1e-5 of the threshold, so the KNN blend by differences
    against JAX's matmul form moves none).
  * The consistency pairs: pbw and tbw within PAIR_TOL = 1e-4 (chained
    8x256 stacks and an LBS inverse in float32), the selections equal,
    on every row but those where a KNN prior of the branch differs from
    JAX's by more than KNN_VALUE_TOL = 1e-5: a near-tie of the 5th
    neighbour, which the port's distances by differences and JAX's
    matmul form break differently (at most MAX_TIE_ROWS = 4 of the
    N_ANIM rows; LBW's pose branch had 2, its prior differing by 2e-3).
  * The stage-2 loss and stats: rtol LOSS_RTOL = 1e-4; `novel_pose_bw`'s
    gradient per leaf within GRAD_REL = 1e-2 of its largest entry (the
    canonical points' rounding through the positional encoding, as
    tests/test_torch_animation.py). No other parameter gets a gradient.
  * One step: the trained entries whose JAX gradient is resolved (over
    100 x its tolerance) within 1e-6 of JAX, every entry within 2 lr;
    every frozen leaf bit-identical to the start in both packages.
  * Three steps: each step's loss within LOSS_RTOL of JAX's; the port's
    Adam fed JAX's gradients within 1e-6 of JAX's optimizer; the frozen
    leaves bit-identical.
  * The trees, the starts, the checkpoints and the dataset's latent:
    exact.
  * The slice's item (the port's CLI after two stage-2 steps of its
    train_net, against the JAX engine): maps within MAP_TOL, the counts
    equal, |dPSNR| <= PSNR_TOL_DB = 0.01 dB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_animation import FixedDraws

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.compat.torch_export import EXPORTERS
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.knn import (
    sample_blend_closest_points as j_sample_blend_closest_points,
)
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
from animatable_nerf_tpu_torch.compat.compose import (
    FAMILIES,
    NOVEL_POSE_FIELD,
    compose_novel_pose,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator
from animatable_nerf_tpu_torch.models import aligned
from animatable_nerf_tpu_torch.train import animation as t_animation
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    param_codec,
    save_checkpoint,
    write_start,
)
from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

N_ANIM = 384
N_RAND = 64
N_SAMPLES = 16
TILE_RAYS = 64
OPTS = ["aninerf_animation", "True", "n_anim_samples", str(N_ANIM),
        "N_rand", str(N_RAND), "N_samples", str(N_SAMPLES)]
EVAL_OPTS = ["test_novel_pose", "True", "knn_grid_res", "24"]
MAP_TOL = 1e-4
PAIR_TOL = 1e-4
KNN_VALUE_TOL = 1e-5
MAX_TIE_ROWS = 4
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_RESOLVED_TOL = 1e-6
STEPS_PARAM_TOL = 1e-6
PSNR_TOL_DB = 0.01
LR = 5e-4
TRAINED = "novel_pose_bw"
N_TRAINED = 19  # the field's leaves: latent, 9 dense layers' kernel and bias


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread (its
    module fixtures too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    return f"configs/synthetic_aligned_{family}_novel_pose.yaml"


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def trained_leaf(key):
    return f"'{TRAINED}'" in key


def as_flax(tree):
    """A param tree as flax holds it: the NeRF network's layers a list
    (a msgpack file keys them "0", "1", ...)."""
    inner = dict(tree["params"])
    layers = inner["nerf_network"]["layers"]
    if isinstance(layers, dict):
        inner["nerf_network"] = {
            "layers": [layers[str(i)] for i in range(len(layers))]}
    return {"params": inner}


# ------------------------------------------------------ novel-pose eval
@pytest.fixture(scope="module", params=FAMILIES)
def eval_setup(request):
    """One family's engines on the novel-pose test item 0 (frame 2, view
    3) with the distance grid at 24^3, the flax model's parameter
    shapes (of its stage-2 init, which builds every field), the
    composed weights, JAX's novel-pose tile with every point
    within its capacity, and a tile of the item's rays."""
    family = request.param
    jc = j_load_config(cfg_file(family), EVAL_OPTS, run_type="evaluate")
    tc = load_config(cfg_file(family), EVAL_OPTS, run_type="evaluate")
    jc.eval = tc.eval = True
    j_eng = j_engine.Engine(jc)
    j_item = j_engine.make_dataset(jc, "test")[0]
    j_frame = j_eng._device_frame(j_item)
    shapes = jax.eval_shape(lambda: j_eng.model.init(
        jax.random.PRNGKey(3), jnp.zeros((8, N_SAMPLES, 3)), jnp.ones((8, 3)),
        jnp.ones((8, N_SAMPLES)), j_frame, train=True, novel_pose=True))
    params = as_flax(compose_novel_pose(family))
    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params(params)
    t_item = t_engine.make_dataset(tc, "test")[0]
    jm = j_eng.model.clone(eval_keep_frac=1.0)
    apply = jax.jit(lambda p, w, v, z, f: jm.apply(
        p, w, v, z, f, train=False, novel_pose=True, precomposite=True))
    # rays on the body (the background's rgb is masked to 0), spread
    on_body = np.nonzero(np.asarray(j_item["rgb"]).sum(-1) > 0)[0]
    pick = on_body[::max(1, len(on_body) // TILE_RAYS)][:TILE_RAYS]
    rays = {k: np.asarray(j_item[k], np.float32)[pick]
            for k in ("ray_o", "ray_d", "near", "far")}
    return {"family": family, "j_item": j_item, "t_item": t_item,
            "shapes": shapes, "params": params, "apply": apply,
            "j_frame": j_frame, "t_eng": t_eng,
            "t_frame": t_eng._device_frame(t_item), "rays": rays}


def test_composed_novel_pose_tree_loads_in_both_packages(eval_setup):
    """compose_novel_pose's tree has exactly the leaves and shapes of the
    flax model's novel-pose init (`novel_pose_bw` for LBW and LBWPDF
    only); the port strict-loads it under the JAX exporter's names and
    writes the same tree back; a stray name raises."""
    family = eval_setup["family"]
    got = leaves(eval_setup["params"])
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(eval_setup["shapes"])}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert any(trained_leaf(k) for k in got) == (family in NOVEL_POSE_FIELD)
    model = eval_setup["t_eng"].model
    to_state, to_tree = param_codec(model)
    state = to_state(eval_setup["params"])
    ref = EXPORTERS[f"aligned_{family}"](eval_setup["params"]["params"])
    if family == "pbw":  # the unread frame-latent table
        ref["bw_latent.weight"] = np.zeros((3, 128), np.float32)
    assert set(state) == set(ref) == set(model.state_dict())
    assert sum(k.startswith(TRAINED + ".") for k in state) == (
        N_TRAINED if family in NOVEL_POSE_FIELD else 0)
    for k, v in ref.items():
        np.testing.assert_array_equal(
            state[k].numpy(), np.asarray(v).reshape(state[k].shape), err_msg=k)
    back = leaves(as_flax(to_tree(dict(model.named_parameters()))))
    assert set(back) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        to_tree({**dict(model.named_parameters()),
                 "novel_pose_bw.stray.weight": state[k]})


def test_novel_pose_tile_matches_jax(eval_setup):
    """One tile of the novel-pose item against JAX's novel-pose tile:
    maps and candidates. LBW and LBWPDF warp through `novel_pose_bw` at
    the frame's bw_latent_index (the render differs without it); PBW
    and SMPL through their stage-1 deform."""
    family = eval_setup["family"]
    item = eval_setup["t_item"]
    assert int(item["frame_index"]) == 2 and int(item["cam_ind"]) == 3
    assert int(item["latent_index"]) == 1 and int(item["bw_latent_index"]) == 0
    rays = eval_setup["rays"]
    z = stratified_z_vals(torch.tensor(rays["near"]), torch.tensor(rays["far"]),
                          N_SAMPLES)
    wpts = z_vals_to_pts(torch.tensor(rays["ray_o"]),
                         torch.tensor(rays["ray_d"]), z)
    ref = eval_setup["apply"](eval_setup["params"], wpts.numpy(),
                              rays["ray_d"], z.numpy(), eval_setup["j_frame"])
    assert not bool(ref["compact_overflow"])
    model, frame = eval_setup["t_eng"].model, eval_setup["t_frame"]
    assert frame["novel_pose"] and frame["bw_latent_index"] == 0
    got = model(wpts, torch.tensor(rays["ray_d"]), z, frame)
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        scale = max(1.0, np.abs(r).max()) if k == "depth_map" else 1.0
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert got["n_candidates"] == int(np.asarray(ref["compact_count"]).sum())
    assert got["n_survivors"] > 300 and float(got["acc_map"].max()) > 0.5
    stage1 = model(wpts, torch.tensor(rays["ray_d"]), z,
                   {**frame, "novel_pose": False})
    moved = not torch.equal(stage1["rgb_map"], got["rgb_map"])
    assert moved == (family in NOVEL_POSE_FIELD)


# ------------------------------------------------------------ stage 2
class Side:
    """One family's stage-2 configs, composed weights, train datasets
    and JAX's AnimationTrainer from those weights with a fresh
    optimizer state."""

    def __init__(self, family):
        self.family = family
        self.jc = j_load_config(cfg_file(family), OPTS)
        self.tc = load_config(cfg_file(family), OPTS)
        self.params = as_flax(compose_novel_pose(family))
        self.datasets = (j_engine.make_dataset(self.jc, "train"),
                         t_engine.make_dataset(self.tc, "train"))
        self.model = j_engine.make_model(self.jc)
        self.trainer = j_animation.AnimationTrainer(self.jc, self.model)
        self.init = self.trainer.init_state(jax.random.PRNGKey(42),
                                            self.batches(0)[0])
        p = jax.tree_util.tree_map(jnp.asarray, self.params)
        self.state0 = TrainState(p, self.trainer.tx.init(p), jnp.asarray(0))
        # not jitted: the patched draws hand JAX numpy points
        self.step = self.trainer._train_step
        self.grad = jax.value_and_grad(
            lambda p, fb: j_animation.animation_loss(
                self.model, p, fb, jax.random.PRNGKey(0), N_ANIM),
            has_aux=True)

    def batches(self, index, seed=0):
        """Item `index` of both stage-2 train splits (frames 2-3)."""
        j_ds, t_ds = self.datasets
        j_ds._rng = np.random.RandomState(seed)
        t_ds._rng = np.random.RandomState(seed)
        return (j_stack_batch([j_collate_rays(j_ds[index], N_RAND)]),
                stack_batch([collate_rays(t_ds[index], N_RAND)]))

    def loss_grad(self, jb, params):
        fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
        (loss, stats), grads = self.grad(params, fb)
        return float(loss), {k: float(v) for k, v in stats.items()}, grads

    def apply(self, state, grads):
        updates, opt_state = self.trainer.tx.update(grads, state.opt_state,
                                                    state.params)
        return TrainState(jax.tree_util.tree_map(lambda p, u: p + u,
                                                 state.params, updates),
                          opt_state, state.step + 1)

    def port_trainer(self):
        model = t_engine.make_model(self.tc)
        model.load_state_dict(param_codec(model)[0](self.params), strict=True)
        return t_animation.AnimationTrainer(self.tc, model, "cpu")

    @staticmethod
    def port_tree(model, named):
        return leaves(as_flax(param_codec(model)[1](named)))

    def port_params(self, trainer):
        return self.port_tree(trainer.model,
                              dict(trainer.model.named_parameters()))

    def port_grads(self, trainer):
        model = trainer.model
        return {k: v for k, v in self.port_tree(model, {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}).items() if trained_leaf(k)}

    def set_grads(self, trainer, j_grads):
        named = param_codec(trainer.model)[0](j_grads)
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                p.grad = named[name].reshape(p.shape).clone()


@pytest.fixture(scope="module", params=NOVEL_POSE_FIELD)
def side(request):
    return Side(request.param)


def knn_tie_rows(monkeypatch, fn):
    """fn() with the aligned model's KNN calls recorded; returns (fn's
    result, the rows of the calls' points where the port's prior
    differs from JAX's XLA `sample_blend_closest_points` on the same
    points by more than KNN_VALUE_TOL: near-ties of the 5th neighbour,
    which the port's distances by differences and JAX's matmul form
    break differently)."""
    real, calls = aligned.sample_blend_closest_points, []

    def recording(src, ref, values, *args, **kwargs):
        out = real(src, ref, values, *args, **kwargs)
        calls.append((src.detach(), ref, values,
                      [o.detach() for o in out]))
        return out

    monkeypatch.setattr(aligned, "sample_blend_closest_points", recording)
    result = fn()
    monkeypatch.setattr(aligned, "sample_blend_closest_points", real)
    rows = set()
    for src, ref, values, (vals, wd) in calls:
        j_vals, j_wd = j_sample_blend_closest_points(
            jnp.asarray(src.numpy()), jnp.asarray(ref.numpy()),
            jnp.asarray(values.numpy()))
        diff = np.maximum(np.abs(vals.numpy() - np.asarray(j_vals)).max(-1),
                          np.abs(wd.numpy() - np.asarray(j_wd)).max(-1))
        rows |= set(np.nonzero(diff > KNN_VALUE_TOL)[0].tolist())
    return result, rows


def test_consistency_pairs_match_jax(monkeypatch, side):
    """Both branches on seeded points of the frame's boxes: the pairs
    and the selections, off the rows where a KNN prior of the branch
    meets a near-tie (at most MAX_TIE_ROWS). LBWPDF's config sets
    norm_th 0.05: its forward filter stays at 0.1 and its stage-2
    selection reads 0.05 in both packages, which selects other points
    than 0.1 would."""
    jb, tb = side.batches(4)
    fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
    trainer = side.port_trainer()
    model = trainer.model
    frame = trainer._frame({k: v[0] for k, v in tb.items()})
    if side.family == "lbw_pdf":
        assert side.tc.norm_th == side.model.norm_th == 0.05
        assert model.stage2_norm_th == 0.05
        assert model.norm_th == side.model._filter_th() == 0.1
    draws = FixedDraws(5)
    wpts = draws.points("jax", fb["wbounds"], N_ANIM)
    tpts = torch.tensor(draws.points("jax", fb["tbounds"], N_ANIM))
    ppts = world_points_to_pose_points(torch.tensor(wpts), frame["R"],
                                       frame["Th"])
    m, p = side.model, side.state0.params
    want = (m.apply(p, jnp.asarray(ppts.numpy()), fb,
                    method=m.animation_from_pose),
            m.apply(p, jnp.asarray(tpts.numpy()), fb,
                    method=m.animation_from_canonical))
    got = [knn_tie_rows(monkeypatch,
                        lambda: model.animation_from_pose(ppts, frame)),
           knn_tie_rows(monkeypatch,
                        lambda: model.animation_from_canonical(tpts, frame))]
    for (jp, jt, jsel), ((tp, tt, tsel), ties) in zip(want, got):
        assert len(ties) <= MAX_TIE_ROWS, ties
        rest = np.setdiff1d(np.arange(N_ANIM), sorted(ties))
        for g, w, name in ((tp, jp, "pbw"), (tt, jt, "tbw")):
            g = g.detach().numpy()
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g[rest], np.asarray(w)[rest], rtol=0,
                                       atol=PAIR_TOL, err_msg=name)
        np.testing.assert_array_equal(tsel.numpy()[rest],
                                      np.asarray(jsel)[rest])
        assert int(tsel.sum()) > 1
    if side.family == "lbw_pdf":
        model.stage2_norm_th = 0.1
        at_01 = (model.animation_from_pose(ppts, frame)[2],
                 model.animation_from_canonical(tpts, frame)[2])
        assert any(not torch.equal(a, g[0][2]) for a, g in zip(at_01, got))


def test_stage2_loss_and_gradient_match_jax(monkeypatch, side):
    """The stage-2 loss of one frame and `novel_pose_bw`'s gradient
    against jax.grad of JAX's animation_loss on the same points."""
    FixedDraws(1).patch(monkeypatch)
    jb, tb = side.batches(1)
    j_loss, j_stats, j_grads = side.loss_grad(jb, side.state0.params)
    trainer = side.port_trainer()
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
    got = side.port_grads(trainer)
    assert set(got) == set(want) and len(want) == N_TRAINED
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        assert np.abs(got[k] - w).max() <= GRAD_REL * np.abs(w).max(), k


def test_stage2_step_matches_jax(monkeypatch, side):
    """One step of AnimationTrainer from the composed weights and a
    fresh Adam: the loss, the trained field, every frozen leaf as it
    was in both packages."""
    draws = FixedDraws(2).patch(monkeypatch)
    jb, tb = side.batches(3)
    with draws.again():
        _, _, j_grads = side.loss_grad(jb, side.state0.params)
    j_state, j_stats = side.step(side.state0, jb, jax.random.PRNGKey(0))
    trainer = side.port_trainer()
    stats = trainer.train_step(tb)
    np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                               rtol=LOSS_RTOL)
    p0, want_g = leaves(side.state0.params), leaves(j_grads)
    got, want = side.port_params(trainer), leaves(j_state.params)
    assert set(got) == set(want)
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


def test_stage2_three_steps_match_jax(monkeypatch, side):
    """Three steps on frames 2, 3, 2: each step's loss; the port's Adam
    fed JAX's gradients against JAX's optimizer; the frozen leaves."""
    draws = FixedDraws(3).patch(monkeypatch)
    trainer = side.port_trainer()
    fed = side.port_trainer()
    state = applied = side.state0
    for index in (0, 4, 2):
        jb, tb = side.batches(index, index)
        state, j_stats = side.step(state, jb, jax.random.PRNGKey(0))
        stats = trainer.train_step(tb)
        np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                                   rtol=LOSS_RTOL)
        with draws.again():
            _, _, j_grads = side.loss_grad(jb, applied.params)
        applied = side.apply(applied, j_grads)
        side.set_grads(fed, j_grads)
        fed.apply_gradients()
    assert trainer.step == trainer.updates == int(state.step) == 3
    p0, want = leaves(side.state0.params), leaves(applied.params)
    for k, g in side.port_params(fed).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)
    for params in (side.port_params(trainer), leaves(state.params)):
        for k, v in params.items():
            if not trained_leaf(k):
                np.testing.assert_array_equal(v, p0[k], err_msg=k)
    assert all(np.isfinite(v).all() for v in side.port_params(trainer).values())


def write_stage1(root, family):
    """The composed stage-1 tree where the config's `init_aninerf` finds
    it, beside the run's directory under `root`; returns the opts that
    put the run there."""
    write_start(str(root / "deform" / f"synthetic_aligned_{family}_2f"),
                compose_novel_pose(family, False))
    return ["trained_model_dir", str(root)]


def test_stage2_start_is_the_stage1_tree(tmp_path, side):
    """`initial_model` (the start `write_initial_start` writes): every
    leaf of the composed stage-1 file of `init_aninerf`, and
    `novel_pose_bw` at its seeded init; JAX's partial load of that
    directory into its own init replaces the same leaves."""
    cfg = load_config(cfg_file(side.family),
                      OPTS + write_stage1(tmp_path, side.family))
    init_dir = t_engine.init_aninerf_dir(cfg)
    assert init_dir == str(tmp_path / "deform"
                           / f"synthetic_aligned_{side.family}_2f")
    model = t_engine.initial_model(cfg)
    got = side.port_tree(model, dict(model.named_parameters()))
    stage1 = leaves(as_flax(compose_novel_pose(side.family, False)))
    want = leaves(j_load_params_partial(init_dir, side.init.params,
                                        strict=False))
    assert set(got) == set(want) == set(stage1) | {
        k for k in got if trained_leaf(k)}
    for k, v in got.items():
        if trained_leaf(k):
            assert not np.array_equal(v, leaves(side.params)[k]), k
        else:
            np.testing.assert_array_equal(v, stage1[k], err_msg=k)
            np.testing.assert_array_equal(want[k], stage1[k], err_msg=k)
    again = t_engine.initial_model(cfg)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_stage2_checkpoints_both_ways(monkeypatch, tmp_path, side):
    """The port writes a stage-2 checkpoint after two steps; JAX's
    load_checkpoint with the AnimationTrainer's templates restores its
    params and its masked Adam state (the frozen NeRF network's layer
    list one masked node). JAX writes after a step; the port restores
    its params, the trained field's Adam state and the counters."""
    FixedDraws(4).patch(monkeypatch)
    trainer = side.port_trainer()
    for index in (1, 5):
        trainer.train_step(side.batches(index)[1])
    save_checkpoint(str(tmp_path / "port"), trainer.model, trainer.optimizer,
                    0, trainer.step, {"step": 2}, latest=True)
    st = side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path / "port"), st.params, st.opt_state)
    assert (epoch, step, rec) == (0, 2, {"step": 2})
    for k, v in side.port_params(trainer).items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    assert (jax.tree_util.tree_structure(j_opt)
            == jax.tree_util.tree_structure(st.opt_state))
    _, (adam, sched) = j_opt.inner_states["train"].inner_state
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    assert int(adam.count) == int(sched.count) == count == 2
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = side.port_tree(trainer.model, mine)
        got = leaves(theirs)
        assert set(got) == {k for k in want if trained_leaf(k)}
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
            assert np.abs(v).max() > 0, k

    jb, _ = side.batches(2)
    state, _ = side.step(st, jb, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path / "jax"), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = side.port_trainer()
    out = load_checkpoint(str(tmp_path / "jax"), trainer.model,
                          trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    for k, v in side.port_params(trainer).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    assert len(trainer.optimizer.state) == N_TRAINED
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    _, (adam, _) = state.opt_state.inner_states["train"].inner_state
    assert count == int(adam.count) == 1
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in side.port_tree(trainer.model, mine).items():
            if trained_leaf(k):
                np.testing.assert_array_equal(v, want[k], err_msg=k)


# ------------------------------------------------ the dataset's latent
def test_nearest_training_frame_matches_jax(tmp_path):
    """Under test_novel_pose the item's latent is the nearest training
    frame's by the posed joints in world space: on a copy of the capsule
    root with lbs/training_joints.npy (frame 3's joints, then frame
    2's, each moved by a centimetre), both packages give frame 2 latent
    1 and frame 3 latent 0; without the file, num_train_frame - 1."""
    src = os.path.abspath("data/synthetic/capsule")
    root = tmp_path / "capsule"
    root.mkdir()
    for name in os.listdir(src):
        if name != "lbs":
            os.symlink(os.path.join(src, name), root / name)
    (root / "lbs").mkdir()
    for name in os.listdir(os.path.join(src, "lbs")):
        os.symlink(os.path.join(src, "lbs", name), root / "lbs" / name)
    opts = ["test_novel_pose", "True"] + [
        x for split in ("train", "test") for x in (
            f"{split}_dataset.data_root", str(root),
            f"{split}_dataset.ann_file", str(root / "annots.npy"))]
    jc = j_load_config(cfg_file("lbw"), opts, run_type="evaluate")
    tc = load_config(cfg_file("lbw"), opts, run_type="evaluate")
    jc.eval = tc.eval = True
    ds = t_engine.make_dataset(tc, "test")
    assert ds.training_joints is None
    assert [int(ds[i]["latent_index"]) for i in range(len(ds))] == [1, 1]
    joints = {}
    for i in (2, 3):
        wpts, _, _, poses, _, Th, R = ds._pose_inputs(i)
        joints[i] = ds._posed_joints(poses, Th, R)
    rng = np.random.RandomState(0)
    table = np.stack([joints[3], joints[2]]) + rng.normal(0, 0.01, (2, 24, 3))
    np.save(root / "lbs" / "training_joints.npy", table.astype(np.float32))
    datasets = (j_engine.make_dataset(jc, "test"), t_engine.make_dataset(tc, "test"))
    got = [[(int(d[i]["frame_index"]), int(d[i]["latent_index"]),
             int(d[i]["bw_latent_index"])) for i in range(len(d))]
           for d in datasets]
    assert got[0] == got[1] == [(2, 1, 0), (3, 0, 1)]
    for i in (2, 3):
        assert (datasets[1].nearest_training_frame(joints[i])
                == datasets[0].nearest_training_frame(joints[i]) == 3 - i)
    # read only for novel poses
    plain = t_engine.make_dataset(load_config(cfg_file("lbw"), opts[2:],
                                              run_type="evaluate"), "test")
    assert plain.training_joints is None


# ----------------------------------------------- the slice end to end
@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Two stage-2 steps of the port's train_net (AlignedLBW, on the CPU)
    from the common start `write_initial_start` writes; the checkpoint
    it writes evaluated on the novel-pose item 0 by the JAX engine and by
    the port's CLI."""
    root = tmp_path_factory.mktemp("aligned_stage2")
    opts = OPTS + ["exp_name", "s2", *write_stage1(root, "lbw"),
                   "record_dir", str(root / "record"), "train.epoch", "1",
                   "ep_iter", "2", "fix_random", "True", "resume", "True",
                   "log_interval", "1"]
    tc = load_config(cfg_file("lbw"), opts)
    t_engine.write_initial_start(tc)
    train_net.main(["--cfg_file", cfg_file("lbw"), "--device", "cpu", *opts])
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc.trained_model_dir, "latest.flax"))

    eval_opts = EVAL_OPTS + ["exp_name", "s2", "trained_model_dir",
                             str(root), "eval_tile", "1024",
                             "N_samples", str(N_SAMPLES), "result_dir",
                             str(root / "result")]
    jc = j_load_config(cfg_file("lbw"), eval_opts, run_type="evaluate")
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
        t_run.main(["--type", "evaluate", "--cfg_file", cfg_file("lbw"),
                    "--device", "cpu", *eval_opts])
    finally:
        mp.undo()
    return {"raw": raw, "start": compose_novel_pose("lbw", False),
            "jax": j_out, "jax_psnr": j_psnr, "port": rendered, "runs": runs}


def test_train_net_stage2_writes_a_checkpoint(slice_run):
    """Two steps in JAX's stage-2 layout: the novel-pose field moved, the
    stage-1 leaves as the start's."""
    raw = slice_run["raw"]
    assert int(raw["step"]) == 2 and int(raw["epoch"]) == 0
    inner = raw["opt_state"]["inner_states"]["train"]["inner_state"]
    assert int(inner["1"]["0"]["count"]) == 2
    assert inner["1"]["0"]["mu"]["params"]["nerf_network"]["layers"] == {}
    params = leaves(as_flax(raw["params"]))
    start = leaves(as_flax(slice_run["start"]))
    assert sum(trained_leaf(k) for k in params) == N_TRAINED
    for k, v in start.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)


def test_novel_pose_item_matches_jax(slice_run):
    """The JAX engine's test_novel_pose render of the port's checkpoint
    against the port's CLI: maps, counts and PSNR."""
    (out, stats, eng), = slice_run["port"]
    (cfg, device, res), = slice_run["runs"]
    assert device == "cpu" and eng.novel_pose and cfg.test_novel_pose
    j_out = slice_run["jax"]
    for k in ("rgb_map", "acc_map"):
        assert out[k].shape == j_out[k].shape and np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], j_out[k], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5
    assert stats["tiles"] > 1 and stats["n_survivors"] > stats["tiles"]
    got = res["items"][0]
    assert got["frame_index"] == 2 and got["n_survivors"] == stats["n_survivors"]
    assert abs(got["psnr"] - slice_run["jax_psnr"]) <= PSNR_TOL_DB
