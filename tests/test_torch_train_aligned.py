"""The aligned families' training on the CPU: the port against the JAX
package on the same numpy-seeded inputs and the same weights (composed
from the tracked checkpoints, compat/compose.py), at full widths (8x256
blend-weight fields and displacement field, NeRF-PDF's 9-layer head)
with 64 rays of 16 samples and `perturb 0`; and K2's differentiable form
against jax.grad of JAX's XLA `sample_blend_closest_points`.

Tolerances (those of tests/test_torch_train_pdf_families.py, whose
reasons hold here):
  * K2's gradient: the values within 1e-5 (the port's distances by
    differences, JAX's in the matmul form), each input's gradient
    within KNN_GRAD_REL = 1e-3 of its largest entry (the matmul form's
    cancellation, relative 1e-3 on the distance of a query 0.01 from a
    vertex, enters the weights' derivative); a query on a vertex (exact
    dyadic coordinates, so both forms give a distance of exactly 0): a
    finite gradient, equal to JAX's within the same tolerance.
  * The dense train forward: the filter masks may differ only on points
    whose weighted KNN distance lies within FLIP_BAND of the threshold,
    at most MAX_FLIPS of them; raw, the maps, and on the points both
    keep pbw, tbw and resd within MAP_TOL = 1e-4; bw_mask equal off the
    flips.
  * Loss and stats of a step: rtol LOSS_RTOL = 1e-4. Gradients per leaf:
    max |d| <= GRAD_REL x max |g| with GRAD_REL = 1e-2, and the whole
    gradient within GRAD_L2 = 1e-3 of its L2 norm. A leaf may exceed
    GRAD_REL only where float32 cannot resolve it: where the port's own
    gradient of the leaf moves by at least half that difference when the
    rays' directions move by one ulp. The learned field's first and last
    layers are such leaves on LBW's step from item 4: their gradient is
    tiny (5e-6), and one ulp moves `bw_linears.0.bias` by 1.26e-2 of its
    largest entry, as much as it differs from JAX's (1.24e-2; measured).
    Adam's update:
    from JAX's gradient within 1e-7 of JAX's optimizer or one float32
    ulp of the parameter; from the port's own, within 1e-6 where the
    gradient's direction is resolved (the JAX gradient over 100 x its
    tolerance), else within 2 lr.
  * Three steps: the first step's loss within LOSS_RTOL of
    `Trainer._train_step`'s; three updates of the port's Adam from JAX's
    gradients within 1e-6 of JAX's optimizer, and at those weights each
    step's loss within LOSS_RTOL of JAX's; the port's own three steps
    within 2 lr a step of `Trainer._train_step`'s weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.knn import (
    sample_blend_closest_points as j_sample_blend_closest_points,
)
from animatable_nerf_tpu.render.renderer import render_rays as j_render_rays
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from animatable_nerf_tpu.train.losses import compute_losses as j_compute_losses
from animatable_nerf_tpu.train.trainer import (
    RAY_KEYS,
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.compose import FAMILIES, compose_aligned
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.ops import knn
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    param_codec,
    save_checkpoint,
)
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
KNN_VALUE_TOL = 1e-5
KNN_GRAD_REL = 1e-3
FLIP_BAND = 1e-5
MAX_FLIPS = 4
MAP_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
GRAD_L2 = 1e-3
ADAM_SAME_GRAD_TOL = 1e-7
ULP = 2.0 ** -23  # one float32 ulp, relative
ADAM_RESOLVED_TOL = 1e-6
STEPS_PARAM_TOL = 1e-6
LR = 5e-4
# the stats each family's loss reports
STATS = {"lbw": {"bw_loss", "img_loss", "loss"},
         "pbw": {"bw_loss", "img_loss", "loss"},
         "smpl": {"img_loss", "loss"},
         "lbw_pdf": {"offset_loss", "bw_loss", "img_loss", "loss"}}


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    return f"configs/synthetic_aligned_{family}.yaml"


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_flax(tree):
    """The NeRF network's layers as flax holds them, a list."""
    inner = dict(tree["params"])
    layers = inner["nerf_network"]["layers"]
    if isinstance(layers, dict):
        inner["nerf_network"] = {
            "layers": [layers[str(i)] for i in range(len(layers))]}
    return {"params": inner}


# ------------------------------------------------- K2 with a gradient
def knn_case(seed):
    """Queries around dyadic vertices (multiples of 2^-6, so |s - r|^2
    and s.s - 2 s.r + r.r are exact in float32 where s = r), with two
    queries exactly on a vertex."""
    rng = np.random.RandomState(seed)
    ref = (rng.randint(-48, 48, (300, 3)) / 64.0).astype(np.float32)
    src = (ref[rng.randint(0, 300, 120)]
           + rng.uniform(-0.15, 0.15, (120, 3))).astype(np.float32)
    src[7], src[50] = ref[11], ref[200]
    values = rng.dirichlet(np.ones(24), 300).astype(np.float32)
    return src, ref, values


@pytest.mark.parametrize("seed", [0, 1])
def test_differentiable_knn_matches_jax_grad(seed):
    """The vjp of the blend and the weighted distance with respect to the
    queries, the vertices and the values against jax.grad of JAX's XLA
    `sample_blend_closest_points`; zero and finite at a query on a
    vertex, whose own distance carries no gradient (safe_sqrt)."""
    src, ref, values = knn_case(seed)
    rng = np.random.RandomState(seed + 10)
    cot_v = rng.randn(120, 24).astype(np.float32)
    cot_d = rng.randn(120, 1).astype(np.float32)

    def j_loss(s, r, v):
        out, d = j_sample_blend_closest_points(s, r, v)
        return jnp.sum(out * cot_v) + jnp.sum(d * cot_d), (out, d)

    (_, (j_out, j_d)), j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True))(src, ref, values)
    ts, tr, tv = (torch.tensor(a, requires_grad=True)
                  for a in (src, ref, values))
    out, d = sample_blend_closest_points(ts, tr, tv)
    ((out * torch.tensor(cot_v)).sum() + (d * torch.tensor(cot_d)).sum()
     ).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=KNN_VALUE_TOL)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(j_d), rtol=0,
                               atol=KNN_VALUE_TOL)
    assert max(float(d[7].detach()), float(d[50].detach())) < 1e-6
    for got, want in zip((ts.grad, tr.grad, tv.grad), j_grads):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= KNN_GRAD_REL * np.abs(want).max()
    # the same values as the data-only launch, and its selection
    plain = knn.knn_blend(torch.tensor(src), torch.tensor(ref),
                          torch.tensor(values), indices=True)
    assert torch.equal(plain[0], out.detach()) and torch.equal(plain[1],
                                                               d.detach())
    assert plain[2].dtype == torch.int32 and plain[2].shape == (120, 5)
    assert int(plain[2][7, 0]) == 11 and int(plain[2][50, 0]) == 200


def test_knn_indices_and_nan_queries():
    """The selection is the k nearest, nearest first, ties to the lowest
    index; a NaN query selects -1 and its outputs stay NaN."""
    ref = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0],
                        [0, 0, 2], [3, 3, 3]])
    values = torch.eye(6)[:, :4].contiguous()
    src = torch.tensor([[0.9, 0.0, 0.0], [float("nan"), 0.0, 0.0]])
    vals, wd, idx = knn.knn_blend(src, ref, values, k=3, indices=True)
    assert idx.tolist() == [[1, 3, 0], [-1, -1, -1]]
    assert torch.isnan(vals[1]).all() and torch.isnan(wd[1]).all()
    again = knn.knn_blend(src, ref, values, k=3)
    assert torch.equal(again[0][0], vals[0]) and torch.equal(again[1][0],
                                                             wd[0])


# ---------------------------------------------------- the families
class Side:
    """One family's configs, composed weights, train datasets, and the
    JAX trainer with its jitted `_train_step`, a jitted twin of
    `_loss_one` that also returns the render and the gradient, and
    Adam's update alone."""

    def __init__(self, family):
        self.family = family
        self.jc = j_load_config(cfg_file(family), OPTS)
        self.tc = load_config(cfg_file(family), OPTS)
        self.params = compose_aligned(family)
        self.datasets = (j_engine.make_dataset(self.jc, "train"),
                         t_engine.make_dataset(self.tc, "train"))
        self.trainer = JTrainer(self.jc, j_engine.make_model(self.jc))
        self.step = jax.jit(self.trainer._train_step)
        tr = self.trainer

        def loss_and_ret(p, fb, step):
            rays = {k: fb[k] for k in RAY_KEYS if k in fb}
            ret = j_render_rays(tr.model, p, rays, fb, tr.settings,
                                key=jax.random.PRNGKey(0), train=True)
            loss, stats = j_compute_losses(ret, rays, step)
            return loss, (stats, ret)

        self.grad = jax.jit(jax.value_and_grad(loss_and_ret, has_aux=True))

        def apply(state, grads):
            updates, opt_state = tr.tx.update(grads, state.opt_state,
                                              state.params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                            updates)
            return TrainState(params, opt_state, state.step + 1)

        self.apply = jax.jit(apply)
        p = jax.tree_util.tree_map(jnp.asarray, as_flax(self.params))
        self.state0 = TrainState(p, tr.tx.init(p), jnp.asarray(0))

    def batches(self, index, seed):
        j_ds, t_ds = self.datasets
        j_ds._rng = np.random.RandomState(seed)
        t_ds._rng = np.random.RandomState(seed)
        return (j_stack_batch([j_collate_rays(j_ds[index], N_RAND)]),
                stack_batch([collate_rays(t_ds[index], N_RAND)]))

    def loss_grad(self, jb, params, step=0):
        fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
        (loss, (stats, ret)), grads = self.grad(params, fb, step)
        return float(loss), {k: float(v) for k, v in stats.items()}, ret, grads

    def port_trainer(self):
        model = t_engine.make_model(self.tc)
        model.load_state_dict(param_codec(model)[0](self.params), strict=True)
        return Trainer(self.tc, model, "cpu")

    def port_tree(self, model, named):
        return leaves(as_flax(param_codec(model)[1](named)))

    def port_grads(self, model):
        return self.port_tree(model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()})

    def port_params(self, model):
        return self.port_tree(model, dict(model.named_parameters()))

    def ulp_moved_grads(self, tb):
        """The port's gradient leaves of one step from the composed
        weights with every ray direction moved up by one float32 ulp."""
        trainer = self.port_trainer()
        ray_d = np.nextafter(tb["ray_d"], np.float32(np.inf))
        loss, _, _ = trainer.loss({k: v[0] for k, v in
                                   dict(tb, ray_d=ray_d).items()})
        loss.backward()
        return self.port_grads(trainer.model)

    def set_grads(self, model, j_grads):
        named = param_codec(model)[0](j_grads)
        for name, p in model.named_parameters():
            p.grad = named[name].reshape(p.shape).clone()


@pytest.fixture(scope="module", params=FAMILIES)
def side(request):
    return Side(request.param)


def assert_grads_close(got, want, ulp_moved):
    """Each leaf within GRAD_REL of its largest entry, unless the port's
    own gradient of that leaf moves by at least half the difference when
    the rays' directions move by one float32 ulp (`ulp_moved()`: the
    port's gradient leaves then, computed only if a leaf needs it); and
    the whole gradient within GRAD_L2 of its L2 norm."""
    assert set(got) == set(want)
    moved = None
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert np.isfinite(got[k]).all(), k
        if err > GRAD_REL * np.abs(w).max():
            moved = ulp_moved() if moved is None else moved
            shift = np.abs(moved[k] - got[k]).max()
            assert shift >= err / 2, (k, err, shift, np.abs(w).max())
    l2 = np.sqrt(sum(float(((got[k].astype(np.float64) - w) ** 2).sum())
                     for k, w in want.items())
                 / sum(float((w.astype(np.float64) ** 2).sum())
                       for w in want.values()))
    assert l2 <= GRAD_L2, l2


def test_dense_train_forward_matches_jax(side):
    """`train_forward` against JAX's `__call__(train=True)` through both
    renderers: the filter, raw and the maps, and each family's outputs
    (pbw, tbw and bw_mask with a learned field, LBWPDF's resd)."""
    jb, tb = side.batches(4, 0)
    _, _, j_ret, _ = side.loss_grad(jb, side.state0.params)
    trainer = side.port_trainer()
    batch = {k: v[0] for k, v in tb.items()}
    _, _, ret = trainer.loss(batch)
    assert set(ret) == set(j_ret)

    model = trainer.model
    frame = trainer._frame(batch)
    pose = world_points_to_pose_points(
        torch.as_tensor(np.asarray(batch["ray_o"])[:, None]
                        + np.asarray(j_ret["z_vals"])[..., None]
                        * np.asarray(batch["ray_d"])[:, None]).reshape(-1, 3),
        frame["R"], frame["Th"])
    _, pnorm = knn.knn_blend(pose, frame["pvertices"], frame["weights"])
    got_pind = (ret["raw"].detach().reshape(-1, 4) != 0).any(-1).numpy()
    want_pind = (np.asarray(j_ret["raw"]).reshape(-1, 4) != 0).any(-1)
    flips = np.nonzero(got_pind != want_pind)[0]
    assert len(flips) <= MAX_FLIPS
    assert np.all(np.abs(pnorm[torch.as_tensor(flips), 0].numpy()
                         - model.norm_th) <= FLIP_BAND)
    both = got_pind & want_pind
    assert both.sum() > 100
    for k in ("raw", "rgb_map", "acc_map"):
        g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0, atol=MAP_TOL, err_msg=k)
    for k in ("pbw", "tbw", "resd"):
        if k in ret:
            g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
            assert g.shape == w.shape and np.isfinite(g).all(), k
            np.testing.assert_allclose(g[both], w[both], rtol=0, atol=MAP_TOL,
                                       err_msg=k)
    for k in ("bw_mask", "resd_mask"):
        if k in ret:
            d = np.nonzero(ret[k].numpy() != np.asarray(j_ret[k]))[0]
            assert set(d) <= set(flips), k
    if "bw_mask" in ret:
        assert ret["bw_mask"].sum() > 0
    assert float(ret["acc_map"].detach().max()) > 0.1


def test_train_step_matches_jax(side):
    """One step from the composed weights and a fresh Adam: loss, stats,
    every gradient leaf, the update alone and the whole step against
    `Trainer._train_step`."""
    jb, tb = side.batches(4, 0)
    j_loss, j_stats, _, j_grads = side.loss_grad(jb, side.state0.params)
    j_state, _ = side.step(side.state0, jb, jax.random.PRNGKey(0))

    trainer = side.port_trainer()
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    assert set(stats) == set(j_stats) == STATS[side.family]
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    want_g = leaves(j_grads)
    assert_grads_close(side.port_grads(trainer.model), want_g,
                       lambda: side.ulp_moved_grads(tb))

    p0 = leaves(side.state0.params)
    trainer.apply_gradients()
    got, want = side.port_params(trainer.model), leaves(j_state.params)
    for k, w in want.items():
        g_tol = GRAD_REL * np.abs(want_g[k]).max()
        resolved = np.abs(want_g[k]) > 100 * g_tol
        d = np.abs(got[k] - w)
        assert np.isfinite(got[k]).all(), k
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(w - p0[k]).max() <= LR * (1 + 1e-3), k

    trainer = side.port_trainer()
    side.set_grads(trainer.model, j_grads)
    trainer.apply_gradients()
    want = leaves(side.apply(side.state0, j_grads).params)
    for k, g in side.port_params(trainer.model).items():
        np.testing.assert_allclose(g, want[k], rtol=ULP,
                                   atol=ADAM_SAME_GRAD_TOL, err_msg=k)


def test_three_steps_match_jax(side):
    """Three steps of `Trainer._train_step` against the port: the first
    step's loss; the port's Adam fed JAX's gradients follows JAX's
    weights, and at those weights each step's loss is JAX's; on its own
    gradients the port stays within 2 lr a step of JAX's weights (the
    reason is in tests/test_torch_train_pdf_families.py)."""
    trainer = side.port_trainer()
    fed = side.port_trainer()
    state = applied = side.state0
    for n, (index, seed) in enumerate(((4, 0), (7, 1), (1, 2))):
        jb, tb = side.batches(index, seed)
        state, j_stats = side.step(state, jb, jax.random.PRNGKey(0))
        stats = trainer.train_step(tb)
        assert np.isfinite(stats["loss"])
        if n == 0:
            np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                                       rtol=LOSS_RTOL)
        j_loss, _, _, j_grads = side.loss_grad(jb, applied.params,
                                               int(applied.step))
        fed.optimizer.zero_grad(set_to_none=True)
        loss, _, _ = fed.loss({k: v[0] for k, v in tb.items()})
        np.testing.assert_allclose(float(loss.detach()), j_loss,
                                   rtol=LOSS_RTOL)
        applied = side.apply(applied, j_grads)
        side.set_grads(fed.model, j_grads)
        fed.apply_gradients()
        fed.step += 1
        mine, want = side.port_params(trainer.model), leaves(state.params)
        for k, w in want.items():
            assert np.abs(mine[k] - w).max() <= 2 * (n + 1) * LR * (1 + 1e-3), k
    assert trainer.step == trainer.updates == int(state.step) == 3
    want = leaves(applied.params)
    for k, g in side.port_params(fed.model).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)


def test_checkpoints_both_ways(tmp_path, side):
    """Two port steps saved: JAX's `load_checkpoint` restores the params,
    the counters and Adam's moments; a JAX step saved: the port resumes
    it, weights and moments equal, and takes its next step."""
    trainer = side.port_trainer()
    for i in range(2):
        trainer.train_step(side.batches(i, i)[1])
    save_checkpoint(str(tmp_path / "port"), trainer.model, trainer.optimizer,
                    3, trainer.step, {"step": 2}, latest=True)
    st = side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path / "port"), st.params, st.opt_state)
    assert (epoch, step, rec) == (3, 2, {"step": 2})
    mine = side.port_params(trainer.model)
    assert leaves(j_params).keys() == mine.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam, sched = j_opt[1]
    assert int(adam.count) == int(sched.count) == count == 2
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = side.port_tree(trainer.model, ours)
        for k, v in leaves(theirs).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)

    jb, _ = side.batches(4, 0)
    state, _ = side.step(st, jb, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path / "jax"), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = side.port_trainer()
    out = load_checkpoint(str(tmp_path / "jax"), trainer.model,
                          trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    _, trainer.step, trainer.updates, _ = out
    for k, v in side.port_params(trainer.model).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam = state.opt_state[1][0]
    assert count == int(adam.count) == 1
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in side.port_tree(trainer.model, ours).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    trainer.train_step(side.batches(7, 1)[1])
    assert trainer.step == trainer.updates == 2 and all(
        np.isfinite(v).all() for v in side.port_params(trainer.model).values())


@pytest.mark.parametrize("family", ["pbw", "smpl"])
def test_novel_pose_refused_before_any_work(family, tmp_path):
    """Stage 2 of PBW and SMPL, which have no novel-pose field (JAX's
    stage 2 raises an AttributeError for them), raises before anything
    is read or written; their test_novel_pose renders through the
    stage-1 deform (tests/test_torch_aligned_novel_pose.py)."""
    cfg = load_config(cfg_file(family),
                      ["aninerf_animation", "True",
                       "trained_model_dir", str(tmp_path / "m"),
                       "record_dir", str(tmp_path / "r")])
    with pytest.raises(NotImplementedError, match="has no novel-pose field"):
        t_engine.run_train(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="has no novel-pose field"):
        t_engine.initial_model(cfg)
    assert not (tmp_path / "m").exists() and not (tmp_path / "r").exists()
