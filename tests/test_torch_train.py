"""The training slice on the CPU: the port against the JAX package on
the same numpy-seeded inputs and the same weights (the tracked
checkpoint of configs/synthetic.yaml), at full widths (8x256 trunks)
with 64 rays of 16 samples and `perturb 0`.

Tolerances:
  * K1's Function (forward and the vjp of its plain version) against
    jax.vjp of `make_fused_skip_mlp` (its `_ref_forward` branch on the
    CPU): rtol = atol = 1e-5 on the output, and per gradient leaf
    max |d| <= 1e-5 x max(1, max |g|): float32 summed in another order.
  * The train ray draw, the loader's order and the consistency mask
    `bw_mask`: equal (bit for bit); the bone transforms A (24 chained
    float32 4x4 products) within 1e-6.
  * The dense train forward: raw, rgb_map, acc_map, pbw, tbw within
    1e-4 (measured 2.3e-5 on raw: the canonical points' rounding,
    multiplied by the positional encoding; the eval slice's tolerance,
    tests/test_torch_slice.py).
  * compute_losses on equal inputs: rtol 1e-6.
  * Loss and stats of a step: rtol 1e-4 (measured 1.2e-7 on the loss,
    2.1e-5 on the small bw_loss at norm_th 0.05).
  * Gradients, per leaf: max |d| <= GRAD_REL x max |g|. The canonical
    points come out of an LBS inverse rounded in another order, and the
    positional encoding (sin/cos up to 2^9 x) multiplies those 1e-7
    differences, so the leaves fed from it (NeRF trunk lin0, the
    consistency pass of the blend-weight field) differ by up to 2.3e-3
    of their largest entry (measured): GRAD_REL = 1e-2.
  * Adam's update: given the same gradient, the port's clip and Adam
    give the params of JAX's optimizer (the Trainer's optax chain)
    within 1e-7 (its bias corrections are float32). From its own
    gradient, against `Trainer._train_step`, every
    entry whose JAX gradient exceeds its leaf's gradient tolerance 100
    times (its direction resolved) is within 1e-6 of JAX; any other
    entry within 2 lr, the most one Adam step moves it: Adam divides
    each entry by its own magnitude, so the sign of a gradient entry
    below the two packages' float32 agreement decides its step.
  * Three steps in a row: each step's loss within rtol 1e-4 of
    `Trainer._train_step`'s (measured 6e-6); and three updates of the
    port's Adam from JAX's gradients give the params of three updates
    of JAX's optimizer within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data.loader import Loader as JLoader
from animatable_nerf_tpu.ops.mlp_pallas import make_fused_skip_mlp
from animatable_nerf_tpu.render.renderer import render_rays as j_render_rays
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from animatable_nerf_tpu.train.losses import compute_losses as j_compute_losses
from animatable_nerf_tpu.train.optim import make_schedule as j_make_schedule
from animatable_nerf_tpu.train.trainer import (
    RAY_KEYS,
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import train_net
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.jax_params import (
    aninerf_param_tree,
    aninerf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals
from animatable_nerf_tpu_torch.data.loader import Loader
from animatable_nerf_tpu_torch.ops import skip_mlp as k1
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    save_checkpoint,
    write_fresh_start,
)
from animatable_nerf_tpu_torch.train.losses import compute_losses
from animatable_nerf_tpu_torch.train.optim import make_schedule
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

CFG = "configs/synthetic.yaml"
CKPT = "data/trained_model/deform/synthetic/latest.flax"
N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
K1_TOL = 1e-5
MAP_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_SAME_GRAD_TOL = 1e-7
ADAM_RESOLVED_TOL = 1e-6
STEPS_LOSS_RTOL = 1e-4
STEPS_PARAM_TOL = 1e-6
LR = 5e-4


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def cfgs():
    return j_load_config(CFG, OPTS), load_config(CFG, OPTS)


@pytest.fixture(scope="module")
def params():
    return flax_msgpack.read_checkpoint(CKPT)["params"]


@pytest.fixture(scope="module")
def datasets(cfgs):
    jc, tc = cfgs
    return j_engine.make_dataset(jc, "train"), t_engine.make_dataset(tc, "train")


def draw(datasets, index, seed):
    """Item `index` of both train splits, drawn from RandomState(seed)."""
    j_ds, t_ds = datasets
    j_ds._rng = np.random.RandomState(seed)
    t_ds._rng = np.random.RandomState(seed)
    return j_ds[index], t_ds[index]


def batches(datasets, index, seed):
    j_item, t_item = draw(datasets, index, seed)
    return (j_stack_batch([j_collate_rays(j_item, N_RAND)]),
            stack_batch([collate_rays(t_item, N_RAND)]))


class JaxSide:
    """The JAX trainer, its jitted `_train_step` and a jitted twin of
    `_loss_one` that also returns the render and the gradient."""

    def __init__(self, jc, params):
        self.trainer = JTrainer(jc, j_engine.make_model(jc))
        self.step = jax.jit(self.trainer._train_step)
        tr = self.trainer

        def loss_and_ret(p, fb):
            rays = {k: fb[k] for k in RAY_KEYS if k in fb}
            ret = j_render_rays(tr.model, p, rays, fb, tr.settings,
                                key=jax.random.PRNGKey(0), train=True)
            loss, stats = j_compute_losses(ret, rays, 0)
            return loss, (stats, ret)

        self.grad = jax.jit(jax.value_and_grad(loss_and_ret, has_aux=True))

        def apply(state, grads):
            updates, opt_state = tr.tx.update(grads, state.opt_state,
                                              state.params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                            updates)
            return TrainState(params, opt_state, state.step + 1)

        self.apply = jax.jit(apply)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        self.state0 = TrainState(p, tr.tx.init(p), jnp.asarray(0))

    def loss_grad(self, jb, params):
        fb = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)
        (loss, (stats, ret)), grads = self.grad(params, fb)
        return float(loss), {k: float(v) for k, v in stats.items()}, ret, grads


@pytest.fixture(scope="module")
def jax_side(cfgs, params):
    return JaxSide(cfgs[0], params)


def port_trainer(tc, params):
    model = t_engine.make_model(tc)
    model.load_state_dict(aninerf_state_dict(params), strict=True)
    return Trainer(tc, model, "cpu")


def port_grads(trainer):
    return leaves(aninerf_param_tree(
        {n: p.grad for n, p in trainer.model.named_parameters()}))


def port_params(trainer):
    return leaves(aninerf_param_tree(dict(trainer.model.named_parameters())))


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(got[k] - w).max()
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_REL * scale, (k, err, scale)


# ------------------------------------------------------------------ K1
WIRINGS = {  # (din, widths, skips, act_last): the three trunks
    "bw_field": (191, [256] * 8 + [24], (4,), False),
    "tpose_trunk": (63, [256] * 8, (4,), True),
    "resd_field": (135, [256] * 8 + [3], (4,), False),
}


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_k1_function_matches_jax_vjp(wiring):
    din, widths, skips, act_last = WIRINGS[wiring]
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (96, din)).astype(np.float32)
    layers, d_in = [], din
    for i, w in enumerate(widths):
        layers.append(((rng.randn(d_in, w) / np.sqrt(d_in)).astype(np.float32),
                       (rng.randn(w) * 0.1).astype(np.float32)))
        d_in = w + (din if i in skips and i < len(widths) - 1 else 0)
    g = rng.randn(96, widths[-1]).astype(np.float32)

    f = make_fused_skip_mlp(skips=skips, act="relu", act_last=act_last)
    want, vjp = jax.vjp(f, jnp.asarray(x),
                        [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers])
    want_dx, want_dl = vjp(jnp.asarray(g))

    xt = torch.tensor(x, requires_grad=True)
    tl = [(torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True))
          for w, b in layers]
    got = k1.skip_mlp(xt, tl, skips, "relu", act_last)
    assert got.grad_fn is not None
    assert type(got.grad_fn).__name__ == "SkipMLPFunctionBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=K1_TOL, atol=K1_TOL)
    got.backward(torch.tensor(g))
    pairs = [(xt.grad, want_dx)] + [
        (t.grad, w) for (tw, tb), (jw, jb) in zip(tl, want_dl)
        for t, w in ((tw, jw), (tb, jb))]
    for t, w in pairs:
        w = np.asarray(w)
        assert np.abs(t.numpy() - w).max() <= K1_TOL * max(1.0, np.abs(w).max())


# ------------------------------------------------------------- data
@pytest.mark.parametrize("index,seed", [(0, 0), (5, 1), (11, 2)])
def test_train_ray_draw_matches_jax(datasets, index, seed):
    j_item, t_item = draw(datasets, index, seed)
    assert set(t_item) == set(j_item)
    for k in j_item:
        g, r = np.asarray(t_item[k]), np.asarray(j_item[k])
        assert g.shape == r.shape, k
        if k in ("A", "big_A"):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    assert len(t_item["ray_o"]) == N_RAND


def dropping_every_third(near_far, calls):
    """get_near_far_np that also drops rays 1, 4, 7, ... of each call
    (never the first, so a call for one ray ends the loop)."""
    def wrapped(bounds, ray_o, ray_d):
        calls.append(len(ray_o))
        near, far, mab = near_far(bounds, ray_o, ray_d)
        drop = np.zeros_like(mab)
        drop[1::3] = True
        keep = ~drop[mab]
        return near[keep], far[keep], mab & ~drop
    return wrapped


def test_train_ray_draw_loops_like_jax(monkeypatch, datasets):
    """With a third of each round's rays missing the box, the draw loops
    for the rest, round after round, in both packages alike (the
    synthetic boxes are hit by nearly every ray of their projection, so
    the loop never turns there)."""
    from animatable_nerf_tpu.data import utils as j_utils
    from animatable_nerf_tpu_torch.data import utils as t_utils

    calls = {"jax": [], "port": []}
    for name, mod in (("jax", j_utils), ("port", t_utils)):
        monkeypatch.setattr(mod, "get_near_far_np",
                            dropping_every_third(mod.get_near_far_np, calls[name]))
    j_item, t_item = draw(datasets, 2, 9)
    assert calls["port"] == calls["jax"] and len(calls["port"]) > 2
    assert len(t_item["ray_o"]) == N_RAND
    for k in ("rgb", "ray_o", "ray_d", "near", "far", "coord", "mask_at_box",
              "occupancy"):
        np.testing.assert_array_equal(t_item[k], j_item[k], err_msg=k)


@pytest.mark.parametrize("epoch,max_iter", [(0, 50), (1, 50), (2, 50), (3, -1)])
def test_loader_epoch_order_matches_jax(datasets, epoch, max_iter):
    j_ds, t_ds = datasets
    j_loader = JLoader(j_ds, shuffle=True, max_iter=max_iter)
    t_loader = Loader(t_ds, shuffle=True, max_iter=max_iter)
    j_loader.set_epoch(epoch)
    t_loader.set_epoch(epoch)
    assert t_loader.indices() == j_loader._indices()
    assert len(t_loader) == len(j_loader)


@pytest.mark.parametrize("n_rays", [40, 80])
def test_collate_rays_matches_jax(datasets, n_rays):
    """Cut (40 of 64) and zero-padded (80) batches."""
    j_item, t_item = draw(datasets, 3, 4)
    got, want = collate_rays(t_item, n_rays), j_collate_rays(j_item, n_rays)
    assert set(want) <= set(got)
    for k in want:
        tol = 1e-6 if k in ("A", "big_A") else 0
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_stratified_perturb_stays_in_its_intervals():
    near = torch.tensor([1.0, 2.0, 3.0])
    far = torch.tensor([2.0, 5.0, 3.5])
    grid = stratified_z_vals(near, far, 16)
    gen = torch.Generator().manual_seed(3)
    z = stratified_z_vals(near, far, 16, perturb=True, generator=gen)
    mids = 0.5 * (grid[:, 1:] + grid[:, :-1])
    lower = torch.cat([grid[:, :1], mids], -1)
    upper = torch.cat([mids, grid[:, -1:]], -1)
    assert torch.all(z >= lower) and torch.all(z <= upper)
    assert not torch.equal(z, grid)
    again = stratified_z_vals(near, far, 16, perturb=True,
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(z, again)


# ------------------------------------------------------- model, loss
def test_dense_train_forward_matches_jax(cfgs, params, datasets, jax_side):
    jb, tb = batches(datasets, 4, 0)
    _, _, j_ret, _ = jax_side.loss_grad(jb, jax_side.state0.params)
    trainer = port_trainer(cfgs[1], params)
    _, _, ret = trainer.loss({k: v[0] for k, v in tb.items()})
    for k in ("raw", "rgb_map", "acc_map", "pbw", "tbw"):
        g = ret[k].detach().numpy()
        assert g.shape == j_ret[k].shape, k
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(j_ret[k]), rtol=0,
                                   atol=MAP_TOL, err_msg=k)
    np.testing.assert_array_equal(ret["bw_mask"].numpy(),
                                  np.asarray(j_ret["bw_mask"]))
    assert ret["bw_mask"].sum() > 1
    assert float(ret["acc_map"].detach().max()) > 0.5


@pytest.mark.parametrize("with_mask", [True, False])
def test_compute_losses_matches_jax(with_mask):
    """Differences on both sides of smooth-L1's knee, an empty row and
    pad rays."""
    rng = np.random.RandomState(11)
    n, m = 32, 200
    ret = {"rgb_map": rng.rand(n, 3).astype(np.float32),
           "pbw": rng.randn(m, 24).astype(np.float32),
           "tbw": rng.randn(m, 24).astype(np.float32),
           "bw_mask": rng.rand(m) < 0.3,
           "acc_map": rng.rand(n).astype(np.float32)}
    batch = {"rgb": rng.rand(n, 3).astype(np.float32),
             "mask_at_box": rng.rand(n) < 0.8}
    if with_mask:
        batch["mask"] = np.arange(n) < 25
    loss, stats = compute_losses({k: torch.tensor(v) for k, v in ret.items()},
                                 {k: torch.tensor(v) for k, v in batch.items()})
    j_loss, j_stats = j_compute_losses(
        {k: jnp.asarray(v) for k, v in ret.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, 0)
    assert set(stats) == set(j_stats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)


@pytest.mark.parametrize("key", ["compact_overflow", "compact_overflow_stage2"])
def test_compute_losses_raises_on_unported_terms(key):
    ret = {"rgb_map": torch.zeros(4, 3), key: torch.zeros(4)}
    batch = {"rgb": torch.zeros(4, 3), "mask_at_box": torch.ones(4, dtype=bool)}
    with pytest.raises(NotImplementedError, match=key):
        compute_losses(ret, batch)


@pytest.mark.parametrize("scheduler", [
    {"type": "exponential", "gamma": 0.1, "decay_epochs": 1000},
    {"type": "multi_step", "gamma": 0.5, "milestones": [2, 5]},
    {"type": "warmup_multi_step", "gamma": 0.5, "milestones": [2, 5],
     "warmup_iters": 120, "warmup_factor": 0.25},
], ids=lambda s: s["type"])
def test_schedules_match_jax(cfgs, scheduler):
    jc, tc = cfgs
    jc, tc = jc.clone(), tc.clone()
    jc.train.scheduler = dict(scheduler)
    tc.train.scheduler = dict(scheduler)
    got, want = make_schedule(tc), j_make_schedule(jc)
    for step in (0, 1, 49, 50, 119, 120, 249, 250, 300, 12345):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("opts", [["train.steps_per_dispatch", "4"]])
def test_unported_training_options_raise(params, opts):
    with pytest.raises(NotImplementedError):
        port_trainer(load_config(CFG, OPTS + opts), params)


# ------------------------------------------------------------- steps
def test_train_step_matches_jax(cfgs, params, datasets, jax_side):
    """One step from the tracked weights and a fresh Adam."""
    tc = cfgs[1]
    jb, tb = batches(datasets, 4, 0)
    j_loss, j_stats, _, j_grads = jax_side.loss_grad(jb, jax_side.state0.params)
    j_state, _ = jax_side.step(jax_side.state0, jb, jax.random.PRNGKey(0))

    trainer = port_trainer(tc, params)
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    want_g = leaves(j_grads)
    assert_grads_close(port_grads(trainer), want_g)

    # the whole step from the port's own gradient
    p0 = leaves(params)
    trainer.apply_gradients()
    got, want = port_params(trainer), leaves(j_state.params)
    for k, w in want.items():
        g_tol = GRAD_REL * np.abs(want_g[k]).max()
        resolved = np.abs(want_g[k]) > 100 * g_tol
        d = np.abs(got[k] - w)
        assert np.isfinite(got[k]).all(), k
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(w - p0[k]).max() <= LR * (1 + 1e-3), k

    # the update alone: one gradient through both optimizers
    trainer = port_trainer(tc, params)
    set_grads(trainer, j_grads)
    trainer.apply_gradients()
    want = leaves(jax_side.apply(jax_side.state0, j_grads).params)
    for k, g in port_params(trainer).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=ADAM_SAME_GRAD_TOL,
                                   err_msg=k)
    assert int(j_state.step) == 1


def test_step_with_fully_masked_rays_stays_finite(params, datasets):
    """At norm_th 0.05 (the reference's SMPL shell; the synthetic config
    widens it) rays have every sample masked. Their substituted points
    keep the step finite, and its loss and gradients are JAX's."""
    opts = OPTS + ["norm_th", "0.05"]
    js = JaxSide(j_load_config(CFG, opts), params)
    jb, tb = batches(datasets, 4, 0)
    j_loss, j_stats, _, j_grads = js.loss_grad(jb, js.state0.params)
    trainer = port_trainer(load_config(CFG, opts), params)
    loss, stats, ret = trainer.loss({k: v[0] for k, v in tb.items()})
    assert int((ret["raw"].detach().abs().sum((1, 2)) == 0).sum()) >= 8
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert_grads_close(port_grads(trainer), leaves(j_grads))
    trainer.apply_gradients()
    assert all(np.isfinite(v).all() for v in port_params(trainer).values())


def set_grads(trainer, j_grads):
    named = aninerf_state_dict(j_grads)
    for name, p in trainer.model.named_parameters():
        p.grad = named[name].reshape(p.shape).clone()


def test_three_steps_match_jax(cfgs, params, datasets, jax_side):
    tc = cfgs[1]
    trainer = port_trainer(tc, params)
    fed = port_trainer(tc, params)  # the port's Adam fed JAX's gradients
    state = applied = jax_side.state0
    for index, seed in ((4, 0), (7, 1), (1, 2)):
        jb, tb = batches(datasets, index, seed)
        state, j_stats = jax_side.step(state, jb, jax.random.PRNGKey(0))
        stats = trainer.train_step(tb)
        np.testing.assert_allclose(stats["loss"], float(j_stats["loss"]),
                                   rtol=STEPS_LOSS_RTOL)
        _, _, _, j_grads = jax_side.loss_grad(jb, applied.params)
        applied = jax_side.apply(applied, j_grads)
        set_grads(fed, j_grads)
        fed.apply_gradients()
    assert trainer.step == trainer.updates == int(state.step) == 3
    assert fed.updates == int(applied.step) == 3
    want = leaves(applied.params)
    for k, g in port_params(fed).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)
    got = port_params(trainer)
    assert all(np.isfinite(v).all() for v in got.values())


# ------------------------------------------------------- checkpoints
def trained(tc, params, datasets, steps=2):
    trainer = port_trainer(tc, params)
    for i in range(steps):
        trainer.train_step(batches(datasets, i, i)[1])
    return trainer


def test_port_checkpoint_reads_in_jax(tmp_path, cfgs, params, datasets, jax_side):
    """The port writes; JAX's load_checkpoint (the reader of its resume
    and of `run.py --type evaluate`) restores equal arrays."""
    jc, tc = cfgs
    trainer = trained(tc, params, datasets)
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 3,
                    trainer.step, {"step": 2}, latest=True)
    st = jax_side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path), st.params, st.opt_state)
    assert (epoch, step, rec) == (3, 2, {"step": 2})
    assert leaves(j_params).keys() == port_params(trainer).keys()
    for k, v in port_params(trainer).items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam, sched = j_opt[1]
    assert int(adam.count) == int(sched.count) == count == 2
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(aninerf_param_tree(mine))
        for k, v in leaves(theirs).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    jc_eval = jc.clone()
    jc_eval.trained_model_dir = str(tmp_path)
    evaluated = j_engine.Engine(jc_eval).load_params(st.params)
    for k, v in leaves(evaluated).items():
        np.testing.assert_array_equal(v, leaves(j_params)[k], err_msg=k)


def test_jax_checkpoint_resumes_in_port(tmp_path, cfgs, params, datasets,
                                        jax_side):
    """JAX writes after a step; the port restores its params, Adam state
    and counters, and its writer gives back the file byte for byte."""
    jb, _ = batches(datasets, 4, 0)
    state, _ = jax_side.step(jax_side.state0, jb, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = port_trainer(cfgs[1], params)
    out = load_checkpoint(str(tmp_path), trainer.model, trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    for k, v in port_params(trainer).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam = state.opt_state[1][0]
    assert count == int(adam.count) == 1
    for mine, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in leaves(aninerf_param_tree(mine)).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    blob = open(tmp_path / "0.flax", "rb").read()
    assert flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(blob)) == blob
    assert blob == serialization.msgpack_serialize(
        serialization.msgpack_restore(blob))


def test_run_train_writes_and_resumes(tmp_path):
    """Two CPU epochs of 2 steps from a fresh start on the tracked
    weights: the latest checkpoint and the snapshot carry the counters,
    and a resumed run goes on from them."""
    opts = OPTS + ["trained_model_dir", str(tmp_path / "model"),
                   "record_dir", str(tmp_path / "record"), "ep_iter", "2",
                   "save_ep", "1", "save_latest_ep", "1", "fix_random", "True",
                   "train.epoch", "1", "log_interval", "1", "record_interval", "1"]
    tc = load_config(CFG, opts)
    write_fresh_start(CKPT, tc.trained_model_dir)
    trainer, recorder = t_engine.run_train(tc, "cpu")
    assert trainer.step == trainer.updates == recorder.step == 2
    assert sorted(os.listdir(tc.trained_model_dir)) == ["0.flax", "latest.flax"]
    tc2 = load_config(CFG, opts + ["train.epoch", "2"])
    train_net.main(["--cfg_file", CFG, "--device", "cpu",
                    *(opts + ["train.epoch", "2"])])
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc2.trained_model_dir, "latest.flax"))
    assert int(raw["epoch"]) == 1 and int(raw["step"]) == 4
    assert int(raw["opt_state"]["1"]["0"]["count"]) == 4
    assert raw["recorder"] == {"step": 4}
    lines = open(os.path.join(tc.record_dir, "scalars.jsonl")).read().splitlines()
    assert lines and all(np.isfinite(v) for v in
                         json.loads(lines[-1])["train"].values())


def test_run_train_needs_a_gpu_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = load_config(CFG, OPTS + ["trained_model_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_engine.run_train(tc)
