"""SDF-PDF training on the CPU: the port against the JAX package on the
same numpy-seeded inputs and the same weights (the tracked checkpoint of
configs/synthetic_sdf_pdf.yaml), at full widths (8x256 displacement
field, 9-layer SDF network) with 64 rays of 16 samples and `perturb 0`.

Tolerances:
  * K1's gradient of a gradient (a loss on d y / d x through
    `skip_mlp`) against JAX's second derivative through
    `make_fused_skip_mlp` (its `_ref_forward` twin on the CPU): per
    tensor max |d| <= 1e-5 x max(1, max |g|), float32 summed in another
    order.
  * The train split's items: equal (bit for bit), the bone transforms A
    within 1e-6 (24 chained float32 4x4 products).
  * The dense train forward: the filter masks may differ only on points
    whose weighted KNN distance lies within FLIP_BAND of the 0.1
    threshold (JAX forms the distances as |s|^2 - 2 s.r + |r|^2, the
    port by differences), at most MAX_FLIPS of them (0 measured at both
    draws); on the points both keep, raw, sdf, resd and the two normals
    within MAP_TOL (measured 4.2e-5 on `observed_gradients`, the
    normal of sdf(x + resd(x)): the rounding of the canonical points
    multiplied by the PE and by softplus(100 x)'s curvature; 1.3e-6 on
    raw); the silhouette masks equal.
  * compute_losses on equal inputs: rtol 1e-6, its gradient 1e-6 of
    each tensor's scale (exact zeros of resd included: a zero gradient,
    as JAX's safe_norm, not NaN).
  * Loss and stats of a step: rtol 1e-4 (measured 1.1e-7 on the loss,
    8.8e-7 on ograd_loss). Gradients per leaf: max |d| <= GRAD_REL x
    max |g| with GRAD_REL = 1e-2 (measured 7.0e-5, on the displacement
    field's lin6). The displacement field's gradient from the
    observed-space eikonal term alone: the same bound (measured 7.9e-5;
    with a K1 whose backward keeps no graph it is 9% to 103% of each
    leaf's scale).
  * Adam's update as tests/test_torch_train.py holds it: from JAX's
    gradient within 1e-7 of JAX's optimizer, or one float32 ulp of the
    parameter (the weight norms g lie near 1, where an ulp is 1.19e-7;
    7 of the color network's 256 lin0 norms differ by it, its bias
    corrections rounded in another order); from the port's own, within
    1e-6 where the gradient's direction is resolved (the JAX gradient
    over 100 x its tolerance), else within 2 lr.
  * Three steps: each step's loss within rtol 1e-4 of
    `Trainer._train_step`'s; three updates of the port's Adam from JAX's
    gradients within 1e-6 of JAX's optimizer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.composite import (
    get_intersection_mask as j_get_intersection_mask,
)
from animatable_nerf_tpu.fields.mlp import geometric_mlp_params
from animatable_nerf_tpu.ops.mlp_pallas import make_fused_skip_mlp
from animatable_nerf_tpu.render.renderer import render_rays as j_render_rays
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    load_params_partial as j_load_params_partial,
    save_checkpoint as j_save_checkpoint,
)
from animatable_nerf_tpu.train.losses import (
    compute_losses as j_compute_losses,
    sdf_mask_alpha as j_sdf_mask_alpha,
)
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
    sdf_pdf_param_tree,
    sdf_pdf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.composite import get_intersection_mask
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.ops import skip_mlp as k1
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    save_checkpoint,
    write_fresh_start,
)
from animatable_nerf_tpu_torch.train.losses import compute_losses, sdf_mask_alpha
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

CFG = "configs/synthetic_sdf_pdf.yaml"
CKPT = "data/trained_model/deform/synthetic_sdf_pdf/latest.flax"
N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
K1_TOL = 1e-5
NORM_TH = 0.1
FLIP_BAND = 1e-5
MAX_FLIPS = 4
MAP_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_SAME_GRAD_TOL = 1e-7
ULP = 2.0 ** -23  # one float32 ulp, relative
ADAM_RESOLVED_TOL = 1e-6
STEPS_PARAM_TOL = 1e-6
LR = 5e-4
RESD_LEAF = "['params']['resd_field']"


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_flax(tree):
    """A param tree as flax holds it: the SDF network's layers a list (a
    msgpack file, and `sdf_pdf_param_tree`, key them "0", "1", ...)."""
    inner = dict(tree["params"])
    layers = inner["sdf_network"]["layers"]
    if isinstance(layers, dict):
        inner["sdf_network"] = {
            "layers": [layers[str(i)] for i in range(len(layers))]}
    return {"params": inner}


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
    j_ds, t_ds = datasets
    j_ds._rng = np.random.RandomState(seed)
    t_ds._rng = np.random.RandomState(seed)
    return j_ds[index], t_ds[index]


def batches(datasets, index, seed):
    j_item, t_item = draw(datasets, index, seed)
    return (j_stack_batch([j_collate_rays(j_item, N_RAND)]),
            stack_batch([collate_rays(t_item, N_RAND)]))


class JaxSide:
    """The JAX trainer, its jitted `_train_step`, a jitted twin of
    `_loss_one` at a given step that also returns the render and the
    gradient, and the gradient of one stat alone."""

    def __init__(self, jc, params):
        self.trainer = JTrainer(jc, j_engine.make_model(jc))
        self.step = jax.jit(self.trainer._train_step)
        tr = self.trainer

        def loss_and_ret(p, fb, step):
            rays = {k: fb[k] for k in RAY_KEYS if k in fb}
            ret = j_render_rays(tr.model, p, rays, fb, tr.settings,
                                key=jax.random.PRNGKey(0), train=True)
            loss, stats = j_compute_losses(ret, rays, step)
            return loss, (stats, ret)

        self.grad = jax.jit(jax.value_and_grad(loss_and_ret, has_aux=True))
        self.ograd = jax.jit(jax.grad(
            lambda p, fb: loss_and_ret(p, fb, 0)[1][0]["ograd_loss"]))

        def apply(state, grads):
            updates, opt_state = tr.tx.update(grads, state.opt_state,
                                              state.params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                            updates)
            return TrainState(params, opt_state, state.step + 1)

        self.apply = jax.jit(apply)
        p = jax.tree_util.tree_map(jnp.asarray, as_flax(params))
        self.state0 = TrainState(p, tr.tx.init(p), jnp.asarray(0))

    @staticmethod
    def frame(jb):
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jb)

    def loss_grad(self, jb, params, step=0):
        (loss, (stats, ret)), grads = self.grad(params, self.frame(jb), step)
        return float(loss), {k: float(v) for k, v in stats.items()}, ret, grads


@pytest.fixture(scope="module")
def jax_side(cfgs, params):
    return JaxSide(cfgs[0], params)


def port_trainer(tc, params):
    model = t_engine.make_model(tc)
    model.load_state_dict(sdf_pdf_state_dict(params), strict=True)
    return Trainer(tc, model, "cpu")


def port_grads(model):
    return leaves(as_flax(sdf_pdf_param_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()})))


def port_params(model):
    return leaves(as_flax(sdf_pdf_param_tree(dict(model.named_parameters()))))


def assert_grads_close(got, want, only=""):
    assert set(got) == set(want)
    for k, w in want.items():
        if not k.startswith(only):
            continue
        err = np.abs(got[k] - w).max()
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_REL * np.abs(w).max(), (k, err, np.abs(w).max())


def set_grads(model, j_grads):
    named = sdf_pdf_state_dict(j_grads)
    for name, p in model.named_parameters():
        p.grad = named[name].reshape(p.shape).clone()


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("wiring", [
    (135, [256] * 8 + [3], (4,)),  # the displacement field
    (11, [16, 16, 16, 2], (1,)),  # a narrow stack
], ids=["resd_field", "narrow"])
def test_k1_gradient_of_gradient_matches_jax(wiring):
    """A loss on d(u . y)/dx, differentiated with respect to x and every
    layer: through `skip_mlp` (K1's Function, whose backward must keep
    a graph under create_graph) against JAX's second derivative of
    `make_fused_skip_mlp`."""
    din, widths, skips = wiring
    rng = np.random.RandomState(3)
    n = 48
    x = rng.uniform(-1, 1, (n, din)).astype(np.float32)
    layers, d_in = [], din
    for i, w in enumerate(widths):
        layers.append(((rng.randn(d_in, w) / np.sqrt(d_in)).astype(np.float32),
                       (rng.randn(w) * 0.1).astype(np.float32)))
        d_in = w + (din if i in skips and i < len(widths) - 1 else 0)
    u = rng.randn(n, widths[-1]).astype(np.float32)
    v = rng.randn(n, din).astype(np.float32)

    f = make_fused_skip_mlp(skips=skips, act="relu")

    def j_loss(x, layers):
        g = jax.grad(lambda x: jnp.sum(f(x, layers) * u))(x)
        return jnp.sum(g * v) + 0.5 * jnp.sum(g * g)

    want_dx, want_dl = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers])

    xt = torch.tensor(x, requires_grad=True)
    tl = [(torch.tensor(w, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for w, b in layers]
    y = k1.skip_mlp(xt, tl, skips, "relu")
    assert type(y.grad_fn).__name__ == "SkipMLPFunctionBackward"
    (g,) = torch.autograd.grad((y * torch.tensor(u)).sum(), xt,
                               create_graph=True)
    loss = (g * torch.tensor(v)).sum() + 0.5 * (g * g).sum()
    flat = [xt] + [t for wb in tl for t in wb]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    want = [want_dx] + [t for wb in want_dl for t in wb]
    for t, w, leaf in zip(got, want, flat):
        t = torch.zeros_like(leaf) if t is None else t
        w = np.asarray(w)
        err = np.abs(t.numpy() - w).max()
        assert err <= K1_TOL * max(1.0, np.abs(w).max()), (leaf.shape, err)


@pytest.mark.parametrize("mode", ["backward", "create_graph", "second_order"])
def test_k1_gradient_when_x_depends_on_its_weights_matches_jax(mode):
    """K1 applied to its own output, x = sin(f(a)), y = f(x), with the
    same layers: the backward's gradients are partial ones (the path
    through x reaches the layers once, through the outer graph), with
    and without create_graph and differentiated again; against JAX's
    `make_fused_skip_mlp`."""
    din, widths, skips = 6, [16, 16, 16, 6], (1,)
    rng = np.random.RandomState(4)
    n = 40
    a = rng.uniform(-1, 1, (n, din)).astype(np.float32)
    layers, d_in = [], din
    for i, w in enumerate(widths):
        layers.append(((rng.randn(d_in, w) / np.sqrt(d_in)).astype(np.float32),
                       (rng.randn(w) * 0.1).astype(np.float32)))
        d_in = w + (din if i in skips and i < len(widths) - 1 else 0)
    u = rng.randn(n, din).astype(np.float32)
    v = rng.randn(n, din).astype(np.float32)

    f = make_fused_skip_mlp(skips=skips, act="relu")

    def j_first(a, layers):
        return jnp.sum(f(jnp.sin(f(a, layers)), layers) * u)

    def j_loss(a, layers):
        if mode != "second_order":
            return j_first(a, layers)
        g = jax.grad(j_first)(a, layers)
        return jnp.sum(g * v) + 0.5 * jnp.sum(g * g)

    want_da, want_dl = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(a), [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers])

    at = torch.tensor(a, requires_grad=True)
    tl = [(torch.tensor(w, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for w, b in layers]
    flat = [at] + [t for wb in tl for t in wb]
    y = k1.skip_mlp(torch.sin(k1.skip_mlp(at, tl, skips, "relu")), tl,
                    skips, "relu")
    loss = (y * torch.tensor(u)).sum()
    if mode == "second_order":
        (g,) = torch.autograd.grad(loss, at, create_graph=True)
        loss = (g * torch.tensor(v)).sum() + 0.5 * (g * g).sum()
    got = torch.autograd.grad(loss, flat, allow_unused=True,
                              create_graph=mode == "create_graph")
    want = [want_da] + [t for wb in want_dl for t in wb]
    for t, w, leaf in zip(got, want, flat):
        t = torch.zeros_like(leaf) if t is None else t.detach()
        w = np.asarray(w)
        err = np.abs(t.numpy() - w).max()
        assert err <= K1_TOL * max(1.0, np.abs(w).max()), (leaf.shape, err)


# ------------------------------------------------------------- data
@pytest.mark.parametrize("index,seed", [(0, 0), (7, 3)])
def test_train_split_items_match_jax(datasets, index, seed):
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
    occ = t_item["occupancy"]  # 0 outside, 1 inside, 100 on the edge band
    assert (occ == 0).any() and (occ != 0).any()


# ------------------------------------------------------- model, loss
@pytest.mark.parametrize("index,seed", [(4, 0), (9, 5)])
def test_dense_train_forward_matches_jax(cfgs, params, datasets, jax_side,
                                         index, seed):
    jb, tb = batches(datasets, index, seed)
    _, _, j_ret, _ = jax_side.loss_grad(jb, jax_side.state0.params)
    trainer = port_trainer(cfgs[1], params)
    batch = {k: v[0] for k, v in tb.items()}
    _, _, ret = trainer.loss(batch)

    # the filter: flips only within rounding of the threshold
    got_pind = ret["resd_mask"].numpy()
    want_pind = np.asarray(j_ret["resd_mask"])
    frame = trainer._frame(batch)
    pose = world_points_to_pose_points(
        torch.as_tensor(np.asarray(batch["ray_o"])[:, None]
                        + np.asarray(j_ret["z_vals"])[..., None]
                        * np.asarray(batch["ray_d"])[:, None]).reshape(-1, 3),
        frame["R"], frame["Th"])
    _, pnorm = sample_blend_closest_points(pose, frame["pvertices"],
                                           frame["weights"])
    flips = np.nonzero(got_pind != want_pind)[0]
    assert len(flips) <= MAX_FLIPS
    near = np.abs(pnorm[torch.as_tensor(flips), 0].numpy() - NORM_TH)
    assert np.all(near <= FLIP_BAND)
    both = got_pind & want_pind
    assert both.sum() > 100
    for k in ("grad_mask", "observed_grad_mask"):
        d = np.nonzero(ret[k].numpy() != np.asarray(j_ret[k]))[0]
        assert set(d) <= set(flips), k
    assert ret["observed_grad_mask"].sum() > 0

    for k in ("raw", "sdf", "rgb_map", "acc_map", "msk_sdf"):
        g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0, atol=MAP_TOL, err_msg=k)
    for k in ("resd", "gradients", "observed_gradients"):
        g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g[both], w[both], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    for k in ("msk_free", "msk_in"):
        np.testing.assert_array_equal(ret[k].numpy(), np.asarray(j_ret[k]),
                                      err_msg=k)
    # 16 samples of the fixed 0.005 VolSDF step: rays reach 0.16-0.23
    assert float(ret["acc_map"].detach().max()) > 0.1


@pytest.mark.parametrize("kind", ["random", "ties", "fill"])
def test_intersection_mask_matches_jax(kind):
    """The per-ray crossing mask against JAX's: random sdfs, rays with
    several crossings and exact zeros, and the +10 fill of masked
    samples; every other ray stays on one side."""
    rng = np.random.RandomState(5)
    sdf = rng.randn(300, 16).astype(np.float32) * 0.1
    if kind == "ties":
        sdf = np.sign(sdf) * (rng.rand(300, 16) < 0.7).astype(np.float32)
    elif kind == "fill":
        sdf[rng.rand(300, 16) < 0.6] = 10.0
    sdf[::2] = np.abs(sdf[::2])  # every other ray has no crossing
    mask = get_intersection_mask(torch.tensor(sdf))
    j_mask, _ = j_get_intersection_mask(jnp.asarray(sdf))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.any() and not mask.all()


def loss_inputs(seed):
    """A render's loss inputs with every SDF term: exact zero rows in
    resd (safe_norm's kink), normals on both sides of unit length, an
    sdf on both sides of 0, rays inside and outside the mask, pad rays."""
    rng = np.random.RandomState(seed)
    n, m = 32, 200
    resd = (rng.randn(m, 3) * 0.01).astype(np.float32)
    resd[::7] = 0.0
    ret = {"rgb_map": rng.rand(n, 3).astype(np.float32),
           "resd": resd, "resd_mask": rng.rand(m) < 0.6,
           "gradients": rng.randn(m, 3).astype(np.float32) * 0.7,
           "grad_mask": rng.rand(m) < 0.6,
           "observed_gradients": rng.randn(m, 3).astype(np.float32) * 0.6,
           "observed_grad_mask": rng.rand(m) < 0.3,
           "msk_sdf": (rng.randn(n) * 0.05).astype(np.float32),
           "msk_free": rng.rand(n) < 0.4}
    ret["msk_in"] = ~ret["msk_free"] & (rng.rand(n) < 0.5)
    batch = {"rgb": rng.rand(n, 3).astype(np.float32),
             "mask_at_box": rng.rand(n) < 0.8, "mask": np.arange(n) < 28}
    return ret, batch


@pytest.mark.parametrize("iter_step,alpha_max", [
    (0, 0.0), (10000, 0.0), (10001, 0.0), (20001, 0.0), (35000, 0.0),
    (50001, 0.0), (50001, 150.0), (25000, 150.0), (0, 30.0)])
def test_compute_losses_sdf_terms_match_jax(iter_step, alpha_max):
    """Every SDF term and the total, and the loss's gradient with respect
    to each differentiable input, against JAX's compute_losses, at steps
    on both sides of the silhouette alpha's milestones, with and
    without `sdf_mask_alpha_max`."""
    ret, batch = loss_inputs(iter_step % 97)
    diff = ("rgb_map", "resd", "gradients", "observed_gradients", "msk_sdf")
    t_ret = {k: torch.tensor(v, requires_grad=k in diff) for k, v in ret.items()}
    loss, stats = compute_losses(t_ret, {k: torch.tensor(v) for k, v in
                                         batch.items()},
                                 iter_step, mask_alpha_max=alpha_max)

    def j_loss(d):
        return j_compute_losses({**{k: jnp.asarray(v) for k, v in ret.items()},
                                 **d}, {k: jnp.asarray(v) for k, v in batch.items()},
                                iter_step, mask_alpha_max=alpha_max)

    (j_total, j_stats), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(ret[k]) for k in diff})
    assert set(stats) == set(j_stats) == {
        "offset_loss", "grad_loss", "ograd_loss", "mask_loss", "img_loss",
        "loss"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(loss), float(j_total), rtol=1e-6)
    loss.backward()
    for k in diff:
        g, w = t_ret[k].grad.numpy(), np.asarray(j_grads[k])
        assert np.isfinite(g).all(), k
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), k
    assert np.all(t_ret["resd"].grad.numpy()[::7] == 0)


@pytest.mark.parametrize("iter_step", [0, 9999, 10000, 10001, 20000, 20001,
                                       30001, 40001, 50000, 50001, 10 ** 6])
@pytest.mark.parametrize("alpha_max", [0.0, 100.0, 1000.0])
def test_sdf_mask_alpha_matches_jax(iter_step, alpha_max):
    assert sdf_mask_alpha(iter_step, alpha_max) == float(
        j_sdf_mask_alpha(iter_step, alpha_max))


@pytest.mark.parametrize("key", ["compact_overflow", "compact_overflow_stage2"])
def test_sdf_losses_refuse_compaction_stats(key):
    ret, batch = loss_inputs(0)
    t_ret = {k: torch.tensor(v) for k, v in ret.items()}
    t_ret[key] = torch.zeros(())
    with pytest.raises(NotImplementedError, match=key):
        compute_losses(t_ret, {k: torch.tensor(v) for k, v in batch.items()})


# ------------------------------------------------------------- steps
def test_train_step_matches_jax(cfgs, params, datasets, jax_side):
    """One step from the tracked weights and a fresh Adam: loss, stats,
    every gradient leaf, the update alone and the whole step."""
    tc = cfgs[1]
    jb, tb = batches(datasets, 4, 0)
    j_loss, j_stats, _, j_grads = jax_side.loss_grad(jb, jax_side.state0.params)
    j_state, _ = jax_side.step(jax_side.state0, jb, jax.random.PRNGKey(0))

    trainer = port_trainer(tc, params)
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    want_g = leaves(j_grads)
    assert_grads_close(port_grads(trainer.model), want_g)

    p0 = leaves(jax_side.state0.params)
    trainer.apply_gradients()
    got, want = port_params(trainer.model), leaves(j_state.params)
    for k, w in want.items():
        g_tol = GRAD_REL * np.abs(want_g[k]).max()
        resolved = np.abs(want_g[k]) > 100 * g_tol
        d = np.abs(got[k] - w)
        assert np.isfinite(got[k]).all(), k
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(w - p0[k]).max() <= LR * (1 + 1e-3), k

    trainer = port_trainer(tc, params)
    set_grads(trainer.model, j_grads)
    trainer.apply_gradients()
    want = leaves(jax_side.apply(jax_side.state0, j_grads).params)
    for k, g in port_params(trainer.model).items():
        np.testing.assert_allclose(g, want[k], rtol=ULP,
                                   atol=ADAM_SAME_GRAD_TOL, err_msg=k)


def test_observed_eikonal_gradient_reaches_the_displacement_field(
        cfgs, params, datasets, jax_side):
    """The gradient of ograd_loss alone: through sdf(x + resd(x)) it
    reaches the displacement field only by K1's gradient of a gradient.
    Every leaf within GRAD_REL of JAX's, the displacement field's leaves
    nonzero."""
    jb, tb = batches(datasets, 4, 0)
    want = leaves(jax_side.ograd(jax_side.state0.params, jax_side.frame(jb)))
    trainer = port_trainer(cfgs[1], params)
    _, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    stats["ograd_loss"].backward()
    got = port_grads(trainer.model)
    assert_grads_close(got, want)
    for k in want:
        if k.startswith(RESD_LEAF) and "['out']['bias']" not in k:
            assert np.abs(got[k]).max() > 0, k


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
                                   rtol=LOSS_RTOL)
        _, _, _, j_grads = jax_side.loss_grad(jb, applied.params,
                                              int(applied.step))
        applied = jax_side.apply(applied, j_grads)
        set_grads(fed.model, j_grads)
        fed.apply_gradients()
    assert trainer.step == trainer.updates == int(state.step) == 3
    want = leaves(applied.params)
    for k, g in port_params(fed.model).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)
    assert all(np.isfinite(v).all() for v in port_params(trainer.model).values())


# --------------------------------------------------- params, checkpoints
def test_param_tree_round_trips_the_tracked_checkpoint(params):
    tree = sdf_pdf_param_tree(sdf_pdf_state_dict(params))
    assert leaves(tree).keys() == leaves(params).keys()
    for k, v in leaves(params).items():
        got = leaves(tree)[k]
        assert got.dtype == np.float32 and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    named = dict(sdf_pdf_state_dict(params))
    named["tpose_human.extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError):
        sdf_pdf_param_tree(named)


def trained(tc, params, datasets, steps=2):
    trainer = port_trainer(tc, params)
    for i in range(steps):
        trainer.train_step(batches(datasets, i, i)[1])
    return trainer


def test_port_checkpoint_reads_in_jax(tmp_path, cfgs, params, datasets,
                                      jax_side):
    trainer = trained(cfgs[1], params, datasets)
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 3,
                    trainer.step, {"step": 2}, latest=True)
    st = jax_side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path), st.params, st.opt_state)
    assert (epoch, step, rec) == (3, 2, {"step": 2})
    mine = port_params(trainer.model)
    assert leaves(j_params).keys() == mine.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam, sched = j_opt[1]
    assert int(adam.count) == int(sched.count) == count == 2
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(as_flax(sdf_pdf_param_tree(ours)))
        for k, v in leaves(theirs).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_jax_checkpoint_resumes_in_port(tmp_path, cfgs, params, datasets,
                                        jax_side):
    jb, _ = batches(datasets, 4, 0)
    state, _ = jax_side.step(jax_side.state0, jb, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = port_trainer(cfgs[1], params)
    out = load_checkpoint(str(tmp_path), trainer.model, trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    for k, v in port_params(trainer.model).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam = state.opt_state[1][0]
    assert count == int(adam.count) == 1
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in leaves(as_flax(sdf_pdf_param_tree(ours))).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    blob = open(tmp_path / "0.flax", "rb").read()
    assert flax_msgpack.msgpack_serialize(flax_msgpack.msgpack_restore(blob)) == blob


def fresh_model(tc, seed=42):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return t_engine.make_model(tc)


def test_init_sdf_loads_only_the_sdf_network(cfgs, params):
    """`init_sdf synthetic_sdf_pdf` reads data/trained_model/deform/
    synthetic_sdf_pdf: the SDF network takes its weights; every other
    parameter keeps its fresh value."""
    tc = load_config(CFG, OPTS + ["init_sdf", "synthetic_sdf_pdf"])
    model, fresh = fresh_model(tc), fresh_model(tc)
    t_engine.load_init_sdf(tc, model)
    want = sdf_pdf_state_dict(params)
    n_sdf = 0
    for name, p in model.named_parameters():
        if name.startswith("tpose_human.sdf_network."):
            torch.testing.assert_close(p.detach(), want[name].reshape(p.shape),
                                       rtol=0, atol=0)
            n_sdf += 1
        else:
            assert torch.equal(p, dict(fresh.named_parameters())[name]), name
    assert n_sdf == 27
    missing = load_config(CFG, OPTS + ["init_sdf", "no_such_run"])
    with pytest.raises(FileNotFoundError, match="init_sdf"):
        t_engine.load_init_sdf(missing, fresh_model(missing))


@pytest.mark.parametrize("layout", ["sdf_network_only", "no_sdf_network",
                                    "under_tpose_human"])
def test_init_sdf_reads_a_partial_checkpoint_as_jax(tmp_path, monkeypatch,
                                                    cfgs, params, jax_side,
                                                    layout):
    """An `init_sdf` file that lacks the other modules (an SDF-only
    pretrain, no optimizer state) loads as JAX's `load_params_partial`
    loads it: the SDF network where the SDFPDF layout has one, nothing
    otherwise; every other parameter keeps its fresh value."""
    # doubled, so that what loads differs from JAX's template (the
    # tracked weights) as well as from the port's fresh init
    inner = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2,
                                   params["params"])
    tree = {
        "sdf_network_only": {"sdf_network": inner["sdf_network"]},
        "no_sdf_network": {"resd_field": inner["resd_field"],
                           "beta_network": inner["beta_network"]},
        "under_tpose_human": {"tpose_human": {
            "sdf_network": inner["sdf_network"]}},
    }[layout]
    run = tmp_path / "data/trained_model/deform/partial"
    run.mkdir(parents=True)
    flax_msgpack.write_checkpoint(str(run / "latest.flax"),
                                  {"params": {"params": tree}})
    tc = load_config(CFG, OPTS + ["init_sdf", "partial"])
    model, fresh = fresh_model(tc), fresh_model(tc)
    monkeypatch.chdir(tmp_path)
    t_engine.load_init_sdf(tc, model)
    template = jax_side.state0.params
    j_params = j_load_params_partial(
        str(run), template,
        only=["params/tpose_human/sdf_network", "params/sdf_network"],
        strict=False)
    j_loaded = {k: not np.array_equal(v, leaves(template)[k])
                for k, v in leaves(j_params).items()}
    mine = port_params(model)
    for k, v in leaves(j_params).items():
        if "sdf_network" in k and j_loaded[k]:
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    loaded = {n for n, p in model.named_parameters()
              if not torch.equal(p, dict(fresh.named_parameters())[n])}
    assert all(n.startswith("tpose_human.sdf_network.") for n in loaded)
    assert len(loaded) == (27 if layout == "sdf_network_only" else 0)
    assert sum(j_loaded.values()) == len(loaded)


def test_fresh_init_follows_the_jax_rules(cfgs):
    """The SDF network's geometric init as JAX's `geometric_mlp_params`:
    the same zero pattern, biases and g = ||v||, the same scale per
    layer; the displacement field's biases zero, lecun-normal kernels;
    the color network's g = ||v||."""
    model = fresh_model(cfgs[1])
    sdf = model.tpose_human.sdf_network
    d_pe = 39
    dims = [d_pe] + [256] * 8 + [257]
    ref = geometric_mlp_params(jax.random.PRNGKey(0), dims, [4], bias=0.5)
    assert sdf.n_linear == len(ref) == 9
    for l, r in enumerate(ref):
        lin = getattr(sdf, f"lin{l}")
        v = lin.weight_v.detach().numpy().T  # (in, out), as JAX's
        rv = np.asarray(r["v"])
        assert v.shape == rv.shape, l
        np.testing.assert_array_equal(v == 0, rv == 0, err_msg=str(l))
        np.testing.assert_array_equal(lin.bias.detach().numpy(), np.asarray(r["b"]))
        np.testing.assert_allclose(lin.weight_g.detach().numpy()[:, 0],
                                   np.linalg.norm(v, axis=0), rtol=1e-6)
        # the same law: means within 5 standard errors of each other,
        # standard deviations within 5 standard errors of their estimate
        nz = rv != 0
        n = nz.sum()
        np.testing.assert_allclose(v[nz].mean(), rv[nz].mean(),
                                   atol=5 * rv[nz].std() * np.sqrt(2.0 / n))
        np.testing.assert_allclose(v[nz].std(), rv[nz].std(),
                                   rtol=5 * np.sqrt(1.0 / n))
    assert np.all(sdf.lin0.weight_v.detach().numpy()[:, 3:] == 0)
    assert np.all(sdf.lin4.weight_v.detach().numpy()[:, -36:] == 0)
    assert np.all(sdf.lin8.bias.detach().numpy() == -0.5)
    for lin in [*model.resd_linears, model.resd_fc]:
        # lecun_normal: variance 1 / fan_in, truncated at 2 sigma of the
        # underlying normal (std / 0.8796)
        w = lin.weight.detach()
        std = np.sqrt(1.0 / w.shape[1])
        assert torch.all(lin.bias == 0)
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
        assert abs(w.std().item() / std - 1.0) <= 5 * np.sqrt(0.5 / w.numel())
    for l in range(5):
        lin = getattr(model.tpose_human.color_network, f"lin{l}")
        torch.testing.assert_close(lin.weight_g, torch.linalg.norm(
            lin.weight_v, dim=1, keepdim=True))
    # the geometric init makes an sdf near |x| - 0.5
    x = torch.tensor([[0.0, 0.0, 0.0], [0.9, 0.0, 0.0], [0.0, -0.2, 0.1]])
    with torch.no_grad():
        out = sdf(x)[:, 0]
    assert out[0] < 0 < out[1]
    assert float(model.tpose_human.beta_network.beta) == pytest.approx(0.1)


# ------------------------------------------------------------ the CLI
def test_run_train_writes_a_checkpoint_jax_evaluates(tmp_path, jax_side):
    """One CPU epoch of 2 steps through the CLI, from a fresh start on
    the tracked weights: the checkpoint carries the counters and the
    JAX package's evaluate loader reads it."""
    opts = OPTS + ["trained_model_dir", str(tmp_path / "model"),
                   "record_dir", str(tmp_path / "record"), "ep_iter", "2",
                   "save_ep", "1", "save_latest_ep", "1", "fix_random", "True",
                   "train.epoch", "1", "log_interval", "1", "record_interval", "1"]
    tc = load_config(CFG, opts)
    write_fresh_start(CKPT, tc.trained_model_dir)
    train_net.main(["--cfg_file", CFG, "--device", "cpu", *opts])
    assert sorted(os.listdir(tc.trained_model_dir)) == ["0.flax", "latest.flax"]
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc.trained_model_dir, "latest.flax"))
    assert int(raw["epoch"]) == 0 and int(raw["step"]) == 2
    assert int(raw["opt_state"]["1"]["0"]["count"]) == 2
    jc = j_load_config(CFG, opts)
    jc.trained_model_dir = tc.trained_model_dir
    loaded = j_engine.Engine(jc).load_params(jax_side.state0.params)
    for k, v in leaves(loaded).items():
        np.testing.assert_array_equal(
            v, leaves(as_flax(raw["params"]))[k], err_msg=k)
        assert np.isfinite(v).all(), k


def test_run_train_needs_a_gpu_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = load_config(CFG, OPTS + ["trained_model_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_engine.run_train(tc)
