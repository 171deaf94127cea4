"""NeRF-PDF and NeuS-PDF training on the CPU: the port against the JAX
package on the same numpy-seeded inputs and the same weights (the
tracked checkpoints of configs/synthetic_nerf_pdf.yaml and
configs/synthetic_neus_pdf.yaml), at full widths (8x256 displacement
field, 9-layer NeRF or SDF network) with 64 rays of 16 samples and
`perturb 0`. Both families train on SDF-PDF's dense path
(`_PDFBase._train_warp`), whose K1 and K2 parts, train split and
silhouette tensors tests/test_torch_train_sdf.py holds to JAX.

Tolerances (those of tests/test_torch_train_sdf.py, whose reasons hold
here):
  * The dense train forward: the filter masks may differ only on points
    whose weighted KNN distance lies within FLIP_BAND of the 0.1
    threshold, at most MAX_FLIPS of them; the maps, raw, NeuS's sdf grid
    and its silhouette distance, and on the points both keep resd and
    NeuS's two normals, within MAP_TOL (float32 trunks summed in another
    order, the rounding of the canonical points multiplied by the PE);
    the silhouette masks equal. The observed-space normals may differ
    beyond MAP_TOL only where a displacement-field unit lies within
    KINK_BAND of its relu kink (the reason is at KINK_BAND).
  * `neus_alpha`: values within 1e-6, gradients with respect to the
    sdf grid and the inverse variance within 1e-6 of each tensor's scale
    (float32 in another order). The clip alone: equal, and its gradient
    equal to jnp.clip's, which is 0.5 at a bound where torch.clamp's is
    1.
  * Loss and stats of a step: rtol LOSS_RTOL = 1e-4. Gradients per leaf:
    max |d| <= GRAD_REL x max |g| with GRAD_REL = 1e-2. Adam's update as
    in tests/test_torch_train_sdf.py: from JAX's gradient within 1e-7 of
    JAX's optimizer or one float32 ulp of the parameter; from the port's
    own, within 1e-6 where the gradient's direction is resolved (the JAX
    gradient over 100 x its tolerance), else within 2 lr.
  * Three steps: the first step's loss within LOSS_RTOL of
    `Trainer._train_step`'s; three updates of the port's Adam from JAX's
    gradients within 1e-6 of JAX's optimizer, and at those weights each
    step's loss within LOSS_RTOL of JAX's; the port's own three steps
    within 2 lr a step of `Trainer._train_step`'s weights (the reason is
    in the test).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.sdf import neus_alpha as j_neus_alpha
from animatable_nerf_tpu.fields.fields import (
    SingleVarianceNetwork as JSingleVarianceNetwork,
)
from animatable_nerf_tpu.fields.mlp import geometric_mlp_params
from animatable_nerf_tpu.render.renderer import render_rays as j_render_rays
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    load_params_partial as j_load_params_partial,
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
from animatable_nerf_tpu_torch import train_net
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.jax_params import (
    nerf_pdf_param_tree,
    nerf_pdf_state_dict,
    neus_pdf_param_tree,
    neus_pdf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.encoding import positional_encoding
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.core.numerics import clip
from animatable_nerf_tpu_torch.core.sdf import neus_alpha
from animatable_nerf_tpu_torch.fields.fields import SingleVarianceNetwork
from animatable_nerf_tpu_torch.models.pdf import SDF_FILL, NeRFPDF, NeuSPDF
from animatable_nerf_tpu_torch.train.checkpoints import (
    adam_moments,
    load_checkpoint,
    save_checkpoint,
    write_fresh_start,
)
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
NORM_TH = 0.1
FLIP_BAND = 1e-5
MAX_FLIPS = 4
MAP_TOL = 1e-4
# a displacement-field unit within KINK_BAND of its relu kink at a point
# may sit on the other side of it in JAX, whose canonical points round
# otherwise (times the PE's 512 at its top frequency): its Jacobian, so
# the observed-space normal there, then jumps (measured 0.0196 on one
# NeuS-PDF point with a unit at 4.5e-6, where the port agrees with a
# float64 evaluation to 1e-7)
KINK_BAND = 1e-4
MAX_KINKS = 4
ALPHA_TOL = 1e-6
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
ADAM_SAME_GRAD_TOL = 1e-7
ULP = 2.0 ** -23  # one float32 ulp, relative
ADAM_RESOLVED_TOL = 1e-6
STEPS_PARAM_TOL = 1e-6
LR = 5e-4
# family: (model, state dict of a JAX tree, its inverse, the canonical
# GeometricFieldNetwork, the stats of its loss)
FAMILIES = {
    "nerf_pdf": (NeRFPDF, nerf_pdf_state_dict, nerf_pdf_param_tree,
                 "nerf_network", {"offset_loss", "img_loss", "loss"}),
    "neus_pdf": (NeuSPDF, neus_pdf_state_dict, neus_pdf_param_tree,
                 "sdf_network", {"offset_loss", "grad_loss", "ograd_loss",
                                 "mask_loss", "img_loss", "loss"}),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    return f"configs/synthetic_{family}.yaml"


def ckpt(family):
    return f"data/trained_model/deform/synthetic_{family}/latest.flax"


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_flax(tree, net):
    """A param tree as flax holds it: the canonical network `net`'s
    layers a list (a msgpack file, and the port's param trees, key them
    "0", "1", ...)."""
    inner = dict(tree["params"])
    layers = inner[net]["layers"]
    if isinstance(layers, dict):
        inner[net] = {"layers": [layers[str(i)] for i in range(len(layers))]}
    return {"params": inner}


class Side:
    """One family's configs, tracked weights, train datasets, and the
    JAX trainer with its jitted `_train_step`, a jitted twin of
    `_loss_one` that also returns the render and the gradient, and
    Adam's update alone."""

    def __init__(self, family):
        self.family = family
        _, self.state_dict, self.param_tree, self.net, self.stats = (
            FAMILIES[family])
        self.jc = j_load_config(cfg_file(family), OPTS)
        self.tc = load_config(cfg_file(family), OPTS)
        self.params = flax_msgpack.read_checkpoint(ckpt(family))["params"]
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
        p = jax.tree_util.tree_map(jnp.asarray, self.as_flax(self.params))
        self.state0 = TrainState(p, tr.tx.init(p), jnp.asarray(0))

    def as_flax(self, tree):
        return as_flax(tree, self.net)

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

    def port_trainer(self, tc=None):
        tc = tc or self.tc
        model = t_engine.make_model(tc)
        model.load_state_dict(self.state_dict(self.params), strict=True)
        return Trainer(tc, model, "cpu")

    def port_tree(self, named):
        return leaves(self.as_flax(self.param_tree(named)))

    def port_grads(self, model):
        return self.port_tree({n: torch.zeros_like(p) if p.grad is None
                               else p.grad for n, p in model.named_parameters()})

    def port_params(self, model):
        return self.port_tree(dict(model.named_parameters()))

    def set_grads(self, model, j_grads):
        named = self.state_dict(j_grads)
        for name, p in model.named_parameters():
            p.grad = named[name].reshape(p.shape).clone()


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def side(request):
    return Side(request.param)


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_REL * np.abs(w).max(), (k, err, np.abs(w).max())


def near_relu_kink(model, batch, ret):
    """Per point of the step, whether a hidden unit of the displacement
    field lies within KINK_BAND of its relu kink at the point's
    init_bigpose (the port's)."""
    frame = {k: torch.as_tensor(np.asarray(batch[k], np.float32))
             for k in model.train_frame_keys}
    rays_o = torch.as_tensor(np.asarray(batch["ray_o"]))
    rays_d = torch.as_tensor(np.asarray(batch["ray_d"]))
    z = ret["z_vals"]
    wpts = rays_o[:, None] + z[..., None] * rays_d[:, None]
    with torch.no_grad():
        _, init_bigpose, _, _, _, _ = model._train_warp(wpts, rays_d, z, frame)
        pe = positional_encoding(init_bigpose, model.xyz_res)
        h = feat = torch.cat([pe, frame["poses"].expand(len(pe), 72)], dim=-1)
        near = torch.zeros(len(pe), dtype=torch.bool)
        for i, lin in enumerate(model.resd_linears):
            h = lin(h)
            near |= (h.abs() < KINK_BAND).any(dim=-1)
            h = torch.relu(h)
            if i == 4:
                h = torch.cat([feat, h], dim=-1)
    return near.numpy()


def fresh_model(tc, seed=42):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return t_engine.make_model(tc)


# ------------------------------------------------------- the forward
@pytest.mark.parametrize("index,seed", [(4, 0), (9, 5)])
def test_dense_train_forward_matches_jax(side, index, seed):
    """`train_forward` against JAX's `__call__(train=True)` through both
    renderers: the filter, the maps and each family's outputs (NeRF-PDF:
    raw, resd; NeuS-PDF also the sdf grid, both normals and the
    silhouette tensors)."""
    jb, tb = side.batches(index, seed)
    _, _, j_ret, _ = side.loss_grad(jb, side.state0.params)
    trainer = side.port_trainer()
    batch = {k: v[0] for k, v in tb.items()}
    _, _, ret = trainer.loss(batch)
    assert set(ret) == set(j_ret)

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

    maps = ["raw", "rgb_map", "acc_map"]
    points = ["resd"]
    if side.family == "neus_pdf":
        maps += ["sdf", "msk_sdf"]
        points += ["gradients", "observed_gradients"]
        for k in ("grad_mask", "observed_grad_mask"):
            d = np.nonzero(ret[k].numpy() != np.asarray(j_ret[k]))[0]
            assert set(d) <= set(flips), k
        assert ret["observed_grad_mask"].sum() > 0
        for k in ("msk_free", "msk_in"):
            np.testing.assert_array_equal(ret[k].numpy(), np.asarray(j_ret[k]),
                                          err_msg=k)
    for k in maps:
        g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0, atol=MAP_TOL, err_msg=k)
    for k in points:
        g, w = ret[k].detach().numpy(), np.asarray(j_ret[k])
        assert g.shape == w.shape, k
        held = both.copy()
        if k == "observed_gradients":
            off = both & (np.abs(g - w).max(axis=-1) > MAP_TOL)
            assert off.sum() <= MAX_KINKS
            assert np.all(near_relu_kink(trainer.model, batch, ret)[off])
            held &= ~off
        np.testing.assert_allclose(g[held], w[held], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert float(ret["acc_map"].detach().max()) > 0.1


# ------------------------------------------------- NeuS's alpha, clips
def neus_case(kind):
    """An (R, S) sdf grid and an inverse variance: random crossings; rays
    of SDF_FILL with a few survivors; and ties, deep inside samples at a
    large inverse variance, whose cdf (1e-26 to 1e-13) is below the
    rounding of the sample before, so that sample's alpha is exactly 1
    (where the sigmoid underflows to exactly 0, its gradient is NaN in
    both packages)."""
    rng = np.random.RandomState({"random": 0, "fill": 1, "ties": 2}[kind])
    z = np.linspace(-0.3, 0.3, 16, dtype=np.float32)
    sdf = (z[None] * rng.uniform(-1.5, 1.5, (24, 1))
           + rng.normal(0, 0.02, (24, 16))).astype(np.float32)
    inv_var = 20.0
    if kind == "fill":
        sdf[rng.rand(24, 16) < 0.7] = SDF_FILL
    elif kind == "ties":
        sdf[::2, 8:] = rng.uniform(-0.6, -0.3, (12, 8))
        inv_var = 100.0
    return sdf, np.float32(inv_var)


@pytest.mark.parametrize("kind", ["random", "fill", "ties"])
def test_neus_alpha_value_and_gradient_match_jax(kind):
    """`neus_alpha`'s value and its vjp with respect to the sdf grid and
    the inverse variance against JAX's, exact clip ties included."""
    sdf, inv_var = neus_case(kind)
    cot = np.random.RandomState(7).randn(*sdf.shape).astype(np.float32)

    def j_loss(s, v):
        a = j_neus_alpha(s, v)
        return jnp.sum(a * cot), a

    (_, j_alpha), (j_ds, j_dv) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(sdf),
                                              jnp.asarray(inv_var))
    s = torch.tensor(sdf, requires_grad=True)
    v = torch.tensor(inv_var, requires_grad=True)
    alpha = neus_alpha(s, v)
    (alpha * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(j_alpha),
                               rtol=0, atol=ALPHA_TOL)
    for got, want in ((s.grad, j_ds), (v.grad, j_dv)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= ALPHA_TOL * max(
            1.0, np.abs(want).max())
    if kind == "ties":
        assert (alpha.detach() == 1.0).sum() >= 12


def test_clip_gradient_matches_jnp_clip_at_the_bounds():
    """`numerics.clip` at and off the bounds of neus_alpha's and the
    variance network's clips: values and gradients equal to jnp.clip's."""
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0, 1e-6, 1e6, 3e6], np.float32)
    cot = np.arange(1, 9, dtype=np.float32)
    for lo, hi in ((0.0, 1.0), (1e-6, 1e6)):
        want = jax.grad(lambda t: jnp.sum(jnp.clip(t, lo, hi) * cot))(
            jnp.asarray(x))
        t = torch.tensor(x, requires_grad=True)
        y = clip(t, lo, hi)
        (y * torch.tensor(cot)).sum().backward()
        np.testing.assert_array_equal(y.detach().numpy(),
                                      np.asarray(jnp.clip(x, lo, hi)))
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [0.2, -0.3, 1.5])
def test_variance_network_value_and_gradient_match_jax(s):
    """exp(10 s) clipped to [1e-6, 1e6] and its gradient with respect to
    s, inside the clip and beyond its upper bound (zero gradient)."""
    net = JSingleVarianceNetwork()
    params = {"params": {"variance": jnp.asarray(s, jnp.float32)}}
    value, grad = jax.value_and_grad(lambda p: net.apply(p))(params)
    port = SingleVarianceNetwork()
    with torch.no_grad():
        port.variance.fill_(s)
    got = port()
    got.backward()
    np.testing.assert_allclose(float(got), float(value), rtol=1e-6)
    np.testing.assert_allclose(float(port.variance.grad),
                               float(grad["params"]["variance"]), rtol=1e-6)


# ------------------------------------------------------------- steps
def test_train_step_matches_jax(side):
    """One step from the tracked weights and a fresh Adam: loss, stats,
    every gradient leaf (NeuS's 0-dim variance included), the update
    alone and the whole step."""
    jb, tb = side.batches(4, 0)
    j_loss, j_stats, _, j_grads = side.loss_grad(jb, side.state0.params)
    j_state, _ = side.step(side.state0, jb, jax.random.PRNGKey(0))

    trainer = side.port_trainer()
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=LOSS_RTOL)
    assert set(stats) == set(j_stats) == side.stats
    for k, v in stats.items():
        np.testing.assert_allclose(float(v.detach()), j_stats[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    want_g = leaves(j_grads)
    assert_grads_close(side.port_grads(trainer.model), want_g)

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
    """Three steps of `Trainer._train_step` against the port. The first
    step's loss within LOSS_RTOL. Fed JAX's gradients, the port's Adam
    follows JAX's weights within STEPS_PARAM_TOL, and at those weights
    each step's loss (the port's render and loss) is within LOSS_RTOL of
    JAX's. On its own gradients the port drifts from JAX's weights by up
    to 2 lr a step where a gradient lies within its rounding (Adam
    scales it to a full step of either sign; measured after three
    NeRF-PDF steps 7.2e-4, moving the loss by 1.1e-4 relative, while the
    loss at JAX's weights agreed to 5e-7; two JAX programs of the same
    step drift so from each other), so its later losses are held only
    to be finite."""
    trainer = side.port_trainer()
    fed = side.port_trainer()  # the port's Adam fed JAX's gradients
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
    assert fed.step == fed.updates == 3
    want = leaves(applied.params)
    for k, g in side.port_params(fed.model).items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=STEPS_PARAM_TOL,
                                   err_msg=k)
    assert all(np.isfinite(v).all()
               for v in side.port_params(trainer.model).values())


# --------------------------------------------------- checkpoints, init
def test_port_checkpoint_reads_in_jax(tmp_path, side):
    """Two port steps saved: JAX's `load_checkpoint` restores the params,
    the counters and Adam's moments (NeuS's 0-dim variance included)."""
    trainer = side.port_trainer()
    for i in range(2):
        trainer.train_step(side.batches(i, i)[1])
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 3,
                    trainer.step, {"step": 2}, latest=True)
    st = side.state0
    j_params, j_opt, epoch, step, rec = j_load_checkpoint(
        str(tmp_path), st.params, st.opt_state)
    assert (epoch, step, rec) == (3, 2, {"step": 2})
    mine = side.port_params(trainer.model)
    assert leaves(j_params).keys() == mine.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(leaves(j_params)[k], v, err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam, sched = j_opt[1]
    assert int(adam.count) == int(sched.count) == count == 2
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = side.port_tree(ours)
        for k, v in leaves(theirs).items():
            assert v.shape == want[k].shape, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_jax_checkpoint_resumes_in_port(tmp_path, side):
    jb, _ = side.batches(4, 0)
    state, _ = side.step(side.state0, jb, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), state.params, state.opt_state, 0,
                      int(state.step), {"step": 1})
    trainer = side.port_trainer()
    out = load_checkpoint(str(tmp_path), trainer.model, trainer.optimizer)
    assert out == (0, 1, 1, {"step": 1})
    _, trainer.step, trainer.updates, _ = out
    for k, v in side.port_params(trainer.model).items():
        np.testing.assert_array_equal(v, leaves(state.params)[k], err_msg=k)
    count, mu, nu = adam_moments(trainer.model, trainer.optimizer)
    adam = state.opt_state[1][0]
    assert count == int(adam.count) == 1
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        want = leaves(theirs)
        for k, v in side.port_tree(ours).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    # the resumed Adam takes the next step as JAX's would
    trainer.train_step(side.batches(7, 1)[1])
    assert trainer.step == trainer.updates == 2 and all(
        np.isfinite(v).all() for v in side.port_params(trainer.model).values())


def test_neus_init_sdf_loads_only_the_sdf_network_as_jax():
    """`init_sdf synthetic_sdf_pdf` on NeuS-PDF reads the SDF-PDF run's
    checkpoint: the SDF network takes its weights, as JAX's partial load
    into a NeuSPDF gives them, and every other parameter keeps its fresh
    value."""
    tc = load_config(cfg_file("neus_pdf"), OPTS + ["init_sdf",
                                                   "synthetic_sdf_pdf"])
    model, fresh = fresh_model(tc), fresh_model(tc)
    t_engine.load_init_sdf(tc, model)
    template = as_flax(flax_msgpack.read_checkpoint(ckpt("neus_pdf"))["params"],
                       "sdf_network")
    j_params = j_load_params_partial(
        "data/trained_model/deform/synthetic_sdf_pdf", template,
        only=["params/tpose_human/sdf_network", "params/sdf_network"],
        strict=False)
    want, before = leaves(j_params), leaves(template)
    j_loaded = {k for k, v in want.items() if not np.array_equal(v, before[k])}
    assert j_loaded and all("['sdf_network']" in k for k in j_loaded)
    mine = leaves(as_flax(neus_pdf_param_tree(dict(model.named_parameters())),
                          "sdf_network"))
    for k in j_loaded:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
    loaded = {n for n, p in model.named_parameters()
              if not torch.equal(p, dict(fresh.named_parameters())[n])}
    assert all(n.startswith("tpose_human.sdf_network.") for n in loaded)
    assert len(loaded) == len(j_loaded) == 27


def test_fresh_init_follows_the_jax_rules(side):
    """The canonical network's geometric init as JAX's
    `geometric_mlp_params` (the same zero pattern and biases, g = ||v||),
    the displacement field's biases zero, the color network's g = ||v||,
    and NeuS's variance at JAX's initial value."""
    model = fresh_model(side.tc)
    net = getattr(model.tpose_human, side.net)
    dims = [39] + [256] * 8 + [257]
    ref = geometric_mlp_params(jax.random.PRNGKey(0), dims, [4], bias=0.5)
    assert net.n_linear == len(ref) == 9
    for l, r in enumerate(ref):
        lin = getattr(net, f"lin{l}")
        v = lin.weight_v.detach().numpy().T  # (in, out), as JAX's
        rv = np.asarray(r["v"])
        assert v.shape == rv.shape, l
        np.testing.assert_array_equal(v == 0, rv == 0, err_msg=str(l))
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      np.asarray(r["b"]))
        np.testing.assert_allclose(lin.weight_g.detach().numpy()[:, 0],
                                   np.linalg.norm(v, axis=0), rtol=1e-6)
    for lin in [*model.resd_linears, model.resd_fc]:
        assert torch.all(lin.bias == 0)
    for l in range(5):
        lin = getattr(model.tpose_human.color_network, f"lin{l}")
        torch.testing.assert_close(lin.weight_g, torch.linalg.norm(
            lin.weight_v, dim=1, keepdim=True))
    if side.family == "neus_pdf":
        j_var = JSingleVarianceNetwork().init(jax.random.PRNGKey(42))
        assert model.tpose_human.variance_network.variance.item() == float(
            j_var["params"]["variance"])
    # the geometric init puts channel 0 near |x| - 0.5
    x = torch.tensor([[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]])
    with torch.no_grad():
        out = net(x)[:, 0]
    assert out[0] < 0 < out[1]


# ------------------------------------------------------------ the CLI
def test_run_train_writes_a_checkpoint_jax_evaluates(tmp_path, side):
    """One CPU epoch of 2 steps through the CLI: NeRF-PDF from a fresh
    start on the tracked weights, NeuS-PDF a fresh run (`resume False`)
    from `init_sdf synthetic_sdf_pdf`. The checkpoint carries the
    counters and the JAX package's evaluate loader reads it."""
    opts = OPTS + ["trained_model_dir", str(tmp_path / "model"),
                   "record_dir", str(tmp_path / "record"), "ep_iter", "2",
                   "save_ep", "1", "save_latest_ep", "1", "fix_random", "True",
                   "train.epoch", "1", "log_interval", "1", "record_interval", "1"]
    if side.family == "neus_pdf":
        opts += ["resume", "False", "init_sdf", "synthetic_sdf_pdf"]
    tc = load_config(cfg_file(side.family), opts)
    if side.family == "nerf_pdf":
        write_fresh_start(ckpt(side.family), tc.trained_model_dir)
    train_net.main(["--cfg_file", cfg_file(side.family), "--device", "cpu",
                    *opts])
    assert sorted(os.listdir(tc.trained_model_dir)) == ["0.flax", "latest.flax"]
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc.trained_model_dir, "latest.flax"))
    assert int(raw["epoch"]) == 0 and int(raw["step"]) == 2
    assert int(raw["opt_state"]["1"]["0"]["count"]) == 2
    jc = j_load_config(cfg_file(side.family), opts)
    jc.trained_model_dir = tc.trained_model_dir
    loaded = j_engine.Engine(jc).load_params(side.state0.params)
    for k, v in leaves(loaded).items():
        np.testing.assert_array_equal(
            v, leaves(side.as_flax(raw["params"]))[k], err_msg=k)
        assert np.isfinite(v).all(), k
