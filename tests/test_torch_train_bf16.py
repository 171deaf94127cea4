"""Training in `compute_dtype bfloat16` on the CPU: the port's bf16 train
steps against the JAX package's, which builds every family's fields in
bf16 through `make_model` and differentiates its XLA trunks with
jax.grad (params, optimizer, geometry, compositing and loss in
float32).

* K1's gradient in bf16 (ops/skip_mlp.py `SkipMLPFunction`, its
  backward the vjp of the plain bf16 form) against jax.grad of JAX's
  `SkipMLP(dtype=bfloat16)`, and its second derivative under
  create_graph (the SDF families' eikonal term differentiates the
  observed-space normal, K1 inside it).
* The bf16 heads: `linear` against flax's `Dense(dtype=bfloat16)`, the
  weight-normalized layer against `WNDense(dtype=bfloat16)`; their
  float32 parameters receive float32 gradients.
* One bf16 step of AniNeRF, SDF-PDF (its double backward), NeRF-PDF and
  AlignedLBW against JAX's `_train_step` at 64 rays x 16 samples from
  the tracked (or composed) weights; the compacted AniNeRF step; one
  AniNeRF stage-2 step.
* Eight bf16 steps of the port against its float32 steps, within JAX's
  own 5% bound (tests/test_trainer.py `test_bf16_train_trajectory_
  tracks_f32`).

Tolerances:
  * K1's gradient: x and every weight within X_W_REL = 2^-7 of the
    leaf's largest entry (bit-equal at 64-256 rows; at 4,096 rows the
    float32 sums of the two packages, taken in another order, round to
    a neighbouring bf16 value: up to 2.3e-3 measured). Biases within
    BIAS_REL = 2^-5: JAX's XLA on the CPU sums a bias's bf16 cotangents
    over the rows with bf16 partial sums (0.5-1.5% of the leaf's largest
    entry from the exact sum, measured at 64-4,096 rows), the port sums
    them in float32 and rounds once. The second derivative: within
    X_W_REL for every leaf (bit-equal measured).
  * Steps: the loss and every shared stat within rtol LOSS_RTOL = 1e-2.
    A bf16 step is 2^-8 = 0.4% of a value; where the packages round an
    intermediate to neighbouring bf16 values (XLA keeps some sums in
    float32, its excess precision), NeRF-PDF's 64-ray image loss moved
    by 4.4e-3 and SDF-PDF's observed-normal eikonal term, a mean of
    (|g| - 1)^2, by 4.1e-3 (measured; the others by under 3.1e-4). The
    softplus has JAX's derivative (fields/fields.py `_Softplus`), or
    the SDF normals would differ by 2% of their largest entry and the
    eikonal terms by 1%. After the step each
    weight within 2 lr of JAX's, and within ADAM_RESOLVED_TOL where the
    port's own gradient entry exceeds RESOLVED of its leaf's largest
    (tests/test_torch_train_compaction.py gives the reasons); stage 2
    as tests/test_torch_animation.py, the frozen leaves unchanged.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.fields.mlp import SkipMLP, WNDense
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train import animation as j_animation
from animatable_nerf_tpu.train.optim import make_optimizer as j_make_optimizer
from animatable_nerf_tpu.train.trainer import (
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.fields.mlp import WNLinear, linear
from animatable_nerf_tpu_torch.ops.skip_mlp import skip_mlp
from animatable_nerf_tpu_torch.train import animation as t_animation
from animatable_nerf_tpu_torch.train.checkpoints import param_codec
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

N_RAND, N_SAMPLES = 64, 16
BF16 = ["compute_dtype", "bfloat16"]
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
X_W_REL = 2.0 ** -7
BIAS_REL = 2.0 ** -5
LOSS_RTOL = 1e-2
RESOLVED = 0.25
ADAM_EPS = 1e-8
ADAM_RESOLVED_TOL = 1e-6
LR = 5e-4
TRAJECTORY_REL = 0.05
ANIM_CFG = "configs/synthetic_novel_pose.yaml"
ANIM_CKPT = "data/trained_model/deform/synthetic_2f_anim/latest.flax"
N_ANIM = 384
TRAINED = "novel_pose_bw"
JAX_ONLY_STATS = {"compact_overflow", "compact_overflow_stage2"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores; module-scoped, so the module fixtures'
    torch work runs on one thread too (tests/test_torch_mesh.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- K1
def skip_mlp_case(skips, n=256, din=37, width=64, depth=6, dout=5, seed=0):
    """JAX's bf16 SkipMLP with perturbed init weights, an input and the
    port's (W, b) leaves of the same weights."""
    rng = np.random.RandomState(seed)
    m = SkipMLP(depth=depth, width=width, out_dim=dout, skips=skips,
                dtype=jnp.bfloat16)
    x = rng.uniform(-1, 1, (n, din)).astype(np.float32)
    params = jax.jit(m.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.randn(
            *a.shape).astype(np.float32), params)
    names = [f"lin{i}" for i in range(depth)] + ["out"]
    layers = [tuple(torch.tensor(np.asarray(params["params"][k][p]),
                                 requires_grad=True)
                    for p in ("kernel", "bias")) for k in names]
    return m, params, names, x, layers, rng.randn(n, dout).astype(np.float32)


def assert_leaf_grads(names, layers, j_params, w_tol, b_tol):
    for k, (w, b) in zip(names, layers):
        for got, p, tol in ((w, "kernel", w_tol), (b, "bias", b_tol)):
            want = np.asarray(j_params["params"][k][p])
            g = np.zeros_like(want) if got.grad is None else got.grad.numpy()
            assert got.grad is None or got.grad.dtype == torch.float32
            assert rel_err(g, want) <= tol, (k, p, rel_err(g, want))


@pytest.mark.parametrize("skips", [(2,), (1, 3)])
def test_k1_bf16_gradient_matches_jax(skips):
    """x, every weight and bias of the bf16 trunk: the port's autograd
    through `SkipMLPFunction` (x cast to bf16 as `run_skip_mlp` casts
    it) against jax.grad of JAX's bf16 SkipMLP."""
    m, params, names, x, layers, g = skip_mlp_case(skips)

    def loss(p, x):
        return jnp.sum(m.apply(p, x) * g)

    j_p, j_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = skip_mlp(xt.to(torch.bfloat16), layers, skips=skips)
    assert y.dtype == torch.float32
    (y * torch.tensor(g)).sum().backward()
    assert xt.grad.dtype == torch.float32
    assert rel_err(xt.grad.numpy(), np.asarray(j_x)) <= X_W_REL
    assert_leaf_grads(names, layers, j_p, X_W_REL, BIAS_REL)


def test_k1_bf16_second_derivative_matches_jax():
    """A loss on d(u . y)/dx, differentiated again (create_graph), as
    the eikonal term differentiates the observed-space normal: x and
    every leaf against JAX's grad of grad."""
    m, params, names, x, layers, u = skip_mlp_case((2,), dout=3)

    def loss(p, x):
        gx = jax.grad(lambda x: jnp.sum(m.apply(p, x) * u))(x)
        return jnp.sum(gx[:, :3] ** 2)

    j_p, j_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = skip_mlp(xt.to(torch.bfloat16), layers, skips=(2,))
    (gx,) = torch.autograd.grad((y * torch.tensor(u)).sum(), xt,
                                create_graph=True)
    (gx[:, :3] ** 2).sum().backward()
    assert rel_err(xt.grad.numpy(), np.asarray(j_x)) <= X_W_REL
    assert_leaf_grads(names, layers, j_p, X_W_REL, X_W_REL)


@pytest.mark.parametrize("layer", ["dense", "wn"])
def test_bf16_heads_gradient_matches_flax(layer):
    """A head in bf16 (fields/mlp.py `linear`, `WNLinear`) against
    flax's Dense and JAX's WNDense with dtype bfloat16: the output and
    the float32 gradients of its float32 parameters and input."""
    rng = np.random.RandomState(3)
    x = rng.randn(200, 48).astype(np.float32)
    g = rng.randn(200, 24).astype(np.float32)
    mod = (fnn.Dense(24, dtype=jnp.bfloat16) if layer == "dense"
           else WNDense(24, dtype=jnp.bfloat16))
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j = mod.apply(params, jnp.asarray(x))
    j_p, j_x = jax.grad(
        lambda p, x: jnp.sum(mod.apply(p, x).astype(jnp.float32) * g),
        argnums=(0, 1))(params, jnp.asarray(x))
    p = params["params"]
    xt = torch.tensor(x, requires_grad=True)
    if layer == "dense":
        head = torch.nn.Linear(48, 24)
        with torch.no_grad():
            head.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
            head.bias.copy_(torch.tensor(np.asarray(p["bias"])))
        y = linear(head, xt, torch.bfloat16)
        pairs = ((head.weight, np.asarray(j_p["params"]["kernel"]).T),
                 (head.bias, j_p["params"]["bias"]))
    else:
        head = WNLinear(48, 24)
        wn, jwn = p["wn"], j_p["params"]["wn"]
        with torch.no_grad():
            head.weight_v.copy_(torch.tensor(np.asarray(wn["v"]).T))
            head.weight_g.copy_(torch.tensor(np.asarray(wn["g"])[:, None]))
            head.bias.copy_(torch.tensor(np.asarray(wn["b"])))
        y = head(xt, torch.bfloat16)
        pairs = ((head.weight_v, np.asarray(jwn["v"]).T),
                 (head.weight_g, np.asarray(jwn["g"])[:, None]),
                 (head.bias, jwn["b"]))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  np.asarray(y_j, np.float32))
    (y.float() * torch.tensor(g)).sum().backward()
    assert rel_err(xt.grad.numpy(), np.asarray(j_x)) <= X_W_REL
    for t, want in pairs:
        assert t.grad.dtype == torch.float32
        # the bias: a bf16 sum over the rows on XLA's CPU (module doc)
        tol = BIAS_REL if t is head.bias else X_W_REL
        assert rel_err(t.grad.numpy(), np.asarray(want)) <= tol


# ------------------------------------------------------------- steps
def cfg_file(family):
    if family == "aninerf":
        return "configs/synthetic.yaml"
    if family in ("nerf_pdf", "sdf_pdf"):
        return f"configs/synthetic_{family}.yaml"
    return f"configs/synthetic_aligned_{family}.yaml"


def flax_params(family):
    if family == "aninerf":
        return flax_msgpack.read_checkpoint(
            "data/trained_model/deform/synthetic/latest.flax")["params"]
    if family in ("nerf_pdf", "sdf_pdf"):
        return flax_msgpack.read_checkpoint(
            f"data/trained_model/deform/synthetic_{family}/latest.flax"
        )["params"]
    return compose_aligned(family)


def as_flax(tree):
    """A param tree as flax holds it: each `layers` keyed "0", "1", ...
    a list."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == "layers" and isinstance(v, dict)
                and sorted(v) == sorted(map(str, range(len(v))))):
            v = [v[str(i)] for i in range(len(v))]
        out[k] = [as_flax(x) for x in v] if isinstance(v, list) else as_flax(v)
    return out


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(as_flax(tree))}


class Case:
    """One family's bf16 configs in both packages (dense, or compacted:
    the port exact, JAX at train_keep_frac 1.0, which cannot overflow),
    its weights, train splits and JAX's jitted `_train_step`."""

    def __init__(self, family, compact=False):
        self.family = family
        extra = ["train_keep_frac", "1.0"] if compact else []
        self.jc = j_load_config(cfg_file(family), OPTS + BF16 + extra)
        self.tc = load_config(cfg_file(family), OPTS + BF16 + extra)
        self.params = flax_params(family)
        self.datasets = (j_engine.make_dataset(self.jc, "train"),
                         t_engine.make_dataset(self.tc, "train"))
        self.trainer = JTrainer(self.jc, j_engine.make_model(self.jc))
        self.step = jax.jit(self.trainer._train_step)
        p = jax.tree_util.tree_map(jnp.asarray, as_flax(self.params))
        self.state0 = TrainState(p, self.trainer.tx.init(p), jnp.asarray(0))

    def batches(self, index, seed):
        j_ds, t_ds = self.datasets
        j_ds._rng = np.random.RandomState(seed)
        t_ds._rng = np.random.RandomState(seed)
        return (j_stack_batch([j_collate_rays(j_ds[index], N_RAND)]),
                stack_batch([collate_rays(t_ds[index], N_RAND)]))

    def port_trainer(self, tc=None):
        tc = tc or self.tc
        model = t_engine.make_model(tc)
        model.load_state_dict(param_codec(model)[0](self.params), strict=True)
        return Trainer(tc, model, "cpu")

    def port_tree(self, model, named):
        return leaves(param_codec(model)[1](named))


@functools.lru_cache(maxsize=None)
def case_of(family, compact=False):
    """One Case a family for the module: its JAX step compiles once."""
    return Case(family, compact)


def assert_step_matches_jax(case, index=4, seed=0):
    """One bf16 step from the same weights and batch: the loss, the
    shared stats and the optimizer's update against JAX's."""
    jb, tb = case.batches(index, seed)
    j_state, j_stats = case.step(case.state0, jb, jax.random.PRNGKey(0))
    j_stats = {k: float(v) for k, v in j_stats.items()}
    trainer = case.port_trainer()
    assert all(m.dtype == torch.bfloat16 for m in trainer.model.modules()
               if hasattr(type(m), "dtype"))
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, stats, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    assert loss.dtype == torch.float32
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in trainer.model.named_parameters()}
    assert all(g.dtype == torch.float32 and bool(g.isfinite().all())
               for g in grads.values())
    stats = {k: float(v.detach()) for k, v in stats.items()}
    assert set(stats) == set(j_stats) - JAX_ONLY_STATS
    for k, v in stats.items():
        np.testing.assert_allclose(v, j_stats[k], rtol=LOSS_RTOL, err_msg=k)
    p0 = leaves(case.state0.params)
    trainer.apply_gradients()
    got = case.port_tree(trainer.model, dict(trainer.model.named_parameters()))
    g = case.port_tree(trainer.model, grads)
    want = leaves(j_state.params)
    assert got.keys() == want.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert np.isfinite(got[k]).all(), k
        assert d.max() <= 2 * LR * (1 + 1e-3), (k, d.max())
        assert np.abs(w - p0[k]).max() <= LR * (1 + 1e-3), k
        resolved = ((np.abs(g[k]) > RESOLVED * np.abs(g[k]).max())
                    & (np.abs(g[k]) > 100 * ADAM_EPS))
        bad = resolved & (d > ADAM_RESOLVED_TOL)
        assert not bad.any(), (k, d[bad], g[k][bad], np.abs(g[k]).max())
    return stats


@pytest.mark.parametrize("family", ["aninerf", "sdf_pdf", "nerf_pdf", "lbw"])
def test_bf16_step_matches_jax(family):
    assert_step_matches_jax(case_of(family))


def test_bf16_compacted_step_matches_jax():
    """AniNeRF's compacted step (`train_keep_frac` > 0) in bf16: the
    trunks on the exact survivors' rows."""
    assert_step_matches_jax(case_of("aninerf", compact=True))


def test_bf16_stage2_step_matches_jax(monkeypatch):
    """One AniNeRF stage-2 step in bf16 (`novel_pose_bw` alone trains;
    both packages draw the same points): the loss, the trained field,
    the frozen leaves as they were."""
    opts = ["aninerf_animation", "True", "n_anim_samples", str(N_ANIM),
            "N_rand", str(N_RAND)] + BF16
    jc, tc = j_load_config(ANIM_CFG, opts), load_config(ANIM_CFG, opts)
    params = flax_msgpack.read_checkpoint(ANIM_CKPT)["params"]
    j_ds, t_ds = (j_engine.make_dataset(jc, "train"),
                  t_engine.make_dataset(tc, "train"))
    j_ds._rng, t_ds._rng = np.random.RandomState(0), np.random.RandomState(0)
    jb = j_stack_batch([j_collate_rays(j_ds[3], N_RAND)])
    tb = stack_batch([collate_rays(t_ds[3], N_RAND)])
    # both packages' k-th uniform draw is the k-th of these units, scaled
    # into its box in float32 (traceable, so JAX's step compiles)
    units = np.random.RandomState(2).rand(2, N_ANIM, 3).astype(np.float32)
    calls = {"jax": 0, "port": 0}

    def draws(side, to_units):
        def draw(_, bounds, n):
            k = calls[side]
            calls[side] += 1
            return bounds[0] + (bounds[1] - bounds[0]) * to_units(units[k])
        return draw

    monkeypatch.setattr(j_animation, "uniform_box_points",
                        draws("jax", jnp.asarray))
    monkeypatch.setattr(t_animation, "uniform_box_points",
                        draws("port", torch.from_numpy))
    jt = j_animation.AnimationTrainer(jc, j_engine.make_model(jc))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jt.tx, jt.sched = j_make_optimizer(
        jc, trainable_mask=j_animation.novel_pose_trainable_mask(p))
    j_state, j_stats = jax.jit(jt._train_step)(
        TrainState(p, jt.tx.init(p), jnp.asarray(0)), jb,
        jax.random.PRNGKey(0))
    model = t_engine.make_model(tc)
    model.load_state_dict(param_codec(model)[0](params), strict=True)
    trainer = t_animation.AnimationTrainer(tc, model, "cpu")
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, _, _ = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    grads = leaves(param_codec(model)[1](
        {n: torch.zeros_like(q) if q.grad is None else q.grad
         for n, q in model.named_parameters()}))
    trainer.apply_gradients()
    np.testing.assert_allclose(float(loss.detach()), float(j_stats["loss"]),
                               rtol=LOSS_RTOL)
    p0, want = leaves(params), leaves(j_state.params)
    got = leaves(param_codec(model)[1](dict(model.named_parameters())))
    for k, w in want.items():
        if f"'{TRAINED}'" not in k:
            np.testing.assert_array_equal(got[k], p0[k], err_msg=k)
            np.testing.assert_array_equal(w, p0[k], err_msg=k)
            continue
        d = np.abs(got[k] - w)
        resolved = ((np.abs(grads[k]) > RESOLVED * np.abs(grads[k]).max())
                    & (np.abs(grads[k]) > 100 * ADAM_EPS))
        assert d[resolved].max(initial=0) <= ADAM_RESOLVED_TOL, k
        assert d.max() <= 2 * LR * (1 + 1e-3), k
        assert np.abs(got[k] - p0[k]).max() > 0, k


def test_bf16_trajectory_tracks_f32():
    """Eight AniNeRF steps in bf16 against eight in float32 on the same
    batches: each loss within TRAJECTORY_REL of the float32 one (JAX's
    own bound, tests/test_trainer.py:832-866), and not equal to it (the
    bf16 path ran)."""
    case = case_of("aninerf")
    f32 = load_config(cfg_file("aninerf"), OPTS)
    batches = [case.batches(i, i)[1] for i in (1, 4, 6, 9)]
    traj = {}
    for name, tc in (("f32", f32), ("bf16", case.tc)):
        trainer = case.port_trainer(tc)
        traj[name] = np.asarray([trainer.train_step(batches[i % 4])["loss"]
                                 for i in range(8)])
    rel = np.abs(traj["bf16"] - traj["f32"]) / np.maximum(
        np.abs(traj["f32"]), 1e-6)
    assert rel.max() < TRAJECTORY_REL, traj
    assert np.any(traj["bf16"] != traj["f32"])


def test_bf16_run_train_needs_a_card():
    """`run_train` of a bf16 config without a device named runs on the
    card or raises before any work: it never carries on on the CPU."""
    cfg = load_config("configs/synthetic.yaml", OPTS + BF16)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_engine.run_train(cfg)
