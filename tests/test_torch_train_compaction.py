"""Train-time survivor compaction (`train_keep_frac` > 0) on the CPU: the
port's compacted train step against the JAX package's `_train_step` on
the same numpy-seeded batch and the same weights (the tracked
checkpoints; the aligned families' composed from them,
compat/compose.py), for all eight volumetric families at full widths
with 64 rays of 16 samples and `perturb 0`; and against the port's own
dense step.

The KNN families' pass 1 reads a distance grid of GRID_RES^3 nodes: the
port's trainer builds it (K3's plain version here), JAX's batch carries
the same grid from its `build_pdist_payload`, as its frame store would.
JAX runs at `train_keep_frac` KEEP = 1.0, where its capacities hold every
point (at 1,024 points a step, eval_capacity floors 0.9 to 512 slots,
fewer than the capsule's exact survivors on some items), so it cannot
overflow; the port's compaction is exact at any fraction.

Tolerances (those of the families' dense-step tests,
tests/test_torch_train.py, test_torch_train_sdf.py,
test_torch_train_pdf_families.py and test_torch_train_aligned.py, whose
reasons hold here):
  * Against JAX: the loss and every stat the two packages share within
    rtol LOSS_RTOL = 1e-4 (LBWPDF's loss and stats at ALIGNED_LOSS_RTOL,
    below); after Adam's first step each weight within 2 lr of JAX's (a
    gradient entry within its rounding takes a full step of either
    sign), and within ADAM_RESOLVED_TOL = 1e-6 where the port's own
    gradient entry exceeds RESOLVED = 0.25 of its leaf's largest (the
    two packages' gradients differ by up to 1.4e-2 of a leaf's largest,
    on LBW's bw_field.lin0.bias, tests/test_torch_train_aligned.py) and
    100 x Adam's eps (so the update, lr x g / (|g| + eps), moves by
    under lr x 1e-2 x g's relative error).
  * Three steps (SDF-PDF, AniNeRF): the first step's loss within
    LOSS_RTOL, every loss finite, the weights within 2 lr a step of
    JAX's.
  * Against the port's dense step (the same code on other row counts):
    the loss and stats within LOSS_RTOL, each gradient leaf within
    GRAD_REL = 1e-2 of its largest entry, raw and the maps within
    MAP_TOL = 1e-4, and the compacted rows exactly the dense filter's
    survivors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.ops.knn_pallas import (
    build_pdist_payload as j_build_pdist_payload,
)
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.trainer import (
    TrainState,
    collate_rays as j_collate_rays,
    stack_batch as j_stack_batch,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.models.common import (
    SDF_FILL,
    TrainRows,
    compact_indices,
    grid_pdist_keep,
    inside_bounds,
    scatter_compacted,
)
from animatable_nerf_tpu_torch.train import trainer as t_trainer
from animatable_nerf_tpu_torch.train.checkpoints import param_codec
from animatable_nerf_tpu_torch.train.trainer import (
    Trainer,
    collate_rays,
    stack_batch,
)

N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
GRID_RES = 16
KEEP = 1.0
COMPACT = ["train_keep_frac", str(KEEP), "knn_grid_res", str(GRID_RES)]
NORM_TH = 0.1
LOSS_RTOL = 1e-4
# LBWPDF's step (chip_smoke.py ALIGNED_LOSS_RTOL): its offset term sums
# displacements whose rounding the positional encoding multiplies
ALIGNED_LOSS_RTOL = {"lbw_pdf": 1e-3}
GRAD_REL = 1e-2
RESOLVED = 0.25
ADAM_EPS = 1e-8  # optax's and torch's Adam eps
ADAM_RESOLVED_TOL = 1e-6
MAP_TOL = 1e-4
GRID_FLIPS = 1e-3
LR = 5e-4
KNN = ("nerf_pdf", "sdf_pdf", "neus_pdf", "lbw", "pbw", "smpl", "lbw_pdf")
FAMILIES = ("aninerf",) + KNN
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


def cfg_file(family):
    if family == "aninerf":
        return "configs/synthetic.yaml"
    if family in ("nerf_pdf", "sdf_pdf", "neus_pdf"):
        return f"configs/synthetic_{family}.yaml"
    return f"configs/synthetic_aligned_{family}.yaml"


def flax_params(family):
    if family == "aninerf":
        return flax_msgpack.read_checkpoint(
            "data/trained_model/deform/synthetic/latest.flax")["params"]
    if family in ("nerf_pdf", "sdf_pdf", "neus_pdf"):
        return flax_msgpack.read_checkpoint(
            f"data/trained_model/deform/synthetic_{family}/latest.flax"
        )["params"]
    return compose_aligned(family)


def as_flax(tree):
    """A param tree as flax holds it: every `layers` that a msgpack file
    (and the port's param trees) key "0", "1", ... a list."""
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
    """One family's configs (dense and compacted), weights, train splits
    and the JAX trainer of the compacted model with its jitted
    `_train_step`."""

    def __init__(self, family):
        self.family = family
        self.knn = family in KNN
        self.jc = j_load_config(cfg_file(family),
                                OPTS + ["train_keep_frac", str(KEEP)])
        self.tc = load_config(cfg_file(family), OPTS + COMPACT)
        self.tc_dense = load_config(cfg_file(family), OPTS)
        self.params = flax_params(family)
        self.datasets = (j_engine.make_dataset(self.jc, "train"),
                         t_engine.make_dataset(self.tc, "train"))
        self.trainer = JTrainer(self.jc, j_engine.make_model(self.jc))
        self.step = jax.jit(self.trainer._train_step)
        p = jax.tree_util.tree_map(jnp.asarray, as_flax(self.params))
        self.state0 = TrainState(p, self.trainer.tx.init(p), jnp.asarray(0))
        self._grid = jax.jit(functools.partial(j_build_pdist_payload,
                                               res=GRID_RES))

    def batches(self, index, seed, grid=True, shift=None):
        """Item `index` of both train splits drawn from RandomState(seed)
        (the rays moved by `shift`, world metres, where given); JAX's
        with the frame's distance grid where `grid` and the family
        reads one."""
        j_ds, t_ds = self.datasets
        j_ds._rng = np.random.RandomState(seed)
        t_ds._rng = np.random.RandomState(seed)
        jb = j_stack_batch([j_collate_rays(j_ds[index], N_RAND)])
        tb = stack_batch([collate_rays(t_ds[index], N_RAND)])
        if shift is not None:
            for b in (jb, tb):
                b["ray_o"] = (b["ray_o"] + shift).astype(np.float32)
        if grid and self.knn:
            packed, margin, bounds = self._grid(jnp.asarray(jb["pvertices"][0]))
            jb.update(pdist_packed=np.asarray(packed)[None],
                      pdist_margin=np.asarray(margin)[None],
                      pdist_bounds=np.asarray(bounds)[None])
        return jb, tb

    def port_trainer(self, compact=True, opts=()):
        tc = self.tc if compact else self.tc_dense
        if opts:
            tc = load_config(cfg_file(self.family), OPTS + COMPACT + list(opts))
        model = t_engine.make_model(tc)
        model.load_state_dict(param_codec(model)[0](self.params), strict=True)
        return Trainer(tc, model, "cpu")

    def port_tree(self, model, named):
        return leaves(param_codec(model)[1](named))

    def jax_step(self, state, jb):
        state, stats = self.step(state, jb, jax.random.PRNGKey(0))
        stats = {k: float(v) for k, v in stats.items()}
        assert stats.get("compact_overflow", 0.0) == 0.0
        assert stats.get("compact_overflow_stage2", 0.0) == 0.0
        return state, stats


@functools.lru_cache(maxsize=None)
def case_of(family):
    """One Case a family for the module: its JAX step compiles once."""
    return Case(family)


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return case_of(request.param)


def port_grad_step(trainer, tb):
    """The port's train step, also returning its gradients by flax leaf
    and the render."""
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, stats, ret = trainer.loss({k: v[0] for k, v in tb.items()})
    loss.backward()
    named = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in trainer.model.named_parameters()}
    return (float(loss.detach()), {k: float(v.detach()) for k, v in stats.items()},
            ret, named)


def assert_stats_match(family, stats, j_stats):
    assert set(stats) == set(j_stats) - JAX_ONLY_STATS
    rtol = ALIGNED_LOSS_RTOL.get(family, LOSS_RTOL)
    for k, v in stats.items():
        np.testing.assert_allclose(v, j_stats[k], rtol=rtol, err_msg=k)


def assert_adam_step_matches(case, trainer, grads, p0, j_params):
    """After one Adam step from p0: every weight within 2 lr of JAX's,
    and within ADAM_RESOLVED_TOL where the gradient is resolved."""
    got = case.port_tree(trainer.model, dict(trainer.model.named_parameters()))
    g = case.port_tree(trainer.model, grads)
    want = leaves(j_params)
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


# --------------------------------------------------- helpers, trainer
def test_scatter_compacted_keeps_second_derivatives():
    """The survivors' scatter (and its gather) on the graph under
    create_graph: a loss on d f / d x of a function that scatters and
    gathers differentiates again to the dense where-form's values."""
    rng = np.random.RandomState(0)
    x0 = torch.tensor(rng.randn(24, 3).astype(np.float32))
    keep = torch.tensor(rng.rand(24) < 0.5)
    sidx = compact_indices(keep)
    w = torch.tensor(rng.randn(3).astype(np.float32), requires_grad=True)

    def second(compacted):
        x = (x0[sidx] if compacted else x0).clone().requires_grad_(True)
        f = torch.sin(x @ w)
        grid = (scatter_compacted(f, sidx, 4, 6, SDF_FILL) if compacted
                else torch.where(keep, f, SDF_FILL).reshape(4, 6))
        out = torch.tanh(grid).reshape(-1)[sidx] if compacted else torch.where(
            keep, torch.tanh(grid).reshape(-1), 0.0)
        (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad((g ** 2).sum(), w)
        return grid.detach(), gw

    (dense, gw_d), (comp, gw_c) = second(False), second(True)
    # x @ w on fewer rows may round otherwise
    torch.testing.assert_close(comp, dense, rtol=1e-6, atol=1e-7)
    assert torch.all(comp.reshape(-1)[~keep] == SDF_FILL)
    torch.testing.assert_close(gw_c, gw_d, rtol=1e-6, atol=1e-7)
    assert float(gw_c.abs().max()) > 0


def test_train_rows_lay_out_either_path():
    keep = torch.tensor([True, False, True, True, False, False])
    x = torch.arange(12.0).reshape(6, 2)
    dense = TrainRows(keep, 2, 3)
    sidx = compact_indices(keep)
    comp = TrainRows.compacted(sidx, 2, 3)
    assert sidx.tolist() == [0, 2, 3] and bool(comp.mask.all())
    assert torch.equal(dense.dense(x, -1.0),
                       comp.dense(x[comp.index], -1.0))
    assert torch.equal(x[dense.index], x)
    assert dense.dense(x).shape == (2, 3, 2)


@pytest.mark.parametrize("family,opts,grids", [
    ("sdf_pdf", [], 1), ("lbw", [], 1), ("sdf_pdf", ["knn_grid_res", "0"], 0),
    ("aninerf", [], 0)])
def test_trainer_builds_the_grid_once_a_frame(monkeypatch, family, opts,
                                              grids):
    """A KNN family's compacted trainer builds the frame's distance grid
    (margin and bounds too) when it uploads the frame, once; AniNeRF and
    `knn_grid_res 0` build none, and the dense path none."""
    calls = []
    build = t_trainer.build_pdist_payload

    def counted(vertices, res):
        calls.append(res)
        return build(vertices, res=res)

    monkeypatch.setattr(t_trainer, "build_pdist_payload", counted)
    tc = load_config(cfg_file(family), OPTS + COMPACT + opts)
    ds = t_engine.make_dataset(tc, "train")
    ds._rng = np.random.RandomState(0)
    item = collate_rays(ds[0], N_RAND)
    trainer = Trainer(tc, t_engine.make_model(tc), "cpu")
    assert trainer.model.train_keep_frac == KEEP
    frame = trainer._frame(item)
    assert trainer._frame(item) is frame
    assert calls == [GRID_RES] * grids
    assert ("pdist_packed" in frame) == bool(grids)
    if grids:
        assert frame["pdist_packed"].shape == (GRID_RES - 1,) * 3 + (8,)
        assert set(frame) >= {"pdist_margin", "pdist_bounds"}
    dense = load_config(cfg_file(family), OPTS)
    assert Trainer(dense, t_engine.make_model(dense), "cpu").pdist_res == 0


def test_grid_matches_jax():
    """The trainer's grid against JAX's `build_pdist_payload` at the same
    res: the box equal, the margin (unread) within rounding; the bf16
    corners equal but where the
    float32 distance of a node, summed in another order by XLA, rounds
    to the neighbouring bf16 value (one step, 2^-7 relative, on at most
    GRID_FLIPS of the corners)."""
    case = case_of("nerf_pdf")
    jb, tb = case.batches(4, 0)
    frame = case.port_trainer()._frame({k: v[0] for k, v in tb.items()})
    np.testing.assert_array_equal(frame["pdist_bounds"].numpy(),
                                  np.asarray(jb["pdist_bounds"][0]))
    np.testing.assert_allclose(float(frame["pdist_margin"]),
                               float(jb["pdist_margin"][0]), rtol=1e-6)
    got = frame["pdist_packed"].to(torch.float32).numpy()
    want = np.asarray(jb["pdist_packed"][0], np.float32)
    off = got != want
    assert off.mean() <= GRID_FLIPS
    assert np.all(np.abs(got - want)[off] <= 2.0 ** -7 * np.abs(want[off]))


# ------------------------------------------------------------- steps
def test_compacted_step_matches_jax(case):
    """One compacted step from the same weights and batch: the loss,
    every shared stat, and Adam's update against JAX's `_train_step`."""
    jb, tb = case.batches(4, 0)
    j_state, j_stats = case.jax_step(case.state0, jb)
    trainer = case.port_trainer()
    loss, stats, _, grads = port_grad_step(trainer, tb)
    assert_stats_match(case.family, stats, j_stats)
    p0 = leaves(case.state0.params)
    trainer.apply_gradients()
    assert_adam_step_matches(case, trainer, grads, p0, j_state.params)


def test_compacted_step_matches_dense(case):
    """The port's compacted step against its dense step from the same
    weights and batch: the rows are the dense filter's survivors, raw
    and the maps agree, and so do the loss, the stats and the gradient."""
    _, tb = case.batches(9, 5, grid=False)
    dense, comp = case.port_trainer(compact=False), case.port_trainer()
    d_loss, d_stats, d_ret, d_grads = port_grad_step(dense, tb)
    c_loss, c_stats, c_ret, c_grads = port_grad_step(comp, tb)
    if "resd_mask" in d_ret:
        assert c_ret["resd_mask"].numel() == int(d_ret["resd_mask"].sum()) > 100
    if "bw_mask" in d_ret:
        assert c_ret["pbw"].shape[0] < d_ret["pbw"].shape[0]
        assert int(c_ret["bw_mask"].sum()) == int(d_ret["bw_mask"].sum())
    for k in ("raw", "rgb_map", "acc_map", "sdf"):
        if k in d_ret:
            np.testing.assert_allclose(c_ret[k].detach().numpy(),
                                       d_ret[k].detach().numpy(), rtol=0,
                                       atol=MAP_TOL, err_msg=k)
    assert set(c_stats) == set(d_stats)
    for k, v in c_stats.items():
        np.testing.assert_allclose(v, d_stats[k], rtol=LOSS_RTOL, err_msg=k)
    assert c_grads.keys() == d_grads.keys()
    for k, g in d_grads.items():
        err = float((c_grads[k] - g).abs().max())
        assert err <= GRAD_REL * float(g.abs().max()), (k, err)


def test_nerf_pdf_without_grid_matches_jax():
    """`knn_grid_res 0`: no grid, K2 on every point gives the exact
    filter (JAX's `_compact_inputs` conservative=False branch)."""
    case = case_of("nerf_pdf")
    jb, tb = case.batches(4, 0, grid=False)
    j_state, j_stats = case.jax_step(case.state0, jb)
    trainer = case.port_trainer(opts=["knn_grid_res", "0"])
    assert trainer.pdist_res == 0
    loss, stats, ret, grads = port_grad_step(trainer, tb)
    assert "pdist_packed" not in trainer._frame({k: v[0] for k, v in tb.items()})
    assert_stats_match("nerf_pdf", stats, j_stats)
    p0 = leaves(case.state0.params)
    trainer.apply_gradients()
    assert_adam_step_matches(case, trainer, grads, p0, j_state.params)


@pytest.mark.parametrize("family", ["sdf_pdf", "aninerf"])
def test_three_steps_match_jax(family):
    """Three compacted steps of `_train_step` against the port's: the
    first step's loss within LOSS_RTOL, every loss finite, the weights
    within 2 lr a step of JAX's (tests/test_torch_train_sdf.py gives
    the reason)."""
    case = case_of(family)
    trainer = case.port_trainer()
    state = case.state0
    for n, (index, seed) in enumerate(((4, 0), (7, 1), (1, 2))):
        jb, tb = case.batches(index, seed)
        state, j_stats = case.jax_step(state, jb)
        stats = trainer.train_step(tb)
        assert all(np.isfinite(v) for v in stats.values())
        if n == 0:
            assert_stats_match(family, stats, j_stats)
        mine = case.port_tree(trainer.model,
                              dict(trainer.model.named_parameters()))
        for k, w in leaves(state.params).items():
            assert np.abs(mine[k] - w).max() <= 2 * (n + 1) * LR * (1 + 1e-3), k
    assert trainer.step == trainer.updates == int(state.step) == 3


def forced_only_shift(case, tb):
    """A world shift of the rays that leaves every sample farther than
    NORM_TH from every posed vertex while some samples still lie within
    NORM_TH of the distance grid's box, where pass 1 reads finite
    bounds; and the samples' weighted KNN distances after it."""
    b = {k: v[0] for k, v in tb.items()}
    frame = case.port_trainer()._frame(b)
    z = stratified_z_vals(torch.as_tensor(b["near"]),
                          torch.as_tensor(b["far"]), N_SAMPLES)
    base = z_vals_to_pts(torch.as_tensor(b["ray_o"]),
                         torch.as_tensor(b["ray_d"]), z).reshape(-1, 3)
    verts = frame["pvertices"]
    width = float(verts[:, 0].max() - verts[:, 0].min())
    for extra in np.arange(0.105, 0.16, 0.005):
        shift = (torch.tensor([float(width + extra), 0.0, 0.0])
                 @ frame["R"].transpose(0, 1))
        pose = world_points_to_pose_points(base + shift, frame["R"],
                                           frame["Th"])
        _, pnorm = sample_blend_closest_points(pose, verts, frame["weights"])
        near_vertex = float(torch.cdist(pose, verts).amin())
        on_grid = int(inside_bounds(pose, frame["pdist_bounds"],
                                    pad=NORM_TH).sum())
        if near_vertex > NORM_TH + 1e-3 and on_grid:
            return shift.numpy(), pnorm[:, 0]
    raise AssertionError("no shift leaves only forced points")


def test_only_forced_points_survive_as_in_jax():
    """A step whose samples all lie farther than the threshold from the
    body: pass 1 forces its bound's argmin, the exact filter its argmin
    over those candidates, and that one point is the step's only
    survivor, as in JAX's compacted step (the loss, the stats and Adam's
    update held to it). The dense path forces the exact argmin over the
    whole step instead; the test records whether that is the same
    point."""
    case = case_of("nerf_pdf")
    _, tb0 = case.batches(4, 0)
    shift, pnorm = forced_only_shift(case, tb0)
    jb, tb = case.batches(4, 0, shift=shift)
    j_state, j_stats = case.jax_step(case.state0, jb)
    trainer = case.port_trainer()
    loss, stats, ret, grads = port_grad_step(trainer, tb)
    assert ret["resd_mask"].numel() == 1
    assert_stats_match("nerf_pdf", stats, j_stats)
    p0 = leaves(case.state0.params)
    trainer.apply_gradients()
    assert_adam_step_matches(case, trainer, grads, p0, j_state.params)
    # the survivor is pass 1's forced point, the grid bound's argmin (no
    # bound is under the threshold here), not the exact argmin of the
    # step that the dense path forces: on this batch they differ
    b = {k: v[0] for k, v in tb.items()}
    frame = trainer._frame(b)
    rays_d, z = torch.as_tensor(b["ray_d"]), ret["z_vals"]
    wpts = z_vals_to_pts(torch.as_tensor(b["ray_o"]), rays_d, z)
    pose = world_points_to_pose_points(wpts.reshape(-1, 3), frame["R"],
                                       frame["Th"])
    cand = compact_indices(grid_pdist_keep(pose, frame, NORM_TH))
    rows = trainer.model._train_filter(wpts, rays_d, z, frame)[0]
    assert len(cand) == 1 and torch.equal(rows.sidx, cand)
    dense = case.port_trainer(compact=False)
    _, _, d_ret, _ = port_grad_step(dense, tb)
    d_idx = compact_indices(d_ret["resd_mask"])
    assert d_idx.tolist() == [int(torch.argmin(pnorm))]
    assert int(cand[0]) != int(d_idx[0])
