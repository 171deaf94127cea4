"""The training options on the CPU, held to the JAX package: Adam, RAdam,
SGD and AdamW (train/optim.py) against optax through JAX's
`make_optimizer`; their checkpoints both ways (train/checkpoints.py);
the periodic evaluation with `best.flax` (engine.py `run_train`,
`periodic_eval`); dense train steps above `dense_chunk_rows` in ray
chunks (render/renderer.py `train_forward_chunked`) against JAX's
`apply_model`; and `train.batch_size`, which without a mesh trains one
frame a step in both packages.

Tolerances:
  * Optimizer updates: 6 steps through the warmup schedule on seeded
    gradients (some above the clip): each parameter within UPDATE_RTOL
    = 1e-5 relative and UPDATE_ATOL = 1e-8 of optax's (float32
    arithmetic in another order), frozen stage-2 leaves exactly as
    they were.
  * Checkpoints: the moments and counts read back bit for bit.
  * The chunked step: the loss and every stat within rtol LOSS_RTOL =
    1e-4 of JAX's chunked step, each gradient leaf within GRAD_REL =
    1e-2 of its largest entry (the families' dense-step tolerances,
    tests/test_torch_train.py and test_torch_train_sdf.py).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.train import Trainer as JTrainer
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from animatable_nerf_tpu.train.optim import make_optimizer as j_make_optimizer
from animatable_nerf_tpu.train.trainer import collate_rays as j_collate_rays

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat import flax_msgpack
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.train import optim as t_optim
from animatable_nerf_tpu_torch.train.checkpoints import (
    best_metric,
    load_checkpoint,
    opt_state_tree,
    optimizer_slots,
    param_codec,
    save_checkpoint,
    write_fresh_start,
)
from animatable_nerf_tpu_torch.train.trainer import Trainer, collate_rays

CFG = "configs/synthetic.yaml"
CKPT = "data/trained_model/deform/synthetic/latest.flax"
N_RAND, N_SAMPLES = 64, 16
OPTS = ["N_rand", str(N_RAND), "N_samples", str(N_SAMPLES), "perturb", "0"]
KINDS = {  # optimizer: the config's opts
    "adam": ["train.optim", "adam"],
    "adamw": ["train.optim", "adam", "train.weight_decay", "0.01"],
    "radam": ["train.optim", "radam", "train.weight_decay", "0.01"],
    "sgd": ["train.optim", "sgd", "train.weight_decay", "0.01"],
}
WARMUP = {"type": "warmup_multi_step", "milestones": [1, 2], "gamma": 0.5,
          "warmup_iters": 4, "warmup_factor": 0.25}
UPDATE_RTOL, UPDATE_ATOL = 1e-5, 1e-8
LOSS_RTOL = 1e-4
GRAD_REL = 1e-2
# the chunked step: 64 rays of 16 samples in chunks of 24 rays (the last
# padded with 8)
CHUNK_ROWS = 24 * N_SAMPLES


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores; module-scoped, so the module fixtures'
    torch work runs on one thread too (tests/test_torch_mesh.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --------------------------------------------------------- optimizers
@pytest.mark.parametrize("name,wd,kind", [
    ("adam", 0.0, "adam"), ("adam", 0.01, "adamw"), ("radam", 0.0, "radam"),
    ("radam", 0.01, "radam"), ("sgd", 0.01, "sgd"), ("momentum", 0.0, "sgd")])
def test_config_picks_jax_optimizer(name, wd, kind):
    """`optim` and `weight_decay` pick JAX's optimizer: adamw only for
    adam with a decay, sgd for any other name; the state layout the port
    writes is optax's for that config."""
    opts = ["train.optim", name, "train.weight_decay", str(wd)]
    tc, jc = load_config(CFG, opts), j_load_config(CFG, opts)
    assert t_optim.optimizer_kind(tc) == kind
    p = torch.nn.Parameter(torch.zeros(3))
    opt = t_optim.make_optimizer(tc, [p])
    assert isinstance(opt, t_optim.OptaxUpdate) and opt.kind == kind
    tx, _ = j_make_optimizer(jc)
    want = serialization.to_state_dict(tx.init({"w": jnp.zeros(3)}))
    slots = {k: {"w": np.zeros(3, np.float32)}
             for k in want["1"]["0"] if k != "count"}
    got = opt_state_tree(0, slots, kind=kind)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))


class ToyModel(torch.nn.Module):
    """Three leaves; `novel_pose_bw` the one stage 2 trains."""

    def __init__(self, rng):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(rng.randn(5, 4), dtype=torch.float32))
        self.b = torch.nn.Parameter(torch.tensor(rng.randn(7), dtype=torch.float32))
        self.novel_pose_bw = torch.nn.Linear(3, 2)


def toy_tree(model):
    return {"params": {"a": model.a.detach().numpy().copy(),
                       "b": model.b.detach().numpy().copy(),
                       "novel_pose_bw": {
                           "kernel": model.novel_pose_bw.weight.detach().numpy().T.copy(),
                           "bias": model.novel_pose_bw.bias.detach().numpy().copy()}}}


def toy_grads(rng, model):
    """Seeded gradients, a few entries beyond the clip at 40."""
    return {n: torch.tensor(rng.randn(*p.shape) * np.where(
        rng.rand(*p.shape) < 0.2, 80.0, 1.0), dtype=torch.float32)
        for n, p in model.named_parameters()}


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
@pytest.mark.parametrize("kind", ["adam", "radam", "sgd", "adamw"])
def test_updates_match_optax(kind, stage2):
    """Six updates through the warmup schedule: the trainer's clip and
    learning rate (`Trainer.apply_gradients`) and the optimizer against
    JAX's chain (clip(40), the optimizer), in stage 2 under its
    multi_transform with set_to_zero on the frozen leaves."""
    tc, jc = (load_config(CFG, KINDS[kind]), j_load_config(CFG, KINDS[kind]))
    for c in (tc, jc):
        c.train.scheduler = dict(WARMUP)
        c.ep_iter = 2
    rng = np.random.RandomState(0)
    model = ToyModel(rng)
    if stage2:
        model.requires_grad_(False)
        model.novel_pose_bw.requires_grad_(True)
    params = [p for p in model.parameters() if p.requires_grad]
    trainer = types.SimpleNamespace(
        params=params, optimizer=t_optim.make_optimizer(tc, params),
        sched=t_optim.make_schedule(tc), updates=0)
    jp = jax.tree_util.tree_map(jnp.asarray, toy_tree(model))
    mask = (jax.tree_util.tree_map_with_path(
        lambda path, _: "novel_pose_bw" in jax.tree_util.keystr(path), jp)
        if stage2 else None)
    tx, _ = j_make_optimizer(jc, trainable_mask=mask)
    state = tx.init(jp)
    p0 = leaves(jp)
    for _ in range(6):
        grads = toy_grads(rng, model)
        for n, p in model.named_parameters():
            p.grad = grads[n].clone() if p.requires_grad else None
        Trainer.apply_gradients(trainer)
        g = toy_tree(types.SimpleNamespace(
            a=grads["a"], b=grads["b"], novel_pose_bw=types.SimpleNamespace(
                weight=grads["novel_pose_bw.weight"],
                bias=grads["novel_pose_bw.bias"])))
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
    assert trainer.updates == 6
    got, want = leaves(toy_tree(model)), leaves(jp)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=UPDATE_RTOL,
                                   atol=UPDATE_ATOL, err_msg=k)
        if stage2 and "novel_pose_bw" not in k:
            np.testing.assert_array_equal(got[k], p0[k], err_msg=k)
        else:
            assert np.abs(got[k] - p0[k]).max() > 0, k


def test_radam_rectifies_from_step_six():
    """optax's RAdam takes the plain bias-corrected momentum until the
    rectification term reaches 5 (at the sixth update with b2 = 0.999);
    torch.optim.RAdam's test and eps differ, so the port does not use
    it."""
    assert [t_optim.OptaxUpdate._factors(t)[2] is None
            for t in range(1, 8)] == [True] * 5 + [False] * 2


# -------------------------------------------------------- checkpoints
def aninerf_trainer(kind, anim=False):
    cfg_file = "configs/synthetic_novel_pose.yaml" if anim else CFG
    opts = OPTS + KINDS[kind] + (["aninerf_animation", "True"] if anim else [])
    tc, jc = load_config(cfg_file, opts), j_load_config(cfg_file, opts)
    model = t_engine.make_model(tc)
    if anim:
        from animatable_nerf_tpu_torch.train.animation import AnimationTrainer

        return tc, jc, AnimationTrainer(tc, model, "cpu")
    model.load_state_dict(param_codec(model)[0](
        flax_msgpack.read_checkpoint(CKPT)["params"]), strict=True)
    return tc, jc, Trainer(tc, model, "cpu")


def seeded_updates(trainer, n=2, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        for p in trainer.params:
            p.grad = torch.tensor(rng.randn(*p.shape), dtype=torch.float32)
        trainer.apply_gradients()


def jax_tx(jc, params, stage2):
    mask = None
    if stage2:
        from animatable_nerf_tpu.train.animation import novel_pose_trainable_mask

        mask = novel_pose_trainable_mask(params)
    return j_make_optimizer(jc, trainable_mask=mask)[0]


def slot_leaves(node, slot):
    return leaves(serialization.to_state_dict(node)[slot])


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_port_checkpoint_read_by_jax(kind, stage2, tmp_path):
    """Two updates, then `save_checkpoint`: JAX's `load_checkpoint` into
    its optimizer's state template reads the params, the count and the
    moments (in stage 2 under multi_transform, the frozen leaves
    masked)."""
    _, jc, trainer = aninerf_trainer(kind, stage2)
    seeded_updates(trainer)
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 0, 2,
                    {"step": 2}, latest=True)
    to_tree = param_codec(trainer.model)[1]
    params = to_tree(dict(trainer.model.named_parameters()))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out = j_load_checkpoint(str(tmp_path), jp, jax_tx(jc, jp, stage2).init(jp))
    got_p, opt_state = out[0], out[1]
    for k, v in leaves(params).items():
        np.testing.assert_array_equal(leaves(got_p)[k], v, err_msg=k)
    chain = opt_state.inner_states["train"].inner_state if stage2 else opt_state
    node = chain[1][0]
    assert int(chain[1][-1].count) == 2
    count, slots = optimizer_slots(trainer.model, trainer.optimizer)
    assert count == 2
    for slot, mine in slots.items():
        want = slot_leaves(node, slot)
        for k, v in leaves(to_tree(mine)).items():
            if k in want:
                np.testing.assert_array_equal(v, want[k], err_msg=k)
            else:  # a frozen leaf, masked
                assert stage2 and "novel_pose_bw" not in k and not v.any(), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_checkpoint_resumed_by_port(kind, tmp_path):
    """JAX's state after two updates, written by its `save_checkpoint`:
    the port's `load_checkpoint` restores the count and the moments, and
    one more update from it equals JAX's next one."""
    _, jc, trainer = aninerf_trainer(kind)
    to_tree = param_codec(trainer.model)[1]
    jp = jax.tree_util.tree_map(
        jnp.asarray, to_tree(dict(trainer.model.named_parameters())))
    tx = jax_tx(jc, jp, False)
    state = tx.init(jp)
    # one compile of optax's update over the model's tree (eager, it
    # compiles each operation for each leaf shape)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), jp)
        for _ in range(3)]
    for g in grads[:2]:
        updates, state = update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    j_save_checkpoint(str(tmp_path), jp, state, 0, 2, {"step": 2}, latest=True)
    epoch, step, updates, rec = load_checkpoint(str(tmp_path), trainer.model,
                                                trainer.optimizer)
    assert (epoch, step, updates, rec) == (0, 2, 2, {"step": 2})
    trainer.updates = updates
    count, slots = optimizer_slots(trainer.model, trainer.optimizer)
    assert count == 2
    for slot, mine in slots.items():
        want = slot_leaves(state[1][0], slot)
        for k, v in leaves(to_tree(mine)).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    named = param_codec(trainer.model)[0](
        jax.tree_util.tree_map(np.asarray, grads[2]))
    for n, p in trainer.model.named_parameters():
        p.grad = named[n].reshape(p.shape).clone()
    trainer.apply_gradients()
    updates, state = update(grads[2], state, jp)
    want = leaves(optax.apply_updates(jp, updates))
    for k, v in leaves(to_tree(dict(trainer.model.named_parameters()))).items():
        np.testing.assert_allclose(v, want[k], rtol=UPDATE_RTOL,
                                   atol=UPDATE_ATOL, err_msg=k)


def test_checkpoint_of_another_optimizer_raises(tmp_path):
    """A checkpoint written under Adam does not resume an SGD run (JAX's
    `from_state_dict` fails on it too)."""
    _, _, trainer = aninerf_trainer("adam")
    save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer, 0, 0,
                    latest=True)
    _, _, sgd = aninerf_trainer("sgd")
    with pytest.raises(ValueError, match="not sgd's"):
        load_checkpoint(str(tmp_path), sgd.model, sgd.optimizer)


@pytest.mark.parametrize("kind", ["radam", "sgd"])
def test_initial_start_in_the_configs_optimizer(kind, tmp_path):
    """`write_initial_start` writes the config's optimizer state: the
    port's trainer under that optimizer resumes from it at update 0, and
    JAX's `load_checkpoint` reads it into its optimizer's template."""
    opts = OPTS + KINDS[kind] + ["trained_model_dir", str(tmp_path)]
    tc, jc = load_config(CFG, opts), j_load_config(CFG, opts)
    t_engine.write_initial_start(tc)
    trainer = Trainer(tc, t_engine.make_model(tc), "cpu")
    assert load_checkpoint(tc.trained_model_dir, trainer.model,
                           trainer.optimizer)[:3] == (-1, 0, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, param_codec(trainer.model)[1](
        dict(trainer.model.named_parameters())))
    out = j_load_checkpoint(jc.trained_model_dir, jp,
                            jax_tx(jc, jp, False).init(jp))
    assert int(out[1][1][-1].count) == 0


# ---------------------------------------------------- periodic eval
def train_opts(tmp_path, epochs, extra=()):
    return OPTS + ["trained_model_dir", str(tmp_path / "model"),
                   "record_dir", str(tmp_path / "record"),
                   "result_dir", str(tmp_path / "result"), "ep_iter", "1",
                   "save_ep", "1000", "save_latest_ep", "1",
                   "fix_random", "True", "train.epoch", str(epochs),
                   "eval_ep", "1", *extra]


def test_eval_ep_keeps_best_on_improvement(monkeypatch, tmp_path):
    """`eval_ep 1`: a "val" line each epoch with `val_<metric>`;
    `best.flax` and `best.json` written when the PSNR is finite and
    beats the retained best, in JAX's layout (its `load_checkpoint`
    with use_best reads it), and kept across a resume, which must beat
    the retained value; `skip_eval` evaluates nothing."""
    psnrs = iter([10.0, 9.0, 11.0, float("nan"), 10.5, 12.0])
    seen = []

    def fake_eval(cfg, model, device, ctx):
        seen.append(sorted(ctx))
        ctx["called"] = True
        return {"mse": 0.1, "psnr": next(psnrs), "ssim": 0.5}

    monkeypatch.setattr(t_engine, "periodic_eval", fake_eval)
    tc = load_config(CFG, train_opts(tmp_path, 4))
    write_fresh_start(CKPT, tc.trained_model_dir)
    t_engine.run_train(tc, "cpu")
    best = best_metric(tc.trained_model_dir)
    assert best == {"metric": 11.0, "epoch": 2, "step": 3}
    assert seen == [[]] + [["called"]] * 3  # one context for the run
    lines = [json.loads(l) for l in
             open(os.path.join(tc.record_dir, "scalars.jsonl"))]
    val = [l["val"] for l in lines if "val" in l]
    assert [v["epoch"] for v in val] == [0, 1, 2, 3]
    assert [v["val_psnr"] for v in val[:3]] == [10.0, 9.0, 11.0]
    assert all(set(v) >= {"val_mse", "val_psnr", "val_ssim"} for v in val)
    jc = j_load_config(CFG, train_opts(tmp_path, 4))
    raw = flax_msgpack.read_checkpoint(
        os.path.join(tc.trained_model_dir, "best.flax"))
    jp = jax.tree_util.tree_map(jnp.asarray, raw["params"])
    out = j_load_checkpoint(tc.trained_model_dir, jp,
                            jax_tx(jc, jp, False).init(jp), use_best=True)
    assert out[2:4] == (2, 3)
    # a resumed run: 10.5 does not beat 11, 12 does
    tc2 = load_config(CFG, train_opts(tmp_path, 6))
    t_engine.run_train(tc2, "cpu")
    assert best_metric(tc.trained_model_dir) == {"metric": 12.0, "epoch": 5,
                                                 "step": 6}
    seen.clear()
    t_engine.run_train(load_config(CFG, train_opts(
        tmp_path, 7, ["skip_eval", "True"])), "cpu")
    assert seen == []


def test_periodic_eval_renders_the_trainers_weights(monkeypatch, tmp_path):
    """`periodic_eval` (JAX `_periodic_eval`): one Engine and test split
    in eval mode for the run, kept in the context; each call renders the
    first two test items with the model's current weights and
    summarizes them without saving images."""
    tc = load_config(CFG, train_opts(tmp_path, 1))
    model = t_engine.make_model(tc)
    seen = []

    def render_item(self, item, visibility=False):
        weights = self.model.state_dict()
        seen.append((id(self), int(item["frame_index"]), int(item["cam_ind"]),
                     all(torch.equal(v, weights[k])
                         for k, v in model.state_dict().items())))
        return {"rgb_map": 0.5 * np.asarray(item["rgb"])}, len(item["rgb"])

    monkeypatch.setattr(t_engine.Engine, "render_item", render_item)
    ctx = {}
    metrics = []
    for _ in range(2):
        metrics.append(t_engine.periodic_eval(tc, model, torch.device("cpu"),
                                              ctx))
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    assert ctx["cfg"].eval and not tc.get("eval", False)
    ds = ctx["ds"]
    assert [s[1:] for s in seen] == [(int(ds[i]["frame_index"]),
                                      int(ds[i]["cam_ind"]), True)
                                     for i in (0, 1)] * 2
    assert len({s[0] for s in seen}) == 1
    want = np.mean([-10 * np.log10(np.mean((0.5 * ds[i]["rgb"]
                                            - ds[i]["rgb"]) ** 2))
                    for i in (0, 1)])
    for m in metrics:
        assert set(m) == {"mse", "psnr", "ssim"}
        np.testing.assert_allclose(m["psnr"], want, rtol=1e-6)
    assert not os.path.exists(os.path.join(ctx["cfg"].result_dir,
                                           "comparison"))


# ------------------------------------------------------ chunked steps
class ChunkCase:
    """A family's dense configs in both packages, the tracked weights,
    and JAX's jitted loss gradient with its trainer's settings at
    dense_chunk_rows CHUNK_ROWS."""

    def __init__(self, family):
        cfg_file = ("configs/synthetic.yaml" if family == "aninerf"
                    else f"configs/synthetic_{family}.yaml")
        exp = "synthetic" if family == "aninerf" else f"synthetic_{family}"
        self.jc = j_load_config(cfg_file, OPTS)
        self.tc = load_config(cfg_file, OPTS)
        self.params = flax_msgpack.read_checkpoint(
            f"data/trained_model/deform/{exp}/latest.flax")["params"]
        self.datasets = (j_engine.make_dataset(self.jc, "train"),
                         t_engine.make_dataset(self.tc, "train"))
        self.trainer = JTrainer(self.jc, j_engine.make_model(self.jc))
        # neither Trainer reads the config key (their train calls chunk
        # at the default): the bound is set on each one's settings
        self.trainer.settings = self.trainer.settings._replace(
            dense_chunk_rows=CHUNK_ROWS)
        self.grad = jax.jit(jax.grad(
            lambda p, fb, key: self.trainer._loss_one(p, fb, key, 0),
            has_aux=True))

    def batches(self, index, seed, away=None):
        """Item `index`'s rays; with `away`, rays [away:] moved 10 m
        off the body, so their chunk holds no candidate."""
        j_ds, t_ds = self.datasets
        j_ds._rng = np.random.RandomState(seed)
        t_ds._rng = np.random.RandomState(seed)
        jb = j_collate_rays(j_ds[index], N_RAND)
        tb = collate_rays(t_ds[index], N_RAND)
        if away is not None:
            for b in (jb, tb):
                b["ray_o"] = b["ray_o"].copy()
                b["ray_o"][away:] += np.float32(10.0)
        return jb, tb

    def port_step(self, tb, chunk_rows):
        model = t_engine.make_model(self.tc)
        model.load_state_dict(param_codec(model)[0](self.params), strict=True)
        trainer = Trainer(self.tc, model, "cpu")
        trainer.settings = trainer.settings._replace(
            dense_chunk_rows=chunk_rows)
        loss, stats, ret = trainer.loss(tb)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in model.named_parameters()}
        return ({k: float(v.detach()) for k, v in stats.items()}, ret,
                leaves(param_codec(model)[1](grads)))


_CHUNK_CASES = {}


def chunk_case(family):
    if family not in _CHUNK_CASES:
        _CHUNK_CASES[family] = ChunkCase(family)
    return _CHUNK_CASES[family]


@pytest.mark.parametrize("away", [None, 40], ids=["body", "empty_chunk"])
@pytest.mark.parametrize("family", ["aninerf", "sdf_pdf"])
def test_chunked_step_matches_jax(family, away):
    """64 rays at dense_chunk_rows 384: three chunks of 24 rays, the
    last padded. The loss, the stats and the gradient against JAX's
    chunked loss (`apply_model`'s lax.map) on the same batch and
    weights. With `empty_chunk` the last chunk's rays miss the body:
    its forced argmin keeps a point the whole step's would not, so the
    chunked step differs from the unchunked one."""
    case = chunk_case(family)
    jb, tb = case.batches(4, 0, away)
    fb = jax.tree_util.tree_map(jnp.asarray, jb)
    jp = jax.tree_util.tree_map(jnp.asarray, as_flax(case.params))
    j_grads, j_stats = case.grad(jp, fb, jax.random.PRNGKey(0))
    stats, ret, grads = case.port_step(tb, CHUNK_ROWS)
    for k, v in stats.items():
        np.testing.assert_allclose(v, float(j_stats[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    want = leaves(j_grads)
    assert grads.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(grads[k] - w).max() <= GRAD_REL * max(
            np.abs(w).max(), 1e-30), k
    assert ret["raw"].shape == (N_RAND, N_SAMPLES, 4)
    whole, w_ret, _ = case.port_step(tb, 0)
    mask = "bw_mask" if family == "aninerf" else "resd_mask"
    if away is None:
        return
    # the empty chunk forces a point of its own into the filter
    assert int(ret[mask].sum()) > int(w_ret[mask].sum())
    assert stats != whole


def test_unchunked_below_the_bound():
    """A dense call at or under dense_chunk_rows, a compacted call, and
    `dense_chunk_rows 0` take one train_forward."""
    from animatable_nerf_tpu_torch.render import renderer

    calls = []

    class Model:
        train_keep_frac = 0.0

        def train_forward(self, wpts, viewdir, z_vals, frame):
            calls.append(len(z_vals))
            return {"raw": torch.zeros(len(z_vals), z_vals.shape[1], 4)}

    z = torch.zeros(10, 4)
    m = Model()
    for bound in (40, 0, 1000):
        renderer.train_forward_chunked(m, torch.zeros(10, 4, 3),
                                       torch.zeros(10, 3), z, {}, bound)
    m.train_keep_frac = 0.5
    renderer.train_forward_chunked(m, torch.zeros(10, 4, 3),
                                   torch.zeros(10, 3), z, {}, 8)
    m.train_keep_frac = 0.0
    out = renderer.train_forward_chunked(m, torch.zeros(10, 4, 3),
                                         torch.zeros(10, 3), z, {}, 12)
    assert calls == [10, 10, 10, 10, 3, 3, 3, 3]
    assert out["raw"].shape == (10, 4, 4)


# ------------------------------------------------------- batch_size
def test_batch_size_two_trains_one_frame_a_step(tmp_path):
    """`train.batch_size 2` trains one frame a step, as JAX's trainer
    without a mesh does: two steps of it write the checkpoint that two
    steps at batch_size 1 write."""
    out = {}
    for bs in ("1", "2"):
        opts = train_opts(tmp_path / bs, 2, ["eval_ep", "1000",
                                             "train.batch_size", bs])
        tc = load_config(CFG, opts)
        write_fresh_start(CKPT, tc.trained_model_dir)
        trainer, _ = t_engine.run_train(tc, "cpu")
        assert trainer.step == trainer.updates == 2
        out[bs] = flax_msgpack.read_checkpoint(
            os.path.join(tc.trained_model_dir, "latest.flax"))
    a, b = leaves(out["1"]["params"]), leaves(out["2"]["params"])
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)
