"""Training checkpoints in the JAX package's format.

JAX counterpart: animatable_nerf_tpu/train/checkpoints.py
(`save_checkpoint` :33, `_prune` :104, `latest_epoch` :115,
`load_checkpoint` :128; reference lib/utils/net_utils.py:288-347).
A checkpoint is a flax msgpack file, `<epoch>.flax` (the 20 newest
kept) or `latest.flax`, of {params, opt_state, epoch, step, recorder}:
`params` is the JAX param tree (compat/jax_params.py) and `opt_state`
the state dict of JAX's optimizer, optax.chain(clip(40), <optimizer>)
(train/optim.py `optimizer_kind`): {"0": {} (the clip), "1": the
optimizer's chain}, which is {"0": {count, mu, nu}, "1": {count}} for
adam and radam (the update count, the moments as param trees, then the
schedule's count), {"0": {count, mu, nu}, "1": {}, "2": {count}} for
adamw (the decayed weights keep no state) and {"0": {trace}, "1":
{count}} for sgd. Stage 2 (a model with `novel_pose_bw`, which alone
trains) has JAX's optax.multi_transform layout (train/optim.py:83-95):
that chain's state under {"inner_states": {"train": {"inner_state":
...}}}, beside {"freeze": {"inner_state": {}}}, with every leaf of the
moments outside `novel_pose_bw` an empty node (optax's MaskedNode).
So the JAX package's `load_checkpoint` and `run.py --type evaluate`
read what the port writes, and the port resumes from what JAX writes.
Every ported family is handled (`param_codec`): AniNeRF, NeRF-PDF,
SDF-PDF, NeuS-PDF, the four aligned families, and the baselines NHR and
NT, whose batch norms' `running_mean` / `running_var` are parameters
without a gradient, written into `params` with Adam moments of 0 as
flax keeps them. `best.flax` and
`best.json` (`save_best_checkpoint`, JAX :60-102) keep the run's best
val PSNR. `load_params_partial`
is the weights-only, non-strict load of `init_aninerf` (JAX :167-204).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..compat.flax_msgpack import read_checkpoint, write_checkpoint
from ..compat.jax_params import (
    aligned_lbw_param_tree,
    aligned_lbw_pdf_param_tree,
    aligned_pbw_param_tree,
    aligned_smpl_param_tree,
    aligned_state_dict,
    aninerf_param_tree,
    aninerf_state_dict,
    nerf_pdf_param_tree,
    nerf_pdf_state_dict,
    neus_pdf_param_tree,
    neus_pdf_state_dict,
    nhr_param_tree,
    nhr_state_dict,
    nt_param_tree,
    nt_state_dict,
    sdf_pdf_param_tree,
    sdf_pdf_state_dict,
)
from ..baselines.nhr import NHR
from ..baselines.nt import NT
from ..models.aligned import AlignedLBW, AlignedLBWPDF, AlignedPBW, AlignedSMPL
from ..models.aninerf import AniNeRF
from ..models.pdf import NeRFPDF, NeuSPDF, SDFPDF

# (JAX param tree -> state dict, state dict -> JAX param tree) by model
_CODECS = {AniNeRF: (aninerf_state_dict, aninerf_param_tree),
           NeRFPDF: (nerf_pdf_state_dict, nerf_pdf_param_tree),
           SDFPDF: (sdf_pdf_state_dict, sdf_pdf_param_tree),
           NeuSPDF: (neus_pdf_state_dict, neus_pdf_param_tree),
           AlignedLBW: (aligned_state_dict, aligned_lbw_param_tree),
           AlignedPBW: (aligned_state_dict, aligned_pbw_param_tree),
           AlignedSMPL: (aligned_state_dict, aligned_smpl_param_tree),
           AlignedLBWPDF: (aligned_state_dict, aligned_lbw_pdf_param_tree),
           NHR: (nhr_state_dict, nhr_param_tree),
           NT: (nt_state_dict, nt_param_tree)}


def param_codec(model):
    """(state_dict, param_tree): the converters between the JAX param
    tree and the state dict of `model`'s family (compat/jax_params.py)."""
    return _CODECS[type(model)]


# the moments each optimizer keeps (optax's names) and the torch
# state key that holds each (train/optim.py)
_SLOTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "radam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "sgd": {"trace": "momentum_buffer"}}


def optimizer_slots(model, optimizer):
    """(count, {slot: {name: tensor}}): the optimizer's update count and
    its moments by optax name (mu, nu; sgd's trace) and parameter name
    (zeros before the first update, and for parameters it does not
    hold)."""
    keys = _SLOTS[optimizer.kind]
    slots, count = {slot: {} for slot in keys}, 0
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        if "step" in state:
            count = int(state["step"])
        for slot, key in keys.items():
            slots[slot][name] = state.get(key, torch.zeros_like(p))
    return count, slots


def adam_moments(model, optimizer):
    """(count, mu, nu) of an Adam-type optimizer (adam, adamw, radam)
    over `model`'s parameters, by parameter name."""
    count, slots = optimizer_slots(model, optimizer)
    return count, slots["mu"], slots["nu"]


# the only subtree stage 2 trains (JAX train/animation.py:34-44)
TRAINED_IN_STAGE2 = "novel_pose_bw"


def _is_list(tree) -> bool:
    """Whether a dict is a flax list as msgpack stores it, keyed "0",
    "1", ... (the aligned families' `nerf_network/layers`)."""
    return bool(tree) and sorted(tree) == sorted(map(str, range(len(tree))))


def _outside_masked(tree, inside: bool = False):
    """`tree` with every leaf outside the TRAINED_IN_STAGE2 subtree an
    empty node, as optax masks a frozen leaf. JAX's trainable mask
    (train/animation.py:34-44) descends dicts only, so a frozen list is
    one masked node, not a list of them."""
    if not inside and (not isinstance(tree, dict) or _is_list(tree)):
        return {}
    if isinstance(tree, dict):
        return {k: _outside_masked(v, inside or k == TRAINED_IN_STAGE2)
                for k, v in tree.items()}
    return tree


def _unmasked(tree, params):
    """The inverse for reading: each empty node where `params` has a
    leaf becomes zeros of that leaf's shape."""
    if isinstance(params, dict):
        return {k: _unmasked(tree.get(k, {}), v) for k, v in params.items()}
    if isinstance(tree, dict):
        return np.zeros(np.shape(params), np.float32)
    return tree


def opt_state_tree(count: int, slots: dict, stage2: bool = False,
                   kind: str = "adam") -> dict:
    """The state dict of JAX's optax.chain(clip(40), <kind>) from the
    optimizer's moments as JAX param trees (`slots`: mu and nu, or sgd's
    trace); with `stage2`, inside the multi_transform layout, the
    moments of the frozen leaves masked."""
    c = np.asarray(count, np.int32)
    if stage2:
        slots = {k: _outside_masked(v) for k, v in slots.items()}
    first = ({"trace": slots["trace"]} if kind == "sgd"
             else {"count": c, "mu": slots["mu"], "nu": slots["nu"]})
    parts = [first, *([{}] if kind == "adamw" else []), {"count": c.copy()}]
    chain = {"0": {}, "1": {str(i): v for i, v in enumerate(parts)}}
    if not stage2:
        return chain
    return {"inner_states": {"freeze": {"inner_state": {}},
                             "train": {"inner_state": chain}}}


def _optimizer_node(opt_state: dict) -> dict:
    """The optimizer's chain (after the clip) of a checkpoint's
    opt_state in either layout; empty where the file has none."""
    if "inner_states" in opt_state:
        opt_state = opt_state["inner_states"]["train"]["inner_state"]
    return opt_state.get("1", {})


def _checkpoint_tree(model, optimizer, epoch: int, step: int,
                     recorder_state: dict | None) -> dict:
    to_tree = param_codec(model)[1]
    count, slots = optimizer_slots(model, optimizer)
    return {
        "params": to_tree(dict(model.named_parameters())),
        "opt_state": opt_state_tree(
            count, {k: to_tree(v) for k, v in slots.items()},
            hasattr(model, TRAINED_IN_STAGE2), optimizer.kind),
        "epoch": np.asarray(epoch, np.int64),
        "step": np.asarray(step, np.int64),
        "recorder": recorder_state or {},
    }


def save_checkpoint(model_dir: str, model, optimizer, epoch: int, step: int,
                    recorder_state: dict | None = None, latest: bool = False,
                    keep: int = 20):
    """Write `latest.flax` or `<epoch>.flax` (then keep the `keep`
    newest snapshots). `step` counts the frames trained on."""
    os.makedirs(model_dir, exist_ok=True)
    name = "latest.flax" if latest else f"{epoch}.flax"
    write_checkpoint(os.path.join(model_dir, name),
                     _checkpoint_tree(model, optimizer, epoch, step,
                                      recorder_state))
    if not latest:
        _prune(model_dir, keep)


def best_metric(model_dir: str):
    """The retained best's record {metric, epoch, step} from
    `best.json`, or None (JAX :60-69): the sidecar carries the value a
    resumed run must beat."""
    path = os.path.join(model_dir, "best.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_best_checkpoint(model_dir: str, model, optimizer, epoch: int,
                         step: int, metric: float,
                         recorder_state: dict | None = None) -> bool:
    """Write `best.flax` (the params and the optimizer state, as
    `save_checkpoint`) and `best.json` {metric, epoch, step} iff
    `metric` (higher is better: the val PSNR) beats the retained best
    (JAX :72-102). Returns whether it wrote them."""
    prev = best_metric(model_dir)
    if prev is not None and float(prev["metric"]) >= float(metric):
        return False
    os.makedirs(model_dir, exist_ok=True)
    write_checkpoint(os.path.join(model_dir, "best.flax"),
                     _checkpoint_tree(model, optimizer, epoch, step,
                                      recorder_state))
    with open(os.path.join(model_dir, "best.json"), "w") as f:
        json.dump({"metric": float(metric), "epoch": int(epoch),
                   "step": int(step)}, f)
    return True


def _snapshots(model_dir: str) -> list:
    return sorted(int(p[:-5]) for p in os.listdir(model_dir)
                  if p.endswith(".flax") and p[:-5].isdigit())


def _prune(model_dir: str, keep: int):
    snaps = _snapshots(model_dir)
    for e in snaps[: max(len(snaps) - keep, 0)]:
        os.remove(os.path.join(model_dir, f"{e}.flax"))


def checkpoint_file(model_dir: str) -> str | None:
    """The file a resume reads: `latest.flax`, else the newest
    snapshot; None if there is neither."""
    if os.path.exists(os.path.join(model_dir, "latest.flax")):
        return os.path.join(model_dir, "latest.flax")
    snaps = _snapshots(model_dir) if os.path.isdir(model_dir) else []
    return os.path.join(model_dir, f"{snaps[-1]}.flax") if snaps else None


def set_optimizer_state(model, optimizer, count: int, slots: dict):
    """Give the optimizer the update count and moments of a checkpoint
    (`slots`: {optax slot: {parameter name: tensor}}), for each
    parameter it optimizes."""
    keys = _SLOTS[optimizer.kind]
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for name, p in model.named_parameters():
        if id(p) not in owned:
            continue
        state = {key: slots[slot][name].to(p.device).reshape(p.shape).clone()
                 for slot, key in keys.items()}
        state["step"] = count
        optimizer.state[p] = state


def load_checkpoint(model_dir: str, model, optimizer=None):
    """Restore the checkpoint `checkpoint_file` picks into `model`
    (strictly) and, where given and the file has one, the optimizer's
    state into `optimizer`; a state of another optimizer than
    `optimizer`'s raises, as JAX's `from_state_dict` does. Returns
    (epoch, step, updates, recorder_state), `updates` being the
    schedule's update count (0 without an optimizer state), or None
    when there is nothing to resume."""
    path = checkpoint_file(model_dir)
    if path is None:
        return None
    raw = read_checkpoint(path)
    to_state = param_codec(model)[0]
    model.load_state_dict(to_state(raw["params"]), strict=True)
    node = _optimizer_node(raw.get("opt_state", {}))
    updates = 0
    if optimizer is not None and node:
        kind = optimizer.kind
        want = opt_state_tree(0, {k: {} for k in _SLOTS[kind]}, kind=kind)["1"]
        if (sorted(node) != sorted(want)
                or sorted(node["0"]) != sorted(want["0"])):
            raise ValueError(f"{path}: its optimizer state is not {kind}'s")
        updates = int(node[str(len(node) - 1)]["count"])
        set_optimizer_state(model, optimizer, updates, {
            slot: to_state(_unmasked(node["0"][slot], raw["params"]))
            for slot in _SLOTS[kind]})
    return int(raw["epoch"]), int(raw["step"]), updates, raw.get("recorder", {})


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return np.zeros_like(np.asarray(tree, np.float32))


def write_start(model_dir: str, params: dict, kind: str = "adam"):
    """A `latest.flax` in `model_dir` that resumes as a fresh run from
    the JAX param tree `params` (of any family, stage 1 or, with
    `novel_pose_bw`, stage 2) under the optimizer `kind`: zero moments,
    update count 0, step 0, epoch -1 (so training starts at epoch 0).
    Either package's trainer, with `resume True`, then trains from those
    weights."""
    os.makedirs(model_dir, exist_ok=True)
    zeros = _zeros_like_tree(params)
    write_checkpoint(os.path.join(model_dir, "latest.flax"), {
        "params": params, "opt_state": opt_state_tree(
            0, {k: zeros for k in _SLOTS[kind]},
            TRAINED_IN_STAGE2 in params.get("params", params), kind),
        "epoch": np.asarray(-1, np.int64), "step": np.asarray(0, np.int64),
        "recorder": {"step": 0}})


def write_fresh_start(src_path: str, model_dir: str):
    """`write_start` (Adam's state) from the params of checkpoint
    `src_path`."""
    write_start(model_dir, read_checkpoint(src_path)["params"])


def _merged(template, src):
    """JAX load_params_partial's merge at strict=False: each leaf of
    `template` that `src` has, reshaped to the template's shape; the
    others as they are."""
    out = {}
    for k, v in template.items():
        if k not in src:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _merged(v, src[k])
        else:
            out[k] = np.asarray(src[k]).reshape(np.shape(v))
    return out


def load_params_partial(model_dir: str, model):
    """The weights of the checkpoint `checkpoint_file` picks in
    `model_dir` loaded into `model` where it has them; the parameters
    the file lacks keep their values (JAX load_params_partial at
    strict=False, only=None; reference net_utils.py:357-396). Raises
    FileNotFoundError when there is no checkpoint."""
    path = checkpoint_file(model_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    raw = read_checkpoint(path)
    to_state, to_tree = param_codec(model)
    template = to_tree(dict(model.named_parameters()))
    merged = _merged(template, raw["params"] if "params" in raw else raw)
    model.load_state_dict(to_state(merged), strict=True)
