"""Configuration system: yaml files with recursive `parent_cfg`
inheritance, CLI `key value` overrides, and conditional mode overlays.

JAX counterpart: animatable_nerf_tpu/config/config.py:24-370 (Config,
default_config, parent_cfg inheritance, opts applied twice, the
type-guarded literal_eval and the derived model/record/result dirs).
The yaml files are read with config/yaml_lite.py, since PyYAML is not
installed on every machine the port runs on.

Preserves the reference's config surface (lib/config/config.py +
lib/config/yacs.py): the same yaml files, the same override ordering
(opts applied both before AND after mode overlays — config.py:162,176),
the same derived result/model/record paths. Differences by design:
no global mutable `cfg` imported at module load — configs are explicit
objects passed down.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os

from .yaml_lite import load_file


class Config(dict):
    """Nested dict with attribute access (a minimal, non-global yacs)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        return v

    @classmethod
    def from_dict(cls, d):
        return cls({k: cls._wrap(v) for k, v in d.items()})

    @staticmethod
    def _decode(v):
        """yacs `_decode_cfg_value` semantics (lib/config/yacs.py:423-453):
        every string value is offered to literal_eval and passes through
        unchanged when it represents a plain string. This is what makes
        the reference accept `lr: 5e-4` in yaml — YAML 1.1 parses it as
        a STRING (no dot), and yacs decodes it to a float."""
        if isinstance(v, str):
            try:
                return ast.literal_eval(v)
            except (ValueError, SyntaxError):
                return v
        return v

    @staticmethod
    def _type_ok(dec, cur):
        """Whether a literal_eval-decoded replacement value is
        type-compatible with the existing entry (yacs
        _check_and_coerce_cfg_value_type semantics: exact type match,
        with int<->float numeric casts and list<->tuple allowed)."""
        if cur is None or isinstance(cur, dict):
            return True
        if isinstance(cur, str):
            return isinstance(dec, str)
        if isinstance(cur, bool):
            return isinstance(dec, bool)
        if isinstance(cur, (int, float)):
            return isinstance(dec, (int, float)) and not isinstance(dec, bool)
        if isinstance(cur, (list, tuple)):
            return isinstance(dec, (list, tuple))
        return isinstance(dec, type(cur))

    def merge(self, other: dict, decode: bool = True):
        """Recursive merge (yacs merge_from_other_cfg semantics).

        `decode=False` defers the literal_eval decoding: used when
        assembling the parent_cfg chain into an empty tree, where no
        defaults exist yet to type-check against (strings stay raw so
        the final merge into the defaulted config can apply the yacs
        type guard)."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], dict)
                and isinstance(v, dict)
            ):
                node = (
                    self[k] if isinstance(self[k], Config)
                    else Config._wrap(self[k])
                )
                node.merge(v, decode=decode)
            elif not decode:
                self[k] = Config._wrap(v)
            else:
                dec = Config._decode(v)
                # yacs _check_and_coerce_cfg_value_type: a decoded value
                # whose type no longer matches the existing entry's type
                # is rejected (yacs raises; we keep the raw string so
                # `exp_name: '313'` stays the string "313" instead of
                # silently becoming int 313 and breaking path joins).
                if (
                    k in self
                    and isinstance(v, str)
                    and dec is not v
                    and not Config._type_ok(dec, self[k])
                ):
                    dec = v
                self[k] = Config._wrap(dec)
        return self

    def merge_from_list(self, opts):
        """CLI `key value` pairs; dotted keys descend into sub-configs
        (yacs merge_from_list)."""
        assert len(opts) % 2 == 0, f"override list must be key/value pairs: {opts}"
        for k, v in zip(opts[0::2], opts[1::2]):
            try:
                val = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                val = v
            node = self
            parts = k.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = Config()
                node = node[p]
            leaf = parts[-1]
            if (
                leaf in node
                and val is not v
                and not Config._type_ok(val, node[leaf])
            ):
                val = v
            node[leaf] = Config._wrap(val)
        return self

    def clone(self):
        return Config.from_dict(copy.deepcopy(dict(self)))


def default_config() -> Config:
    """Defaults mirroring lib/config/config.py:9-137 plus the yaml-level
    defaults every experiment config sets (aninerf_s9p.yaml etc.)."""
    return Config.from_dict(
        {
            "parent_cfg": "",
            "exp_name": "hello",
            "task": "deform",
            "gpus": [0],
            "distributed": False,
            # module selection (registry keys — reference module paths OK)
            "network_module": "aninerf",
            "train_dataset_module": "lib.datasets.tpose_dataset",
            "test_dataset_module": "lib.datasets.tpose_dataset",
            "renderer_module": "lib.networks.renderer.tpose_renderer",
            "trainer_module": "lib.train.trainers.tpose_trainer",
            "evaluator_module": "lib.evaluators.if_nerf",
            "visualizer_module": "lib.visualizers.if_nerf",
            # data
            "human": 313,
            "training_view": [0, 6, 12, 18],
            "test_view": [],
            "begin_ith_frame": 0,
            "num_train_frame": 1,
            "num_eval_frame": -1,
            "frame_interval": 1,
            "smpl": "smpl",
            "vertices": "vertices",
            "params": "params",
            "mask_bkgd": True,
            "big_box": False,
            "box_padding": 0.05,
            "body_sample_ratio": 0.5,
            "face_sample_ratio": 0.0,
            "ratio": 1.0,
            "H": 1024,
            "W": 1024,
            "erode_edge": True,
            "train_dataset": {
                "data_root": "",
                "human": "",
                "ann_file": "",
                "split": "train",
            },
            "test_dataset": {
                "data_root": "",
                "human": "",
                "ann_file": "",
                "split": "test",
            },
            # network / rendering
            "point_feature": 9,
            "num_latent_code": -1,
            "xyz_res": 10,
            "view_res": 4,
            "N_samples": 64,
            "N_importance": 128,
            # the reference never calls sample_pdf (N_importance is dead
            # there); set True to enable the live hierarchical sampling
            # implemented in render/renderer.py
            "use_importance": False,
            "N_rand": 1024,
            "perturb": 1,
            "white_bkgd": False,
            "raw_noise_std": 0,
            "norm_th": 0.05,
            "train_th": 0.0,
            "tpose_viewdir": True,
            "use_bigpose": False,
            "color_with_viewdir": True,
            "mesh_th": 50,
            "voxel_size": [0.005, 0.005, 0.005],
            "render_views": 50,
            # train
            "train": {
                "batch_size": 1,
                "lr": 5e-4,
                "weight_decay": 0.0,
                "epoch": 400,
                "optim": "adam",
                "scheduler": {
                    "type": "exponential",
                    "gamma": 0.1,
                    "decay_epochs": 1000,
                    "milestones": [80, 120, 200, 240],
                },
                "num_workers": 8,
                # JAX-package training knobs, kept so configs resolve
                # identically in both packages
                "steps_per_dispatch": 1,
                "frame_store_mb": 4096,
                "shuffle": True,
                "collator": "",
                "batch_sampler": "default",
                # converted VGG19-head weights (tools/convert_vgg_weights.py)
                # switch the NHR/NT trainers to the exact reference
                # perceptual objective (lib/losses/nhr_perceptual_loss.py);
                # "" uses the documented multi-scale stand-in
                "vgg_weights": "",
                # reference parity flag (lib/config/config.py:85): gates
                # the VGGPerceptualLoss import there; both losses are
                # always importable here (train/perceptual.py)
                "use_vgg": False,
            },
            "test": {
                "batch_size": 1,
                "sampler": "FrameSampler",
                "frame_sampler_interval": 30,
                "begin_sampler_ind": 0,
                "num_sampler_ind": -1,
                "epoch": -1,
                "batch_sampler": "default",
            },
            "ep_iter": 500,
            "save_ep": 200,
            "save_latest_ep": 5,
            "eval_ep": 1000,
            "log_interval": 20,
            "record_interval": 20,
            # modes
            "aninerf_animation": False,
            # stage-2 consistency samples per branch per step
            # (aninerf_animation_trainer.py:131 hard-codes 1024*64)
            "n_anim_samples": 1024 * 64,
            "init_aninerf": "no_pretrain",
            "init_sdf": "",
            "test_novel_pose": False,
            "novel_pose_ni": 100,
            "vis_pose_sequence": False,
            "vis_novel_view": False,
            "vis_tpose_mesh": False,
            "vis_posed_mesh": False,
            "eval": False,
            "skip_eval": False,
            "fix_random": False,
            "resume": True,
            # dirs
            "trained_model_dir": "data/trained_model",
            "record_dir": "data/record",
            "result_dir": "data/result",
            # rays per eval tile (render/renderer.py render_image)
            "eval_tile": 8192,
            # eval-time survivor compaction capacity as a fraction of the
            # sampled points (models/common.py compact_indices); 0 = off
            "eval_keep_frac": 0.25,
            # eval stage-2 trunk compaction ratio for the KNN families
            # (models/pdf.py _eval_compacted); 0 disables
            "stage2_ratio": 0.85,
            "compute_dtype": "float32",
        }
    )


def _load_yaml_with_parents(path: str, seen=None) -> Config:
    """Recursive parent_cfg / parent_cfgs inheritance
    (lib/config/yacs.py:167-178)."""
    seen = seen or set()
    if path in seen:
        raise ValueError(f"circular parent_cfg chain at {path}")
    seen.add(path)
    current = load_file(path) or {}
    parents = []
    if "parent_cfg" in current and current["parent_cfg"]:
        parents = [current["parent_cfg"]]
    if "parent_cfgs" in current:
        parents = list(current["parent_cfgs"])
    base = Config()
    for p in parents:
        if not os.path.exists(p):
            # resolve relative to the child config's directory
            cand = os.path.join(os.path.dirname(path), p)
            p = cand if os.path.exists(cand) else p
        base.merge(_load_yaml_with_parents(p, seen), decode=False)
    base.merge(current, decode=False)
    return base


def load_config(cfg_file: str, opts=(), run_type: str = "") -> Config:
    """Full config assembly (lib/config/config.py:156-180)."""
    cfg = default_config()
    if run_type:
        # pre-yaml default only: an explicit `task:` in the yaml wins
        # (reference sets cfg.task = "run" before make_cfg — run.py-era
        # config.py:192-193)
        cfg.task = "run"
    cfg.merge(_load_yaml_with_parents(cfg_file))
    cfg.merge_from_list(list(opts))

    if cfg.aninerf_animation and "aninerf_animation_cfg" in cfg:
        cfg.merge(cfg.aninerf_animation_cfg)
    if cfg.get("vis_pose_sequence") and "pose_sequence_cfg" in cfg:
        cfg.merge(cfg.pose_sequence_cfg)
    if cfg.get("vis_novel_view") and "novel_view_cfg" in cfg:
        cfg.merge(cfg.novel_view_cfg)
    if (cfg.get("vis_tpose_mesh") or cfg.get("vis_posed_mesh")) and "mesh_cfg" in cfg:
        cfg.merge(cfg.mesh_cfg)

    cfg.merge_from_list(list(opts))  # opts win over overlays, like the reference

    # raw_noise_std is a vestigial key: every shipped reference config
    # sets it to 0 and NOTHING consumes it — the reference's raw2outputs
    # (nerf_net_utils.py:6-36) has no noise branch (the key survives
    # from the original NeRF codebase). Reject loudly instead of
    # silently ignoring a value that looks like it regularizes.
    if float(cfg.get("raw_noise_std", 0) or 0) != 0.0:
        raise ValueError(
            "raw_noise_std != 0 is not implemented: the reference's own "
            "raw2outputs has no density-noise path (the key is dead in "
            "every shipped config); set it to 0"
        )

    # derived fields (config.py:140-153)
    if cfg.num_latent_code < 0:
        cfg.num_latent_code = cfg.num_train_frame
    cfg.trained_model_dir = os.path.join(cfg["trained_model_dir"], cfg.task, cfg.exp_name)
    cfg.record_dir = os.path.join(cfg["record_dir"], cfg.task, cfg.exp_name)
    cfg.result_dir = os.path.join(cfg["result_dir"], cfg.task, cfg.exp_name)
    return cfg


def parse_cli(argv=None):
    """The reference CLI surface (lib/config/config.py:183-194)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default="configs/default.yaml", type=str)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--type", type=str, default="")
    parser.add_argument("--det", type=str, default="")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the run (cuda unless 'cpu' is asked for)",
    )
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_config(args.cfg_file, args.opts or [], run_type=args.type)
    return args, cfg
