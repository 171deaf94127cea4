"""Import a reference PyTorch checkpoint (.pth) into the port.

JAX counterpart: tools/import_torch_checkpoint.py (`_converter_for` :36,
`_verify` :61, `main` :122). The reference saves `{net, optim,
scheduler, recorder, epoch}` (lib/utils/net_utils.py:325-338). The
config's `network_module` picks the family (the eight volumetric
families; any other is refused, as JAX refuses it), its model takes the
`net` dict by compat/torch_import.py `load_reference_state_dict`, a
strict load that stands in for JAX's structural check, and
train/checkpoints.py `save_checkpoint` writes `latest.flax` and
`<epoch>.flax` into the config's model dir (or `--out`) without
optimizer state, where both packages' `run --type evaluate` read it.
A checkpoint with `novel_pose_bw.*` (stage 2) is loaded into the model
with its novel-pose field. `--no-verify` is taken for the JAX tool's
flag and changes nothing: there it skips a check against model.init
after a conversion that has already refused a missing key, and here the
strict load is the conversion and the check at once, so a name missing
on either side always raises and nothing is written.

    python -m animatable_nerf_tpu_torch.tools.import_torch_checkpoint \\
        --cfg_file configs/aninerf_313.yaml --pth /path/to/latest.pth \\
        [--out DIR] [--no-verify] [opts key value ...]
"""

from __future__ import annotations

import argparse

from ..compat.torch_export import FAMILY_OF, family_of
from ..compat.torch_import import load_reference_state_dict, load_torch_state_dict
from ..config import load_config
from ..engine import make_model, model_class
from ..train.checkpoints import save_checkpoint

def model_for(cfg, state: dict):
    """The config's model, with its novel-pose field where `state`
    holds one; a family without a converter in JAX raises SystemExit."""
    cls = model_class(cfg)
    if cls.__name__ not in FAMILY_OF:
        raise SystemExit(
            f"no torch converter for network_module={cfg.network_module!r} "
            f"({cls.__name__}); importable families: " + ", ".join(FAMILY_OF))
    if any(k.startswith("novel_pose_bw.") for k in state):
        cfg.test_novel_pose = True
    return make_model(cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--pth", required=True,
                        help="reference .pth checkpoint to import")
    parser.add_argument("--out", default="",
                        help="output dir (default: the config's model dir)")
    parser.add_argument("--no-verify", action="store_true",
                        help="accepted as the JAX tool's flag; the load "
                             "stays strict")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg_file, args.opts or [])
    state, epoch = load_torch_state_dict(args.pth)
    model = model_for(cfg, state)
    load_reference_state_dict(model, state)
    out_dir = args.out or cfg.trained_model_dir
    step = epoch * max(int(cfg.ep_iter), 1)
    save_checkpoint(out_dir, model, None, epoch=epoch, step=step, latest=True)
    save_checkpoint(out_dir, model, None, epoch=epoch, step=step)
    print(f"imported {args.pth} ({type(model).__name__}, {family_of(model)}, "
          f"epoch {epoch}) -> {out_dir}/latest.flax")


if __name__ == "__main__":
    main()
