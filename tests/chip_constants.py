"""The JAX package's constants of chip_smoke.py phase 22, computed on the
CPU of a machine with JAX and OpenCV (never on the card):

    JAX_PLATFORMS=cpu python tests/chip_constants.py

prints NT's vgg_loss and l1_loss under `train.vgg_weights` at phase 17's
start (JAX_VGG_NT) and the drawn pixels of JAX's tools/render_skeleton.py
on chip_smoke's `skeleton_root` (JAX_SKELETON_PIXELS). The inputs are
built by chip_smoke.py's own helpers, so both sides read the same files.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import chip_smoke as c  # noqa: E402


def jax_vgg_constants():
    """NT's loss stats under the VGG objective at the start, and the
    skeleton's drawn pixels."""
    import shutil
    import tempfile

    import cv2
    import jax

    from animatable_nerf_tpu import engine as j_engine
    from animatable_nerf_tpu.config import load_config as j_load_config
    from animatable_nerf_tpu.train.baseline import BaselineTrainer
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.baseline_prep import (
        config_opts, write_baseline_copy)
    from animatable_nerf_tpu_torch.engine import initial_model
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import render_skeleton

    tmp = tempfile.mkdtemp(prefix="jax_constants_")
    try:
        copy = write_baseline_copy("data/synthetic/capsule",
                                   os.path.join(tmp, "capsule"))
        opts = config_opts(copy) + ["train.vgg_weights", c.vgg_weights_npz(tmp)]
        jcfg = j_load_config("configs/synthetic_nt.yaml", list(opts))
        model = initial_model(load_config("configs/synthetic_nt.yaml", opts))
        params = jax.tree_util.tree_map(np.asarray, param_codec(model)[1](
            dict(model.named_parameters())))
        trainer = BaselineTrainer(jcfg, j_engine.make_model(jcfg))
        item = j_engine.make_dataset(jcfg, "train")[0]
        _, stats = jax.jit(trainer._loss)(params, trainer._frame(item),
                                          trainer._vgg)
        print({k: float(stats[k]) for k in ("vgg_loss", "l1_loss")})
        data_dir, human = c.skeleton_root(tmp)
        out = render_skeleton.render_human(data_dir, human, max_frames=1)
        img = cv2.imread(os.path.join(out, "0_0.png"))
        print({"skeleton_pixels": int((img.sum(-1) > 0).sum())})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    jax_vgg_constants()
