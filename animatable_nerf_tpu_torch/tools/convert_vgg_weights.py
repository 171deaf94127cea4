"""Convert torch VGG weights to the .npz train/perceptual.py loads.

JAX counterpart: tools/convert_vgg_weights.py (`convert_vgg19_head` :58,
`convert_vgg16_gray` :71), whose .npz this writes bit for bit: HWIO
kernels `conv{i}_w`, biases `conv{i}_b` and `arch`. Two targets:

  * `vgg19_head`: the first four convolutions of torchvision's
    vgg19.features (`features.{0,2,5,7}.weight/bias`), all that the
    NHR and NT objective uses (lib/losses/nhr_perceptual_loss.py:26-55);
  * `vgg16_gray`: the reference's 1-channel VGG16 (lib/losses/vgg.py
    cfg 'D': `conv{b}_{i}.weight` under any module prefix).

No weights are bundled or fetched.

    python -m animatable_nerf_tpu_torch.tools.convert_vgg_weights \\
        --arch vgg19_head --pth vgg19-dcbb9e9d.pth --out data/vgg19_head.npz
    python -m animatable_nerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic_nt.yaml train.vgg_weights data/vgg19_head.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..train.perceptual import VGG16_GRAY_BLOCKS, VGG19_HEAD_CONVS

# torchvision vgg19.features module indices of the four head convolutions
VGG19_HEAD_IDX = (0, 2, 5, 7)


def _state_dict(pth: str) -> dict:
    sd = torch.load(pth, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def convert_vgg19_head(pth: str) -> dict:
    sd = _state_dict(pth)
    out = {"arch": "vgg19_head"}
    for ci, mi in enumerate(VGG19_HEAD_IDX):
        w = _np(sd[f"features.{mi}.weight"])
        b = _np(sd[f"features.{mi}.bias"])
        cin, cout = VGG19_HEAD_CONVS[ci]
        assert w.shape == (cout, cin, 3, 3), (ci, w.shape)
        out[f"conv{ci}_w"] = _oihw_to_hwio(w)
        out[f"conv{ci}_b"] = b
    return out


def convert_vgg16_gray(pth: str) -> dict:
    sd = _state_dict(pth)
    # strip any module prefix down to the conv{b}_{i} names of make_layers
    clean = {}
    for k, v in sd.items():
        parts = k.split(".")
        name = parts[-2] if len(parts) >= 2 else k
        clean[f"{name}.{parts[-1]}"] = v
    out = {"arch": "vgg16_gray"}
    cin, ci = 1, 0
    for bi, widths in enumerate(VGG16_GRAY_BLOCKS):
        for wi, cout in enumerate(widths):
            w = _np(clean[f"conv{bi + 1}_{wi + 1}.weight"])
            b = _np(clean[f"conv{bi + 1}_{wi + 1}.bias"])
            assert w.shape == (cout, cin, 3, 3), (bi, wi, w.shape)
            out[f"conv{ci}_w"] = _oihw_to_hwio(w)
            out[f"conv{ci}_b"] = b
            cin = cout
            ci += 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=["vgg19_head", "vgg16_gray"],
                    required=True)
    ap.add_argument("--pth", required=True, help="torch checkpoint path")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)
    conv = (convert_vgg19_head if args.arch == "vgg19_head"
            else convert_vgg16_gray)
    out = conv(args.pth)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out)
    n = sum(v.size for k, v in out.items() if k != "arch")
    print(f"wrote {args.out} ({n / 1e6:.2f}M params, arch {out['arch']})")


if __name__ == "__main__":
    main()
