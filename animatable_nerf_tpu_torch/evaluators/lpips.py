"""LPIPS perceptual metric (Zhang et al., CVPR 2018) in plain PyTorch.

JAX counterpart: animatable_nerf_tpu/evaluators/lpips.py (the metric,
`SPECS` :44-61, `lpips_distance` :106, `load_lpips` :122, `random_params`
:131, `score_comparison_dir` :160-203) and tools/convert_lpips_weights.py
(`convert` :41), which imports the JAX package and so cannot run where
the port runs; its copy here is

    python -m animatable_nerf_tpu_torch.evaluators.lpips convert \\
        --arch alex --backbone alexnet-owt-7be5be79.pth \\
        --lin lpips_alex_v0.1.pth --out data/lpips_alex.npz

which writes the same .npz from the torchvision backbone's state_dict
and the LPIPS calibration weights. No weights are bundled or fetched.
Then `python -m animatable_nerf_tpu_torch.run --type lpips --cfg_file
<cfg> lpips_weights data/lpips_alex.npz` scores an evaluate's
comparison pairs.

The metric: the backbone's taps (AlexNet or VGG16 after the ReLUs
marked `tap`), each unit-normalized across channels, their squared
difference weighted per channel by the non-negative `lin` weights,
summed over channels, averaged over the pixels and summed over the
taps. JAX leaves it to XLA; here it is `torch.nn.functional.conv2d` in
FP32 (TF32 off on the card, as the port's other cuDNN paths) and max
pooling. The .npz keeps JAX's layout: HWIO kernels `conv<i>_w`, biases
`conv<i>_b`, `lin<i>` (C,) and `arch`.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from ..visualizers.image import read_png

# LPIPS ScalingLayer constants (lpips/lpips.py ScalingLayer): inputs in
# [-1, 1] are shifted and scaled into the backbone's expected statistics
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# ("conv", out_ch, kernel, stride, pad); "pool" is a 3x3/2 max pool,
# "pool2" a 2x2/2 one; taps after the ReLUs marked "tap"
_ALEX_SPEC = [
    ("conv", 64, 11, 4, 2), ("tap",), ("pool",),
    ("conv", 192, 5, 1, 2), ("tap",), ("pool",),
    ("conv", 384, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",), ("pool",),
]
# VGG16 features with LPIPS taps at relu1_2/2_2/3_3/4_3/5_3
_VGG_SPEC = [
    ("conv", 64, 3, 1, 1), ("conv", 64, 3, 1, 1), ("tap",), ("pool2",),
    ("conv", 128, 3, 1, 1), ("conv", 128, 3, 1, 1), ("tap",), ("pool2",),
    ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1),
    ("tap",), ("pool2",),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",), ("pool2",),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",), ("pool2",),
]
SPECS = {"alex": _ALEX_SPEC, "vgg": _VGG_SPEC}

# torchvision `features.<idx>` module indices of the conv layers
BACKBONE_CONV_IDX = {
    "alex": [0, 3, 6, 8, 10],
    "vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
}


def backbone_taps(params, x, arch: str):
    """The 5 post-ReLU tap activations (N, C, h, w) of the backbone on
    x (N, H, W, 3) in [-1, 1]."""
    shift = x.new_tensor(_SHIFT)
    scale = x.new_tensor(_SCALE)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    ci = 0
    for op in SPECS[arch]:
        if op[0] == "conv":
            _, _, _, stride, pad = op
            w = params[f"conv{ci}_w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
            x = F.relu(F.conv2d(x, w, params[f"conv{ci}_b"], stride=stride,
                                padding=pad))
            ci += 1
        elif op[0] == "tap":
            taps.append(x)
        elif op[0] == "pool":
            x = F.max_pool2d(x, 3, 2)
        else:
            x = F.max_pool2d(x, 2, 2)
    return taps


def _unit_normalize(x, eps=1e-10):
    """lpips normalize_tensor: unit L2 norm across channels per pixel."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def lpips_distance(params, img0, img1, arch: str | None = None):
    """LPIPS distance per image pair: img0, img1 (N, H, W, 3) float in
    [0, 1] (taken to LPIPS's [-1, 1]) -> (N,)."""
    arch = arch or params["arch"]
    a = backbone_taps(params, img0 * 2.0 - 1.0, arch)
    b = backbone_taps(params, img1 * 2.0 - 1.0, arch)
    total = 0.0
    for i, (fa, fb) in enumerate(zip(a, b)):
        d = (_unit_normalize(fa) - _unit_normalize(fb)) ** 2
        w = params[f"lin{i}"][None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(-2, -1))
    return total


def _to_params(arrays: dict, arch: str, device) -> dict:
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
              for k, v in arrays.items() if k != "arch"}
    params["arch"] = arch
    return params


def load_lpips(path: str, device="cpu") -> dict:
    """A converted .npz as the params `lpips_distance` takes: float32
    tensors on `device` and the `arch` string."""
    with np.load(path) as z:
        return _to_params({k: z[k] for k in z.files}, str(z["arch"]), device)


def random_params(arch: str, seed: int = 0, device="cpu") -> dict:
    """Seeded weights in the production structure, the same numbers as
    JAX's `random_params` (for tests and the card's check: perceptual
    scores need the converted real weights)."""
    r = np.random.RandomState(seed)
    arrays = {}
    in_ch, ci, taps = 3, 0, 0
    for op in SPECS[arch]:
        if op[0] == "conv":
            _, out_ch, k, _, _ = op
            arrays[f"conv{ci}_w"] = (r.randn(k, k, in_ch, out_ch).astype(
                np.float32) * np.sqrt(2.0 / (k * k * in_ch)))
            arrays[f"conv{ci}_b"] = r.randn(out_ch).astype(np.float32) * 0.01
            in_ch = out_ch
            ci += 1
        elif op[0] == "tap":
            arrays[f"lin{taps}"] = r.rand(in_ch).astype(np.float32) * 0.1
            taps += 1
    return _to_params(arrays, arch, device)


_PAIR_RE = re.compile(r"^(frame\d+_view\d+)\.png$")


def score_comparison_dir(result_dir: str, weights_path: str, batch: int = 8,
                         device="cpu") -> dict:
    """Score every pred/gt PNG pair the image evaluator wrote under
    <result_dir>/comparison (frameXXXX_viewXXXX.png and its _gt.png), in
    name order, in batches of `batch` on `device`; write `lpips.npy`
    beside metrics.npy ({"names", "lpips", "mean"}, as JAX's) and return
    it. `weights_path` is a converted .npz (`load_lpips`)."""
    comp = os.path.join(result_dir, "comparison")
    if not os.path.isdir(comp):
        raise FileNotFoundError(
            f"{comp} not found — run `--type evaluate` first to dump "
            "pred/gt comparison pairs")
    names, preds, gts = [], [], []
    for f in sorted(os.listdir(comp)):
        m = _PAIR_RE.match(f)
        if not m:
            continue
        gt_path = os.path.join(comp, m.group(1) + "_gt.png")
        if not os.path.exists(gt_path):
            continue
        names.append(m.group(1))
        preds.append(read_png(os.path.join(comp, f)).astype(np.float32) / 255.0)
        gts.append(read_png(gt_path).astype(np.float32) / 255.0)
    if not names:
        raise FileNotFoundError(f"no frame*_view*.png pairs under {comp}")

    params = load_lpips(weights_path, device)
    arch = params["arch"]
    scores = []
    with torch.no_grad():
        for i in range(0, len(names), batch):
            a = torch.as_tensor(np.stack(preds[i:i + batch]), device=device)
            b = torch.as_tensor(np.stack(gts[i:i + batch]), device=device)
            scores.extend(lpips_distance(params, a, b, arch).cpu().tolist())
    out = {"names": names, "lpips": scores, "mean": float(np.mean(scores))}
    np.save(os.path.join(result_dir, "lpips.npy"), out)
    print(f"the results are saved at {result_dir}")
    print(f"lpips ({arch}): {out['mean']}")
    return out


def convert(arch: str, backbone_pth: str, lin_pth: str) -> dict:
    """The .npz arrays of JAX's tools/convert_lpips_weights.py `convert`:
    the backbone's conv kernels (OIHW -> HWIO) and biases from a
    torchvision state_dict (`features.<i>.weight/bias`), and the `lin`
    calibration weights (lin<i>.model.1.weight, lins.<i>.weight or
    lin<i>.weight; (1, C, 1, 1) -> (C,), clipped at 0)."""
    out = {"arch": arch}
    bb = torch.load(backbone_pth, map_location="cpu", weights_only=True)
    if hasattr(bb, "state_dict"):
        bb = bb.state_dict()
    for ci, mi in enumerate(BACKBONE_CONV_IDX[arch]):
        w = bb[f"features.{mi}.weight"].numpy()
        out[f"conv{ci}_w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
        out[f"conv{ci}_b"] = bb[f"features.{mi}.bias"].numpy().astype(np.float32)
    lin = torch.load(lin_pth, map_location="cpu", weights_only=True)
    if hasattr(lin, "state_dict"):
        lin = lin.state_dict()
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.weight",
                    f"lin{i}.weight"):
            if key in lin:
                w = lin[key].numpy().reshape(-1)
                break
        else:
            raise KeyError(f"no lin{i} weight found in {lin_pth}: {sorted(lin)}")
        out[f"lin{i}"] = np.maximum(w, 0.0).astype(np.float32)
    n_convs = sum(1 for op in SPECS[arch] if op[0] == "conv")
    if n_convs != len(BACKBONE_CONV_IDX[arch]):
        raise AssertionError(f"{arch}: {n_convs} convs in SPECS")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m animatable_nerf_tpu_torch.evaluators.lpips",
        description="Convert torch LPIPS weights to the .npz that "
        "`--type lpips` reads.")
    sub = ap.add_subparsers(dest="command", required=True)
    conv = sub.add_parser("convert")
    conv.add_argument("--arch", choices=("alex", "vgg"), default="alex")
    conv.add_argument("--backbone", required=True,
                      help="torchvision backbone state_dict .pth")
    conv.add_argument("--lin", required=True,
                      help="LPIPS linear calibration .pth (weights/v0.1/*)")
    conv.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)
    params = convert(args.arch, args.backbone, args.lin)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **params)
    n = sum(v.size for k, v in params.items() if k != "arch")
    print(f"wrote {args.out}: arch={args.arch}, {n/1e6:.1f}M params")
    return args.out


if __name__ == "__main__":
    main()
