"""The JAX package's parameters as the port's state dicts.

The JAX param tree (nested dict of numpy arrays, as flax checkpoints
hold it) maps onto the reference's PyTorch names, the ones
animatable_nerf_tpu/compat/torch_export.py writes:
  * AniNeRF (:90-109): `bw_latent`, `bw_linears.{i}`, `bw_fc`,
    `tpose_human.pts_linears.{i}`,
    `tpose_human.{alpha,feature,latent,view,rgb}_fc` and
    `tpose_human.nf_latent`, and with a stage-2 field (:107-108;
    torch_import.py:126-127) `novel_pose_bw.{bw_latent,bw_linears.{i},
    bw_fc}`;
  * the displacement-field families: `resd_linears.{i}`, `resd_fc`,
    `tpose_human.color_network.color_latent`,
    `tpose_human.color_network.lin{l}`, and NeRF-PDF's (:112
    `export_nerf_pdf`) `tpose_human.nerf_network.lin{l}`, SDF-PDF's
    (:166 `export_sdf_pdf`) `tpose_human.sdf_network.lin{l}` and
    `tpose_human.beta_network.beta`, NeuS-PDF's (:177
    `export_neus_pdf`) `tpose_human.sdf_network.lin{l}` and
    `tpose_human.variance_network.variance`;
  * the aligned families (:122-163 `export_aligned_*`): the blend-weight
    field as AniNeRF's (PBW's without a latent it reads), NeRF-PDF's
    head, LBWPDF's displacement field, and with a stage-2 field
    (LBW, LBWPDF) `novel_pose_bw.*` as AniNeRF's;
  * the baselines (JAX compat/torch_import.py :348-449, the names the
    reference's NHR and NT checkpoints carry): NHR's `pointnet.*`,
    `render.unet.*` and `pcpr_parameters.default_features`, NT's
    `texture.layer{i}` and `unet.*`;
  * the losses (JAX train/perceptual.py): a VGG head's HWIO `conv{i}_w`
    become OIHW (`vgg_state_dict`), and `NLayerDiscriminator`'s flax
    `conv{i}` {kernel, bias} the Conv2d's `conv{i}.weight`, `.bias`
    (`discriminator_state_dict`).
Dense kernels (in, out) become nn.Linear weights (out, in); a
weight-normalized {v (in, out), g (out,), b} becomes `weight_v` (out,
in), `weight_g` (out, 1), `bias`. Load the result with
`load_state_dict(strict=True)`.

The `*_param_tree` functions are the inverses: a port state dict (or
any dict of tensors under its names, such as Adam's moments) to the JAX
param tree, which JAX's `load_checkpoint` restores.
"""

from __future__ import annotations

import numpy as np
import torch

_HEADS = ("alpha_fc", "feature_fc", "latent_fc", "view_fc", "rgb_fc")


def _linear(p: dict, name: str, out: dict):
    out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = np.asarray(p["bias"])


def bw_field_state_dict(p: dict, prefix: str = "") -> dict:
    """A JAX BlendWeightField's params ({latent, mlp}) -> numpy arrays
    under `bw_latent`, `bw_linears.{i}`, `bw_fc`."""
    out = {f"{prefix}bw_latent.weight": np.asarray(p["latent"]["embedding"])}
    mlp = p["mlp"]
    for i in range(8):
        _linear(mlp[f"lin{i}"], f"{prefix}bw_linears.{i}", out)
    _linear(mlp["out"], f"{prefix}bw_fc", out)
    return out


def tpose_nerf_state_dict(p: dict, prefix: str = "") -> dict:
    """A JAX TPoseNeRF's params -> numpy arrays under `pts_linears.{i}`,
    the five heads and `nf_latent`."""
    out = {}
    for i in range(8):
        _linear(p[f"lin{i}"], f"{prefix}pts_linears.{i}", out)
    for head in _HEADS:
        _linear(p[head], f"{prefix}{head}", out)
    out[f"{prefix}nf_latent.weight"] = np.asarray(p["nf_latent"]["embedding"])
    return out


def _wn(p: dict, name: str, out: dict):
    out[f"{name}.weight_v"] = np.ascontiguousarray(np.asarray(p["v"]).T)
    out[f"{name}.weight_g"] = np.asarray(p["g"]).reshape(-1, 1)
    out[f"{name}.bias"] = np.asarray(p["b"])


def _as_list(layers):
    """A flax list param, or the {"0": ..., "1": ...} dict a msgpack
    checkpoint stores it as."""
    if isinstance(layers, dict):
        return [layers[str(i)] for i in range(len(layers))]
    return list(layers)


def to_tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}


def aninerf_state_dict(params: dict) -> dict:
    """JAX AniNeRF params ({"params": {...}} or the inner dict) ->
    {reference name: torch.Tensor}."""
    p = params["params"] if "params" in params else params
    out = bw_field_state_dict(p["bw_field"])
    out.update(tpose_nerf_state_dict(p["tpose_human"], "tpose_human."))
    if "novel_pose_bw" in p:
        out.update(bw_field_state_dict(p["novel_pose_bw"], "novel_pose_bw."))
    return to_tensors(out)


def _wn_layers_arrays(p: dict, net: str) -> dict:
    """A JAX GeometricFieldNetwork's params ({layers}) -> numpy arrays
    under `tpose_human.<net>.lin{l}`."""
    out = {}
    for l, wn in enumerate(_as_list(p["layers"])):
        _wn(wn, f"tpose_human.{net}.lin{l}", out)
    return out


def sdf_network_state_dict(params: dict) -> dict:
    """The SDF network alone ({"params": {...}} or the inner dict), as
    JAX's `init_sdf` reads it into an SDFPDF (engine.py:1237-1241): the
    other subtrees may be missing; {} when `sdf_network` is."""
    p = params["params"] if "params" in params else params
    sdf = p.get("sdf_network")
    return to_tensors(_wn_layers_arrays(sdf, "sdf_network")) if sdf else {}


def _mlp_arrays(mlp: dict, linears: str, fc: str) -> dict:
    """A JAX SkipMLP's params (lin0..lin7, out) -> numpy arrays under
    `<linears>.{i}` and `<fc>`."""
    out = {}
    for i in range(8):
        _linear(mlp[f"lin{i}"], f"{linears}.{i}", out)
    _linear(mlp["out"], fc, out)
    return out


def _head_arrays(p: dict, net: str) -> dict:
    """The canonical GeometricFieldNetwork `net` and the color network."""
    out = _wn_layers_arrays(p[net], net)
    color = p["color_network"]
    th = "tpose_human.color_network."
    out[f"{th}color_latent.weight"] = np.asarray(
        color["color_latent"]["embedding"])
    for l in range(5):
        _wn(color[f"lin{l}"]["wn"], f"{th}lin{l}", out)
    return out


def _pdf_arrays(p: dict, net: str) -> dict:
    """The parts every displacement-field family has: the displacement
    field, its canonical GeometricFieldNetwork `net` and the color
    network."""
    out = _mlp_arrays(p["resd_field"]["mlp"], "resd_linears", "resd_fc")
    out.update(_head_arrays(p, net))
    return out


def nerf_pdf_state_dict(params: dict) -> dict:
    """JAX NeRFPDF params ({"params": {...}} or the inner dict) ->
    {reference name: torch.Tensor}."""
    p = params["params"] if "params" in params else params
    return to_tensors(_pdf_arrays(p, "nerf_network"))


def sdf_pdf_state_dict(params: dict) -> dict:
    """JAX SDFPDF params ({"params": {...}} or the inner dict) ->
    {reference name: torch.Tensor}."""
    p = params["params"] if "params" in params else params
    out = _pdf_arrays(p, "sdf_network")
    out["tpose_human.beta_network.beta"] = np.asarray(
        p["beta_network"]["beta"]).reshape(())
    return to_tensors(out)


def neus_pdf_state_dict(params: dict) -> dict:
    """JAX NeuSPDF params ({"params": {...}} or the inner dict) ->
    {reference name: torch.Tensor}."""
    p = params["params"] if "params" in params else params
    out = _pdf_arrays(p, "sdf_network")
    out["tpose_human.variance_network.variance"] = np.asarray(
        p["variance_network"]["variance"]).reshape(())
    return to_tensors(out)


def _kernel(named: dict, name: str) -> dict:
    return {"bias": _numpy(named[f"{name}.bias"]),
            "kernel": np.ascontiguousarray(_numpy(named[f"{name}.weight"]).T)}


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _checked(tree: dict, named: dict, state_dict, family: str) -> dict:
    """`tree`, once its state dict is as long as `named`: every name
    must be used, and a stray one raises."""
    if len(state_dict(tree)) != len(named):
        raise KeyError(f"{family}_param_tree: names that {family} does "
                       "not have")
    return tree


def _bw_field_tree(named: dict, prefix: str = "") -> dict:
    """The inverse of `bw_field_state_dict`: {latent, mlp}."""
    bw = {"latent": {"embedding": _numpy(named[f"{prefix}bw_latent.weight"])},
          "mlp": {f"lin{i}": _kernel(named, f"{prefix}bw_linears.{i}")
                  for i in range(8)}}
    bw["mlp"]["out"] = _kernel(named, f"{prefix}bw_fc")
    return bw


def aninerf_param_tree(named: dict) -> dict:
    """{reference name: tensor} of AniNeRF -> the JAX param tree
    {"params": {"bw_field": ..., "tpose_human": ...}} of numpy float32
    arrays, with "novel_pose_bw" where the names hold it (the inverse of
    `aninerf_state_dict`). Every name must be used: a stray one
    raises."""
    th = {f"lin{i}": _kernel(named, f"tpose_human.pts_linears.{i}")
          for i in range(8)}
    for head in _HEADS:
        th[head] = _kernel(named, f"tpose_human.{head}")
    th["nf_latent"] = {"embedding": _numpy(named["tpose_human.nf_latent.weight"])}
    tree = {"bw_field": _bw_field_tree(named), "tpose_human": th}
    if any(k.startswith("novel_pose_bw.") for k in named):
        tree["novel_pose_bw"] = _bw_field_tree(named, "novel_pose_bw.")
    return _checked({"params": tree}, named, aninerf_state_dict, "aninerf")


def _wn_tree(named: dict, name: str) -> dict:
    return {"b": _numpy(named[f"{name}.bias"]),
            "g": _numpy(named[f"{name}.weight_g"]).reshape(-1),
            "v": np.ascontiguousarray(_numpy(named[f"{name}.weight_v"]).T)}


def _mlp_tree(named: dict, linears: str, fc: str) -> dict:
    """The inverse of `_mlp_arrays`: {lin0..lin7, out}."""
    mlp = {f"lin{i}": _kernel(named, f"{linears}.{i}") for i in range(8)}
    mlp["out"] = _kernel(named, fc)
    return mlp


def _head_tree(named: dict, net: str) -> dict:
    """The inverse of `_head_arrays`: {net, "color_network"}. The
    GeometricFieldNetwork's layer list is written as flax writes a list,
    a dict keyed "0", "1", ..."""
    th = "tpose_human."
    n_layers = sum(1 for k in named
                   if k.startswith(f"{th}{net}.lin") and k.endswith(".bias"))
    color = {f"lin{l}": {"wn": _wn_tree(named, f"{th}color_network.lin{l}")}
             for l in range(5)}
    color["color_latent"] = {"embedding": _numpy(
        named[f"{th}color_network.color_latent.weight"])}
    return {
        net: {"layers": {str(l): _wn_tree(named, f"{th}{net}.lin{l}")
                         for l in range(n_layers)}},
        "color_network": color,
    }


def _pdf_tree(named: dict, net: str) -> dict:
    """The inverse of `_pdf_arrays`: {"resd_field", net,
    "color_network"}."""
    return {"resd_field": {"mlp": _mlp_tree(named, "resd_linears", "resd_fc")},
            **_head_tree(named, net)}


def nerf_pdf_param_tree(named: dict) -> dict:
    """{reference name: tensor} of NeRF-PDF -> the JAX param tree
    {"params": {"resd_field", "nerf_network", "color_network"}} of numpy
    float32 arrays (the inverse of `nerf_pdf_state_dict`)."""
    tree = {"params": _pdf_tree(named, "nerf_network")}
    return _checked(tree, named, nerf_pdf_state_dict, "nerf_pdf")


def sdf_pdf_param_tree(named: dict) -> dict:
    """{reference name: tensor} of SDF-PDF -> the JAX param tree
    {"params": {"resd_field", "sdf_network", "beta_network",
    "color_network"}} of numpy float32 arrays (the inverse of
    `sdf_pdf_state_dict`)."""
    tree = {"params": _pdf_tree(named, "sdf_network")}
    tree["params"]["beta_network"] = {
        "beta": _numpy(named["tpose_human.beta_network.beta"])}
    return _checked(tree, named, sdf_pdf_state_dict, "sdf_pdf")


def neus_pdf_param_tree(named: dict) -> dict:
    """{reference name: tensor} of NeuS-PDF -> the JAX param tree
    {"params": {"resd_field", "sdf_network", "variance_network",
    "color_network"}} of numpy float32 arrays (the inverse of
    `neus_pdf_state_dict`)."""
    tree = {"params": _pdf_tree(named, "sdf_network")}
    tree["params"]["variance_network"] = {
        "variance": _numpy(named["tpose_human.variance_network.variance"])}
    return _checked(tree, named, neus_pdf_state_dict, "neus_pdf")


# ------------------------------------------------------ aligned families
# (animatable_nerf_tpu/compat/torch_export.py:122-163): the blend-weight
# field at the top level, NeRF-PDF's head under `tpose_human.`, LBWPDF's
# displacement field as the PDF families'

# the reference PBW module's frame-latent table, which its forward never
# reads (torch_export.py:250-262); the port keeps it as a buffer of zeros
_PBW_UNREAD = "bw_latent.weight"


def _aligned_arrays(p: dict) -> dict:
    out = _head_arrays(p, "nerf_network")
    if "bw_field" in p:
        bw = p["bw_field"]
        if "latent" in bw:
            out.update(bw_field_state_dict(bw))
        else:  # PBW: the frame-latent table has one row a frame and one
            out.update(_mlp_arrays(bw["mlp"], "bw_linears", "bw_fc"))
            rows = out["tpose_human.color_network.color_latent.weight"].shape[0]
            out[_PBW_UNREAD] = np.zeros((rows + 1, 128), np.float32)
    if "resd_field" in p:
        out.update(_mlp_arrays(p["resd_field"]["mlp"], "resd_linears",
                               "resd_fc"))
    if "novel_pose_bw" in p:
        out.update(bw_field_state_dict(p["novel_pose_bw"], "novel_pose_bw."))
    return out


def aligned_state_dict(params: dict) -> dict:
    """JAX AlignedLBW, AlignedPBW, AlignedSMPL or AlignedLBWPDF params
    ({"params": {...}} or the inner dict) -> {reference name:
    torch.Tensor}: `tpose_human.nerf_network.lin{l}`,
    `tpose_human.color_network.*`, and as the tree holds them the
    blend-weight field (`bw_latent`, `bw_linears.{i}`, `bw_fc`; PBW's
    `bw_latent` zeros of num_train_frame + 1 rows), the displacement
    field (`resd_linears.{i}`, `resd_fc`) and LBW's and LBWPDF's
    novel-pose field (`novel_pose_bw.{bw_latent,bw_linears.{i},bw_fc}`,
    torch_export.py:129-130, :161-162)."""
    p = params["params"] if "params" in params else params
    return to_tensors(_aligned_arrays(p))


def _aligned_tree(named: dict, bw: str | None, resd: bool) -> dict:
    """The inverse of `aligned_state_dict` for a family whose
    blend-weight field is `bw` ("latent", "pose" or None) and that has a
    displacement field or not; a "latent" family's `novel_pose_bw`
    where the names hold it. PBW's unread `bw_latent` may be among the
    names or not. Every other name must be used: a stray one raises."""
    if bw == "pose":
        named = {k: v for k, v in named.items() if k != _PBW_UNREAD}
    tree = _head_tree(named, "nerf_network")
    if bw == "latent":
        tree["bw_field"] = _bw_field_tree(named)
    elif bw == "pose":
        tree["bw_field"] = {"mlp": _mlp_tree(named, "bw_linears", "bw_fc")}
    if resd:
        tree["resd_field"] = {"mlp": _mlp_tree(named, "resd_linears",
                                               "resd_fc")}
    if bw == "latent" and any(k.startswith("novel_pose_bw.") for k in named):
        tree["novel_pose_bw"] = _bw_field_tree(named, "novel_pose_bw.")
    tree = {"params": tree}
    written = aligned_state_dict(tree)
    if len(written) - (bw == "pose") != len(named):
        raise KeyError("aligned_param_tree: names that the aligned family "
                       "does not have")
    return tree


def aligned_lbw_param_tree(named: dict) -> dict:
    """{reference name: tensor} of AlignedLBW -> the JAX param tree
    {"params": {"bw_field", "nerf_network", "color_network"}}, with
    "novel_pose_bw" where the names hold it."""
    return _aligned_tree(named, "latent", False)


def aligned_pbw_param_tree(named: dict) -> dict:
    """{reference name: tensor} of AlignedPBW -> the JAX param tree
    {"params": {"bw_field": {"mlp"}, "nerf_network", "color_network"}}."""
    return _aligned_tree(named, "pose", False)


def aligned_smpl_param_tree(named: dict) -> dict:
    """{reference name: tensor} of AlignedSMPL -> the JAX param tree
    {"params": {"nerf_network", "color_network"}}."""
    return _aligned_tree(named, None, False)


def aligned_lbw_pdf_param_tree(named: dict) -> dict:
    """{reference name: tensor} of AlignedLBWPDF -> the JAX param tree
    {"params": {"bw_field", "resd_field", "nerf_network",
    "color_network"}}, with "novel_pose_bw" where the names hold it."""
    return _aligned_tree(named, "latent", True)


# ------------------------------------------------------------- baselines
# (animatable_nerf_tpu/compat/torch_import.py `convert_nhr_unet` :348,
# `convert_nt` :375, `convert_pointnet2` :405, `convert_nhr` :428): a
# flax Conv kernel (kh, kw, in, out) is a Conv2d weight (out, in, kh, kw);
# a TorchBatchNorm {scale, bias, mean, var} is {weight, bias,
# running_mean, running_var}; PointNet++'s Dense kernels (in, out) are
# 1x1 Conv2d weights (out, in, 1, 1) without bias.

_BN_NAMES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
             ("var", "running_var"))


def _bn_arrays(p: dict, name: str, out: dict):
    for flax, ref in _BN_NAMES:
        out[f"{name}.{ref}"] = np.asarray(p[flax])


def _conv_arrays(p: dict, name: str, out: dict):
    out[f"{name}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _double_conv_arrays(p: dict, name: str, out: dict):
    """DoubleConv {gc0, bn0, gc1, bn1} -> the Sequential's slots 0, 1,
    3, 4 under `name`."""
    for i, slot in ((0, 0), (1, 3)):
        _conv_arrays(p[f"gc{i}"]["conv"], f"{name}.{slot}.conv2", out)
        _conv_arrays(p[f"gc{i}"]["gate"], f"{name}.{slot}.conv2_gate", out)
        _bn_arrays(p[f"bn{i}"], f"{name}.{slot + 1}", out)


def unet_arrays(p: dict, prefix: str) -> dict:
    """A JAX UNet's params -> numpy arrays under the reference's names
    (`<prefix>inc.conv.conv.*`, `down{k}.mpconv.2.conv.*`,
    `up{k}.conv.conv.*`, `outc.conv`, `outc.conv2`)."""
    out = {}
    _double_conv_arrays(p["inc"], f"{prefix}inc.conv.conv", out)
    for k in range(1, 5):
        _double_conv_arrays(p[f"down{k}"]["conv"],
                            f"{prefix}down{k}.mpconv.2.conv", out)
        _double_conv_arrays(p[f"up{k}"]["conv"], f"{prefix}up{k}.conv.conv", out)
    _conv_arrays(p["outc"], f"{prefix}outc.conv", out)
    _conv_arrays(p["outc2"], f"{prefix}outc.conv2", out)
    return out


def _point_mlp_arrays(p: dict, name: str, out: dict):
    """_PointMLP {lin{i}, bn{i}} -> `name.layer{i}.conv.weight` and
    `name.layer{i}.bn.bn.*`."""
    i = 0
    while f"lin{i}" in p:
        w = np.asarray(p[f"lin{i}"]["kernel"]).T
        out[f"{name}.layer{i}.conv.weight"] = np.ascontiguousarray(
            w[:, :, None, None])
        _bn_arrays(p[f"bn{i}"], f"{name}.layer{i}.bn.bn", out)
        i += 1


def pointnet2_arrays(p: dict, prefix: str) -> dict:
    """A JAX PointNet2MSG's params ({sa{k}: {scale{s}}, fp{k}: {mlp}})
    -> numpy arrays under `<prefix>SA_modules.{k}.mlps.{s}.` and
    `<prefix>FP_modules.{k}.mlp.`."""
    out = {}
    k = 0
    while f"sa{k}" in p:
        s = 0
        while f"scale{s}" in p[f"sa{k}"]:
            _point_mlp_arrays(p[f"sa{k}"][f"scale{s}"],
                              f"{prefix}SA_modules.{k}.mlps.{s}", out)
            s += 1
        _point_mlp_arrays(p[f"fp{k}"]["mlp"], f"{prefix}FP_modules.{k}.mlp", out)
        k += 1
    return out


def nhr_state_dict(params: dict) -> dict:
    """JAX NHR params ({"params": {...}} or the inner dict) -> {reference
    name: torch.Tensor}: `pointnet.*`, `render.unet.*` and
    `pcpr_parameters.default_features` (fdim, 1)."""
    p = params["params"] if "params" in params else params
    out = pointnet2_arrays(p["pointnet"], "pointnet.")
    out.update(unet_arrays(p["unet"], "render.unet."))
    out["pcpr_parameters.default_features"] = np.asarray(
        p["default_features"]).reshape(-1, 1)
    return to_tensors(out)


def nt_state_dict(params: dict) -> dict:
    """JAX NT params -> {reference name: torch.Tensor}: `texture.layer{i}`
    (1, C, A, B) from the flax (A, B, C) level, and `unet.*`."""
    p = params["params"] if "params" in params else params
    out = {f"texture.layer{i}": np.ascontiguousarray(np.transpose(
        np.asarray(p["texture"][f"layer{i}"]), (2, 0, 1))[None])
        for i in range(1, 5)}
    out.update(unet_arrays(p["unet"], "unet."))
    return to_tensors(out)


def _bn_tree(named: dict, name: str) -> dict:
    return {flax: _numpy(named[f"{name}.{ref}"]) for flax, ref in _BN_NAMES}


def _conv_tree(named: dict, name: str) -> dict:
    return {"bias": _numpy(named[f"{name}.bias"]),
            "kernel": np.ascontiguousarray(np.transpose(
                _numpy(named[f"{name}.weight"]), (2, 3, 1, 0)))}


def _double_conv_tree(named: dict, name: str) -> dict:
    out = {}
    for i, slot in ((0, 0), (1, 3)):
        out[f"gc{i}"] = {"conv": _conv_tree(named, f"{name}.{slot}.conv2"),
                         "gate": _conv_tree(named, f"{name}.{slot}.conv2_gate")}
        out[f"bn{i}"] = _bn_tree(named, f"{name}.{slot + 1}")
    return out


def unet_tree(named: dict, prefix: str) -> dict:
    """The inverse of `unet_arrays`."""
    out = {"inc": _double_conv_tree(named, f"{prefix}inc.conv.conv")}
    for k in range(1, 5):
        out[f"down{k}"] = {"conv": _double_conv_tree(
            named, f"{prefix}down{k}.mpconv.2.conv")}
        out[f"up{k}"] = {"conv": _double_conv_tree(
            named, f"{prefix}up{k}.conv.conv")}
    out["outc"] = _conv_tree(named, f"{prefix}outc.conv")
    out["outc2"] = _conv_tree(named, f"{prefix}outc.conv2")
    return out


def _point_mlp_tree(named: dict, name: str) -> dict:
    out, i = {}, 0
    while f"{name}.layer{i}.conv.weight" in named:
        w = _numpy(named[f"{name}.layer{i}.conv.weight"])
        out[f"lin{i}"] = {"kernel": np.ascontiguousarray(w[:, :, 0, 0].T)}
        out[f"bn{i}"] = _bn_tree(named, f"{name}.layer{i}.bn.bn")
        i += 1
    return out


def pointnet2_tree(named: dict, prefix: str) -> dict:
    """The inverse of `pointnet2_arrays`."""
    out, k = {}, 0
    while f"{prefix}FP_modules.{k}.mlp.layer0.conv.weight" in named:
        sa, s = {}, 0
        while f"{prefix}SA_modules.{k}.mlps.{s}.layer0.conv.weight" in named:
            sa[f"scale{s}"] = _point_mlp_tree(
                named, f"{prefix}SA_modules.{k}.mlps.{s}")
            s += 1
        out[f"sa{k}"] = sa
        out[f"fp{k}"] = {"mlp": _point_mlp_tree(named,
                                                f"{prefix}FP_modules.{k}.mlp")}
        k += 1
    return out


def nhr_param_tree(named: dict) -> dict:
    """{reference name: tensor} of NHR -> the JAX param tree {"params":
    {"pointnet", "unet", "default_features"}} of numpy float32 arrays
    (the inverse of `nhr_state_dict`). Every name must be used."""
    tree = {"params": {
        "pointnet": pointnet2_tree(named, "pointnet."),
        "unet": unet_tree(named, "render.unet."),
        "default_features": _numpy(
            named["pcpr_parameters.default_features"]).reshape(-1)}}
    return _checked(tree, named, nhr_state_dict, "nhr")


def nt_param_tree(named: dict) -> dict:
    """{reference name: tensor} of NT -> the JAX param tree {"params":
    {"texture", "unet"}} (the inverse of `nt_state_dict`)."""
    tree = {"params": {
        "texture": {f"layer{i}": np.ascontiguousarray(np.transpose(
            _numpy(named[f"texture.layer{i}"])[0], (1, 2, 0)))
            for i in range(1, 5)},
        "unet": unet_tree(named, "unet.")}}
    # counted without transposing the 22M texels back
    if len(unet_arrays(tree["params"]["unet"], "unet.")) + 4 != len(named):
        raise KeyError("nt_param_tree: names that nt does not have")
    return tree


# ---------------------------------------------------------------- losses
# (animatable_nerf_tpu/train/perceptual.py): the VGG heads' HWIO kernels,
# as the converted .npz holds them, and NLayerDiscriminator's flax convs


def vgg_state_dict(params: dict, device=None) -> dict:
    """A JAX VGG head's params (`conv{i}_w` HWIO, `conv{i}_b`; JAX
    `random_vgg19_head`, `load_vgg_npz`) -> OIHW float32 tensors under
    the same names, on `device`."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v, np.float32)
        if k.endswith("_w"):
            v = np.transpose(v, (3, 2, 0, 1))
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
    return out


def discriminator_state_dict(params: dict) -> dict:
    """JAX NLayerDiscriminator params ({"params": {...}} or the inner
    dict: `conv{i}` {kernel (4, 4, in, out), bias}) -> {`conv{i}.weight`
    (out, in, 4, 4), `conv{i}.bias`: torch.Tensor}."""
    p = params["params"] if "params" in params else params
    out = {}
    for name in p:
        _conv_arrays(p[name], name, out)
    return to_tensors(out)
