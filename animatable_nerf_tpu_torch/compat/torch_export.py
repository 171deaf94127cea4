"""Export a port model's weights as a reference-format PyTorch checkpoint.

JAX counterpart: animatable_nerf_tpu/compat/torch_export.py
(`export_state_dict` :203, `save_reference_checkpoint` :267), which
exports a flax tree; this exports a port model's state dict, whose names
are already the reference's (compat/jax_params.py), and writes what JAX
writes for the same weights. Each tensor takes the reference's own
shape: the Conv1d(k=1) layers (the blend-weight, displacement and
novel-pose trunks and their heads, AniNeRF's `tpose_human` trunk and
heads) are (out, in, 1) where the port's nn.Linear holds (out, in).

The reference modules declare tables that no forward reads: the
`resd_latent` embedding of NeRF-PDF, AlignedLBWPDF, AlignedSMPL,
SDF-PDF and NeuS-PDF, and AlignedPBW's `bw_latent` ((num_train_frame +
1, 128); the port keeps it as a buffer of zeros). Without a template
they are written as zeros, as JAX writes them (:236-262); with
`template` (the reference module's own state_dict()) its values pass
through for them, and every exported tensor is reshaped to the
template's shape.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["FAMILIES", "FAMILY_OF", "export_state_dict", "family_of",
           "save_reference_checkpoint"]

FAMILIES = ("aninerf", "nerf_pdf", "aligned_lbw", "aligned_pbw",
            "aligned_smpl", "aligned_lbw_pdf", "sdf_pdf", "neus_pdf")

# the families whose reference module declares the unread `resd_latent`
_RESD_LATENT = ("nerf_pdf", "aligned_lbw_pdf", "aligned_smpl", "sdf_pdf",
                "neus_pdf")
_PBW_LATENT = "bw_latent.weight"
_COLOR_LATENT = "tpose_human.color_network.color_latent.weight"

# the reference's Conv1d(k=1) weights
_CONV1D = re.compile(
    r"^(novel_pose_bw\.)?(bw_linears\.\d+|bw_fc|resd_linears\.\d+|resd_fc)"
    r"\.weight$"
    r"|^tpose_human\.(pts_linears\.\d+|alpha_fc|feature_fc|latent_fc|view_fc"
    r"|rgb_fc)\.weight$")


# the family of each port model class, by class name
FAMILY_OF = {"AniNeRF": "aninerf", "NeRFPDF": "nerf_pdf", "SDFPDF": "sdf_pdf",
             "NeuSPDF": "neus_pdf", "AlignedLBW": "aligned_lbw",
             "AlignedPBW": "aligned_pbw", "AlignedSMPL": "aligned_smpl",
             "AlignedLBWPDF": "aligned_lbw_pdf"}


def family_of(model) -> str:
    """The family name of a port model (JAX's EXPORTERS keys)."""
    name = type(model).__name__
    if name not in FAMILY_OF:
        raise KeyError(f"no reference export for {name}")
    return FAMILY_OF[name]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def export_state_dict(family: str, state_dict: dict, template: dict = None,
                      num_train_frame: int = None) -> dict:
    """A port model's state dict -> the reference's state dict (numpy
    values) for `family` (one of FAMILIES). `template`, `num_train_frame`:
    as JAX's (:203-264)."""
    if family not in FAMILIES:
        raise KeyError(f"unknown family {family!r}; one of {FAMILIES}")
    out = {}
    for k, v in state_dict.items():
        if family == "aligned_pbw" and k == _PBW_LATENT:
            continue  # forward-dead: written below, as JAX writes it
        v = _np(v)
        out[k] = v[:, :, None] if _CONV1D.match(k) and v.ndim == 2 else v
    if template is not None:
        tdict = {k: _np(v) for k, v in template.items()}
        for k in list(out):
            if k not in tdict:
                raise KeyError(f"exported key {k} not in the reference "
                               "module's state dict")
            want = tdict[k].shape
            if out[k].shape != want:
                assert np.prod(out[k].shape, dtype=int) == np.prod(
                    want, dtype=int), f"{k}: {out[k].shape} vs {want}"
                out[k] = out[k].reshape(want)
        for k, v in tdict.items():
            out.setdefault(k, v)
    elif family in _RESD_LATENT + ("aligned_pbw",):
        rows = out[_COLOR_LATENT].shape[0]
        if family in _RESD_LATENT:
            out.setdefault("resd_latent.weight",
                           np.zeros((rows, 128), np.float32))
        else:
            n = rows if num_train_frame is None else num_train_frame
            out.setdefault(_PBW_LATENT, np.zeros((n + 1, 128), np.float32))
    return out


def save_reference_checkpoint(path: str, family: str, state_dict: dict,
                              epoch: int = 0, template: dict = None,
                              num_train_frame: int = None) -> str:
    """Write {'net': the reference's state dict, 'epoch': N} with
    torch.save, the file the reference's `load_network`
    (net_utils.py:357-396) reads; no optimizer, scheduler or recorder
    state, as JAX (:267)."""
    state = {k: torch.as_tensor(np.array(v, copy=True))
             for k, v in export_state_dict(
                 family, state_dict, template,
                 num_train_frame=num_train_frame).items()}
    torch.save({"net": state, "epoch": int(epoch)}, path)
    return path
