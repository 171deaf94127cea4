"""Import a reference PyTorch checkpoint (.pth) into a port model.

JAX counterpart: animatable_nerf_tpu/compat/torch_import.py
(`load_torch_state_dict` :37, the converters of the eight volumetric
families :90-302 and of NHR and NT :348-449). The port's modules carry
the reference's names (compat/jax_params.py), so one load serves every
family: each tensor of the `net` dict is reshaped to the port's tensor
of the same name (equal element counts asserted; the reference's
Conv1d(k=1) weights (out, in, 1) become nn.Linear weights (out, in)),
the keys that no forward reads and JAX's converters skip are dropped,
and the rest goes through `load_state_dict(strict=True)`, so a name
missing on either side raises.

The skipped keys: `resd_latent.weight` (NeRF-PDF, AlignedLBWPDF,
AlignedSMPL, SDF-PDF, NeuS-PDF), AlignedPBW's `bw_latent.weight` (the
port keeps its own table of zeros, a buffer), and, of NHR and NT, the
batch norms' `num_batches_tracked` and the antialiased downsamples'
`filt` (fixed filters that the port computes).
"""

from __future__ import annotations

import numpy as np
import torch

_SKIPPED_SUFFIXES = (".num_batches_tracked", ".filt")


def load_torch_state_dict(path):
    """A reference .pth -> (state dict of numpy arrays, epoch) (JAX :37)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["net"] if "net" in ckpt else ckpt
    out = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return out, int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0


def _skipped(key: str, buffers: set) -> bool:
    if key == "resd_latent.weight" or key.endswith(_SKIPPED_SUFFIXES):
        return True
    return key == "bw_latent.weight" and key in buffers  # AlignedPBW


def reference_state_dict(module, state: dict) -> dict:
    """The reference state dict `state` (name: array or tensor) in the
    shapes of `module`'s own tensors, without the skipped keys, with the
    module's own value of each skipped table it holds: what
    `load_state_dict(strict=True)` takes."""
    own = module.state_dict()
    buffers = {k for k, _ in module.named_buffers()}
    out = {}
    for k, v in state.items():
        if _skipped(k, buffers):
            continue
        v = torch.as_tensor(np.asarray(v))
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            assert v.numel() == own[k].numel(), \
                f"{k}: {tuple(v.shape)} vs {tuple(own[k].shape)}"
            v = v.reshape(own[k].shape)
        out[k] = v
    for k in own:
        if k not in out and _skipped(k, buffers):
            out[k] = own[k]
    return out


def load_reference_state_dict(module, state: dict):
    """Load a reference state dict into any port module (the eight
    volumetric families, NHR, NT), strictly."""
    module.load_state_dict(reference_state_dict(module, state), strict=True)
