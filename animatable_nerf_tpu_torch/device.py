"""Device choice and float32 precision for the port's entry points.

JAX counterpart: animatable_nerf_tpu/jaxenv.py (platform selection). The
JAX CPU oracle computes every float32 product in full float32, so the
port turns TF32 off for both cuBLAS and cuDNN before it runs anything.
"""

from __future__ import annotations

import torch


def select_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless `device` says
    otherwise. Raises when CUDA is asked for (explicitly or by default)
    and no GPU is present; never falls back to the CPU on its own.

    Also pins float32 matmuls and convolutions to full float32 (TF32
    off), the precision the JAX reference computes in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
