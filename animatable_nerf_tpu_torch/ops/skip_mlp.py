"""Fused skip-MLP (kernel K1): the whole dense stack per tile of points.

Replaces the TPU kernel animatable_nerf_tpu/ops/mlp_pallas.py:108
`fused_skip_mlp` (body `_mlp_kernel` :85, twin `_ref_forward` :39).
`skip_mlp` launches the hand-written CUDA kernel csrc/skip_mlp.cu for
CUDA tensors and takes `skip_mlp_plain` for CPU tensors; there is no
fallback from one to the other. The kernel is forward-only, as in JAX;
a gradient comes with the training slice.

The library is built with nvcc into `build/` at the checkout root at
first use (ops/build.py; plain C interface, bound with ctypes).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import build_library

_ACT_CODES = {"relu": 0, "softplus": 1, "none": 2}
_ACT_FNS = {"relu": torch.relu, "softplus": F.softplus, "none": lambda h: h}


def skip_mlp_plain(x, layers, skips=(), act: str = "relu",
                   act_last: bool = False):
    """Plain PyTorch version (the JAX `_ref_forward` loop).

    x (N, din); layers: sequence of (W (in, out), b (out,)) incl. the
    output head. The activation runs after every layer but the last
    (also the last with `act_last`); after each layer index in `skips`
    the ORIGINAL input is re-concatenated in front: [x, h]."""
    fn = _ACT_FNS[act]
    h = x
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < n - 1 or act_last:
            h = fn(h)
            if i in skips and i < n - 1:
                h = torch.cat([x, h], dim=-1)
    return h


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library("skip_mlp")))
    lib.skip_mlp_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.skip_mlp_forward.restype = ctypes.c_int
    for name in ("skip_mlp_max_layers", "skip_mlp_max_width"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(x, layers, skips):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("skip_mlp: x must be a contiguous (N, din) float32 tensor")
    lib = _library()
    if not 1 <= len(layers) <= lib.skip_mlp_max_layers():
        raise ValueError(f"skip_mlp: {len(layers)} layers is out of range")
    din = x.shape[1]
    d_in = din
    for i, (w, b) in enumerate(layers):
        for t in (w, b):
            if (t.device != x.device or t.dtype != torch.float32
                    or not t.is_contiguous()):
                raise ValueError(
                    "skip_mlp: weights must be contiguous float32 tensors "
                    "on x's device"
                )
        if w.dim() != 2 or w.shape[0] != d_in or b.shape != (w.shape[1],):
            raise ValueError(
                f"skip_mlp: layer {i} has W {tuple(w.shape)}, b "
                f"{tuple(b.shape)}; expected ({d_in}, out) and (out,)"
            )
        if w.shape[1] > lib.skip_mlp_max_width():
            raise ValueError(f"skip_mlp: layer {i} is wider than the kernel takes")
        d_in = w.shape[1] + (din if (i in skips and i < len(layers) - 1) else 0)


def skip_mlp(x, layers, skips=(), act: str = "relu", act_last: bool = False):
    """The K1 contract on `x`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise). Arguments as in
    `skip_mlp_plain`; weights are (in, out) like the JAX wrapper's."""
    if x.device.type == "cpu":
        return skip_mlp_plain(x, layers, skips, act, act_last)
    if x.device.type != "cuda":
        raise ValueError(f"skip_mlp: unsupported device {x.device}")
    skips = tuple(skips)
    _check(x, layers, skips)
    lib = _library()
    n, din = x.shape
    out = torch.empty(n, layers[-1][0].shape[1], device=x.device,
                      dtype=torch.float32)
    n_layers = len(layers)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w, _ in layers])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for _, b in layers])
    douts = (ctypes.c_int * n_layers)(*[w.shape[1] for w, _ in layers])
    skip_mask = sum(1 << i for i in skips if 0 <= i < n_layers - 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.skip_mlp_forward(
            x.data_ptr(), out.data_ptr(), n, din, n_layers, w_ptrs, b_ptrs,
            douts, skip_mask, _ACT_CODES[act], int(act_last), stream,
        )
    if rc != 0:
        raise RuntimeError(f"skip_mlp: kernel launch failed (CUDA error {rc})")
    if n > 0:
        skip_mlp.launches += 1
    return out


# launches of the CUDA kernel in this process (the CPU path never counts)
skip_mlp.launches = 0
