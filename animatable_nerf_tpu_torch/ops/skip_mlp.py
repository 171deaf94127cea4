"""Fused skip-MLP (kernel K1): the whole dense stack per tile of points.

Replaces the TPU kernel animatable_nerf_tpu/ops/mlp_pallas.py:108
`fused_skip_mlp` (body `_mlp_kernel` :85, twin `_ref_forward` :39).
`skip_mlp` launches the hand-written CUDA kernel csrc/skip_mlp.cu for
CUDA tensors and takes `skip_mlp_plain` for CPU tensors; there is no
fallback from one to the other. The kernel is forward-only, as in JAX:
where a gradient is wanted, `skip_mlp` goes through `SkipMLPFunction`,
whose forward is that same call and whose backward is the vjp of
`skip_mlp_plain` recomputed from the saved input and weights, itself
differentiable for a gradient of a gradient (JAX `make_fused_skip_mlp`,
mlp_pallas.py:173-197, differentiates its XLA twin `_ref_forward` the
same way).

The kernel multiplies on the tensor cores in 3xTF32 (each operand split
into a TF32 `hi` and the TF32 rounding of its remainder `lo`; the
products lo*hi, hi*lo and hi*hi accumulated in float32), which keeps
float32 accuracy. It reads its weights in the layout `pack_layers`
makes: padded, K-major and cut into chunks of PACK_K input features.
Callers that own the weights pack them once per weight version
(fields/mlp.py); a call with bare `layers` packs them on every call.

Under `compute_dtype bfloat16` the trunks come in as bf16 and take
K1's bf16 form (the second kernel of csrc/skip_mlp.cu): bf16 operands
read by wgmma from shared memory, a float32 accumulator, rounded where
`skip_mlp_plain` rounds in bf16 (see there). Its weights come in the
bf16 layout of `pack_layers`: inputs padded to PACK_K_BF16, chunks of
BF16_CHUNK_K input features swizzled as the tensor cores read them. The wrapper picks the form by
x's dtype and counts its launches apart (`skip_mlp.launches_bf16`); it
never takes the float32 kernel or the plain version for a bf16 input on
the card.

The library is built with nvcc into `build/` at the checkout root at
first use (ops/build.py; plain C interface, bound with ctypes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import build_library

_ACT_CODES = {"relu": 0, "softplus": 1, "none": 2}
_ACT_FNS = {"relu": torch.relu, "softplus": F.softplus, "none": lambda h: h}

# Input features per weight chunk, and the step every width is padded
# to (csrc/skip_mlp.cu kChunkK; the library reports it)
PACK_K = 16
# the bf16 form: input widths padded to PACK_K_BF16 (a 128-byte row of
# its h and x blocks, kBlockKB), output widths to PACK_K; weight chunks
# of BF16_CHUNK_K input features (64-byte rows, kChunkKB; the library
# reports both)
PACK_K_BF16 = 64
BF16_CHUNK_K = 32


def skip_mlp_plain(x, layers, skips=(), act: str = "relu",
                   act_last: bool = False):
    """Plain PyTorch version (the JAX `_ref_forward` loop).

    x (N, din); layers: sequence of (W (in, out), b (out,)) incl. the
    output head. The activation runs after every layer but the last
    (also the last with `act_last`); after each layer index in `skips`
    the ORIGINAL input is re-concatenated in front: [x, h].

    A bf16 x takes the bf16 form (`_plain_bf16`); the result is float32
    either way."""
    if x.dtype == torch.bfloat16:
        return _plain_bf16(x, layers, skips, act, act_last)
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


def _plain_bf16(x, layers, skips, act, act_last):
    """The bf16 form, as the JAX package's bf16 SkipMLP computes on XLA
    (fields/mlp.py:84-90 with dtype bfloat16; XLA multiplies bf16
    operands in float32): each weight and bias is cast to bf16; each
    layer's product of bf16 values is summed in float32 and rounded to
    bf16, the bias added and the sum rounded to bf16 again, then the
    activation (rounded to bf16); the skip concat re-uses x, the bf16
    input. The last layer without `act_last` keeps the sum of its
    rounded product and its bias in float32 (XLA's excess precision
    drops that rounding before the cast to float32). Returns float32."""
    fn = _ACT_FNS[act]
    bf16 = torch.bfloat16
    h = x
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        p = ((h.float() @ w.to(bf16).float()).to(bf16).float()
             + b.to(bf16).float())
        if i < n - 1 or act_last:
            h = fn(p.to(bf16).float()).to(bf16)
            if i in skips and i < n - 1:
                h = torch.cat([x, h], dim=-1)
        else:
            h = p
    return h.float()


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


class PackedMLP(NamedTuple):
    """A stack's weights in the kernel's layout (see `pack_layers`)."""

    weights: tuple  # per layer, (K_p * N_p,) float32 or bf16
    biases: tuple  # per layer, (N_p,) float32 (bf16 values), zero-padded
    douts: tuple  # per layer, the true output width
    din: int
    skips: tuple
    dtype: torch.dtype = torch.float32  # the form: float32 or bfloat16


def pack_layers(layers, skips=(), din: int | None = None,
                dtype: torch.dtype = torch.float32) -> PackedMLP:
    """(W (in, out), b) pairs -> K1's weight layout, for the float32
    form or (`dtype` bfloat16) the bf16 one.

    Every width is zero-padded, so the padding is exact: a layer's
    input segments (x of width din, then h of the previous layer's
    width) each start at a padded offset, as JAX's `_pad_layers` does at
    128, and each output width is padded to PACK_K. Each padded W^T
    (N_p, K_p) is stored chunk by chunk of input features, every chunk
    contiguous (one bulk copy).

    float32: inputs padded to PACK_K, chunks of PACK_K features in the
    tensor cores' K-major core-matrix order of 8 rows by 16 bytes:
    element (n, k) of chunk k // 16 at ((n // 8) * 4 + (k % 16) // 4) *
    32 + (n % 8) * 4 + k % 4.

    bf16 (weights cast to bf16, biases rounded to bf16 and kept in
    float32): inputs padded to PACK_K_BF16, chunks of BF16_CHUNK_K = 32
    features, each N_p rows of 64 bytes with the 64-byte swizzle that
    wgmma reads (16-byte unit u of row n at u XOR (n // 2) % 4): element
    (n, k) of chunk k // 32 at n * 32 + ((k % 32) // 8 ^ (n // 2) % 4) *
    8 + k % 8."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"skip_mlp: no {dtype} form")
    k_pad = PACK_K if dtype == torch.float32 else PACK_K_BF16
    skips = tuple(skips)
    n_layers = len(layers)
    if n_layers < 1:
        raise ValueError("skip_mlp: no layers")
    din = layers[0][0].shape[0] if din is None else din
    din_p = _round_up(din, k_pad)
    segs = [(din, din_p)]  # (true, padded) width of each input segment
    weights, biases, douts = [], [], []
    for i, (w, b) in enumerate(layers):
        d_in = sum(t for t, _ in segs)
        if (w.dim() != 2 or w.shape[0] != d_in or b.dim() != 1
                or b.shape[0] != w.shape[1]):
            raise ValueError(
                f"skip_mlp: layer {i} has W {tuple(w.shape)}, b "
                f"{tuple(b.shape)}; expected ({d_in}, out) and (out,)"
            )
        dout = w.shape[1]
        n_p = _round_up(dout, PACK_K)
        k_p = sum(p for _, p in segs)
        wp = w.new_zeros(n_p, k_p, dtype=dtype)
        row = row_p = 0
        for t, p in segs:
            wp[:dout, row_p:row_p + t] = w[row:row + t].t()
            row, row_p = row + t, row_p + p
        if dtype == torch.float32:
            # (n/8, n%8, k/16, (k%16)/4, k%4)
            #   -> (k/16, n/8, (k%16)/4, n%8, k%4)
            tiled = wp.view(n_p // 8, 8, k_p // PACK_K, PACK_K // 4, 4)
            weights.append(tiled.permute(2, 0, 3, 1, 4).contiguous().view(-1))
        else:
            # (n, k/32, unit, k%8) -> (k/32, n, unit ^ (n/2)%4, k%8)
            tiled = wp.view(n_p, k_p // BF16_CHUNK_K, 4, 8).permute(1, 0, 2, 3)
            weights.append(_swizzle_units(tiled).contiguous().view(-1))
        bp = b.new_zeros(n_p, dtype=torch.float32)
        bp[:dout] = b.to(dtype)
        biases.append(bp)
        douts.append(dout)
        segs = [(dout, _round_up(dout, k_pad))]
        if i in skips and i < n_layers - 1:
            segs = [(din, din_p), (dout, _round_up(dout, k_pad))]
    return PackedMLP(tuple(weights), tuple(biases), tuple(douts), din,
                     tuple(s for s in skips if 0 <= s < n_layers - 1), dtype)


def _swizzle_units(tiled):
    """(chunks, N, 4, 8) with 16-byte unit u of row n moved to u ^ (n //
    2) % 4, the 64-byte swizzle (the map is its own inverse, so it also
    undoes itself)."""
    n = torch.arange(tiled.shape[1], device=tiled.device)[:, None]
    units = torch.arange(4, device=tiled.device)[None, :] ^ ((n // 2) % 4)
    return tiled[:, n, units, :]


def unpack_layer(packed: PackedMLP, i: int):
    """Layer i's padded W (K_p, N_p) and bias (N_p,) back from the
    chunked layout (for tests and the 3xTF32 emulation)."""
    bp = packed.biases[i]
    n_p = bp.shape[0]
    k_p = packed.weights[i].numel() // n_p
    if packed.dtype == torch.float32:
        tiled = packed.weights[i].view(k_p // PACK_K, n_p // 8, PACK_K // 4,
                                       8, 4)
        return tiled.permute(1, 3, 0, 2, 4).reshape(n_p, k_p).t(), bp
    tiled = _swizzle_units(packed.weights[i].view(k_p // BF16_CHUNK_K, n_p,
                                                  4, 8))
    return tiled.permute(1, 0, 2, 3).reshape(n_p, k_p).t(), bp


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
    lib.skip_mlp_bf16_forward.argtypes = lib.skip_mlp_forward.argtypes
    lib.skip_mlp_bf16_forward.restype = ctypes.c_int
    lib.skip_mlp_bf16_feed.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_uint,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ]
    lib.skip_mlp_bf16_feed.restype = ctypes.c_int
    for name in ("skip_mlp_max_layers", "skip_mlp_max_width",
                 "skip_mlp_chunk_k", "skip_mlp_bf16_chunk_k",
                 "skip_mlp_bf16_block_k"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if (lib.skip_mlp_chunk_k(), lib.skip_mlp_bf16_chunk_k(),
            lib.skip_mlp_bf16_block_k()) != (PACK_K, BF16_CHUNK_K, PACK_K_BF16):
        raise RuntimeError("skip_mlp: the library's chunks are not "
                           "PACK_K, BF16_CHUNK_K and PACK_K_BF16")
    return lib


def _check(x, packed: PackedMLP):
    if x.dtype != packed.dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"skip_mlp: x must be a contiguous (N, din) "
                         f"{packed.dtype} tensor, as the packed weights")
    if x.shape[1] != packed.din:
        raise ValueError(f"skip_mlp: x has {x.shape[1]} features, the "
                         f"weights take {packed.din}")
    lib = _library()
    if not 1 <= len(packed.weights) <= lib.skip_mlp_max_layers():
        raise ValueError(f"skip_mlp: {len(packed.weights)} layers is out of range")
    if max(packed.din, *packed.douts) > lib.skip_mlp_max_width():
        raise ValueError("skip_mlp: a width is more than the kernel takes")
    for t, dtype in [*((w, packed.dtype) for w in packed.weights),
                     *((b, torch.float32) for b in packed.biases)]:
        if (t.device != x.device or t.dtype != dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                "skip_mlp: packed weights must be contiguous, 16-byte "
                "aligned tensors of the form's type on x's device"
            )
    if [w.numel() for w in packed.weights] != _packed_sizes(packed):
        raise ValueError("skip_mlp: the packed weights are not in the "
                         "layout of the form's kernel")


def _packed_sizes(packed: PackedMLP):
    """Each layer's element count in `pack_layers`' layout of the form."""
    k_pad = PACK_K if packed.dtype == torch.float32 else PACK_K_BF16
    sizes, k_p = [], _round_up(packed.din, k_pad)
    for i, dout in enumerate(packed.douts):
        sizes.append(k_p * _round_up(dout, PACK_K))
        k_p = (_round_up(packed.din, k_pad) if i in packed.skips else 0) \
            + _round_up(dout, k_pad)
    return sizes


def _forward(x, layers, skips, act, act_last, packed):
    """The K1 contract on `x`'s device, without a gradient: CPU tensors
    take the plain version, CUDA tensors launch the kernel of x's type
    (or raise)."""
    if x.device.type == "cpu":
        return skip_mlp_plain(x, layers, skips, act, act_last)
    if packed is None:
        packed = pack_layers(layers, skips, x.shape[-1], x.dtype)
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        x = x.clone()  # the bf16 kernel reads x 16 bytes at a time
    _check(x, packed)
    lib = _library()
    n = x.shape[0]
    n_layers = len(packed.weights)
    out = torch.empty(n, packed.douts[-1], device=x.device,
                      dtype=torch.float32)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in packed.weights])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in packed.biases])
    douts = (ctypes.c_int * n_layers)(*packed.douts)
    skip_mask = sum(1 << i for i in packed.skips)
    bf16 = packed.dtype == torch.bfloat16
    launch = lib.skip_mlp_bf16_forward if bf16 else lib.skip_mlp_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(
            x.data_ptr(), out.data_ptr(), n, packed.din, n_layers, w_ptrs,
            b_ptrs, douts, skip_mask, _ACT_CODES[act], int(act_last), stream,
        )
    if rc != 0:
        raise RuntimeError(f"skip_mlp: kernel launch failed (CUDA error {rc})")
    if n > 0:
        if bf16:
            skip_mlp.launches_bf16 += 1
        else:
            skip_mlp.launches += 1
    return out


def weight_stream_bf16(n: int, packed: PackedMLP, device) -> int:
    """Launch the bf16 form's weight stream alone on `device`'s current
    stream (csrc/skip_mlp.cu `skip_mlp_bf16_feed_kernel`: the kernel's
    producer and ring on its grid for `n` rows, no products), for
    measuring how fast L2 fills the ring. Returns the bytes it copies
    from L2 into shared memory. Not a K1 launch: counts nothing."""
    if packed.dtype != torch.bfloat16:
        raise ValueError("skip_mlp: the weight stream is the bf16 form's")
    lib = _library()
    n_layers = len(packed.weights)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in packed.weights])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in packed.biases])
    douts = (ctypes.c_int * n_layers)(*packed.douts)
    nbytes = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.skip_mlp_bf16_feed(
            n, packed.din, n_layers, w_ptrs, b_ptrs, douts,
            sum(1 << i for i in packed.skips), ctypes.byref(nbytes), stream)
    if rc != 0:
        raise RuntimeError(f"skip_mlp: weight stream failed (CUDA error {rc})")
    return nbytes.value


class SkipMLPFunction(torch.autograd.Function):
    """K1 with a gradient. Forward: `_forward` (the kernel on CUDA
    tensors, the plain version on CPU tensors). Backward: the vjp of
    `skip_mlp_plain`, recomputed from the saved input and weights in
    plain PyTorch matmuls, as JAX's `bwd` recomputes `_ref_forward`.

    The backward is differentiable again: the recompute runs on views
    of the saved tensors, and when the outer call asks for
    `create_graph` (grad mode is on inside the backward) the returned
    gradients carry a graph back to the input, to every weight and to
    the incoming cotangent, as JAX differentiates its `bwd` (a gradient
    of a gradient, e.g. an eikonal loss on d y / d x). Otherwise they
    keep no graph.

    apply(x, packed, (skips, act, act_last), W0, b0, W1, b1, ...)."""

    @staticmethod
    def forward(ctx, x, packed, config, *flat):
        skips, act, act_last = config
        ctx.config = config
        ctx.save_for_backward(x, *flat)
        return _forward(x, list(zip(flat[0::2], flat[1::2])), skips, act,
                        act_last, packed)

    @staticmethod
    def backward(ctx, grad_out):
        skips, act, act_last = ctx.config
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            # aliases of the saved tensors: the vjp stops at them, so it
            # gives partial derivatives even where x was computed from
            # these weights, and frees nothing of the outer graph; under
            # create_graph its result reaches the saved tensors through
            # the aliases
            inputs = [t.view_as(t) if need else t.detach()
                      for t, need in zip(ctx.saved_tensors, needs)]
            y = skip_mlp_plain(inputs[0], list(zip(inputs[1::2], inputs[2::2])),
                               skips, act, act_last)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(y, wanted, grad_out,
                                         create_graph=create_graph))
        out = [next(grads) if need else None for need in needs]
        return (out[0], None, None, *out[1:])


def skip_mlp(x, layers, skips=(), act: str = "relu", act_last: bool = False,
             packed: PackedMLP | None = None):
    """The K1 contract on `x`'s device: CPU tensors take the plain
    version, CUDA tensors launch the kernel (or raise). Arguments as in
    `skip_mlp_plain`; weights are (in, out) like the JAX wrapper's.
    `packed`, where given, is `pack_layers(layers, skips, dtype=x.dtype)`,
    made once by the weights' owner; otherwise the call packs them. A
    bf16 x takes the bf16 form; the output is float32 either way. When grad mode is
    on and x or a weight requires grad, the call goes through
    `SkipMLPFunction`, so the output carries a gradient on both devices."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"skip_mlp: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"skip_mlp: no {x.dtype} form")
    skips = tuple(skips)
    flat = [t for wb in layers for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *flat)):
        return SkipMLPFunction.apply(x, packed, (skips, act, act_last), *flat)
    return _forward(x, layers, skips, act, act_last, packed)


# launches of the CUDA kernels in this process (the CPU path never
# counts): the float32 form's, and the bf16 form's apart
skip_mlp.launches = 0
skip_mlp.launches_bf16 = 0
