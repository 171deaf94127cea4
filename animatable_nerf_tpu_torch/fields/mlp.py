"""Skip-concat MLP stacks of nn.Linear layers, run through kernel K1.

JAX counterpart: animatable_nerf_tpu/fields/mlp.py:36-92 (`SkipMLP`):
a D-layer ReLU MLP whose ORIGINAL input is re-concatenated in front of
the activations after each layer in `skips` — `[x, h]`, after the
activation of that layer (reference tpose_nerf_network.py:66-71). The
JAX package selects its Pallas kernel with a `fused` switch; here the
stack always goes through ops/skip_mlp.py, which launches the CUDA
kernel on the card and runs its plain version on the CPU.

Also the weight-normalized dense layer of the SDF-PDF heads (JAX
fields/mlp.py:108 `wn_apply`, :127 `WNDense`), and the initial weights
a training run from scratch takes: flax's `lecun_normal` with zero
biases (`dense_init_`, JAX :20 `dense_param_init`) and the IDR geometric
init of the SDF network (`geometric_init_`, JAX :147
`geometric_mlp_params`). They follow JAX's rules with torch's random
numbers, not its PRNG's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.skip_mlp import pack_layers, skip_mlp


def lecun_normal_(weight):
    """flax's lecun_normal on a torch (out, in) weight: a normal of
    variance 1 / fan_in, truncated at two standard deviations and
    rescaled to keep that variance (jax.nn.initializers.variance_scaling
    with 'truncated_normal')."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def dense_init_(linears):
    """JAX `dense_param_init` on nn.Linear layers: lecun_normal kernels,
    zero biases."""
    with torch.no_grad():
        for lin in linears:
            lecun_normal_(lin.weight)
            lin.bias.zero_()


def skip_linears(din: int, width: int, depth: int, skips) -> nn.ModuleList:
    """`depth` hidden nn.Linear layers; layer i+1 reads [x, h] when i is
    in `skips`."""
    layers = []
    d_in = din
    for i in range(depth):
        layers.append(nn.Linear(d_in, width))
        d_in = width + (din if i in skips else 0)
    return nn.ModuleList(layers)


def kernel_layers(linears) -> list:
    """nn.Linear weights (out, in) -> K1's (W (in, out), b) pairs, as
    views (the plain version multiplies them as they are)."""
    return [(lin.weight.t(), lin.bias) for lin in linears]


def packed_layers(owner: nn.Module, linears, skips, din: int,
                  dtype: torch.dtype = torch.float32):
    """K1's packed weights of `linears` for the form `dtype` (float32 or
    bf16), made once per weight version and kept on `owner`, the module
    that holds them, one pack per form. The key is each parameter itself
    (held, so its identity cannot be reused), its `_version`, which
    every in-place update bumps (optimizer steps, `load_state_dict`),
    and its device; never a data pointer, which a freed tensor hands on
    to fresh weights."""
    params = [p for lin in linears for p in (lin.weight, lin.bias)]
    key = [(p, p._version, p.device) for p in params]
    slot = "_k1_packed" if dtype == torch.float32 else "_k1_packed_bf16"
    cached = owner.__dict__.get(slot)
    if cached is not None and len(cached[0]) == len(key) and all(
            a is p and va == vp and da == dp
            for (a, va, da), (p, vp, dp) in zip(cached[0], key)):
        return cached[1]
    with torch.no_grad():
        packed = pack_layers(kernel_layers(linears), skips, din, dtype)
    owner.__dict__[slot] = (key, packed)
    return packed


def run_skip_mlp(owner: nn.Module, x, linears, skips, act_last: bool = False,
                 dtype: torch.dtype = torch.float32):
    """Apply a stack of nn.Linear layers held by `owner` as one K1 call
    (ReLU) in the compute dtype: float32, or bf16 (x cast to bf16 first,
    K1's bf16 form; JAX `SkipMLP` with dtype bfloat16). The result is
    float32. On the card the weights go in packed once per weight
    version and form (`packed_layers`; in training every optimizer step
    makes a new version, so K1 repacks once a step); the CPU runs the
    plain version on them as they are. With grad mode on, the call goes
    through ops/skip_mlp.py `SkipMLPFunction`, whose backward
    differentiates the plain version."""
    x = x.to(dtype).contiguous()
    skips = tuple(skips)
    packed = (packed_layers(owner, linears, skips, x.shape[-1], dtype)
              if x.device.type == "cuda" else None)
    return skip_mlp(x, kernel_layers(linears), skips=skips, act="relu",
                    act_last=act_last, packed=packed)


def linear(lin: nn.Linear, x, dtype: torch.dtype = torch.float32):
    """An nn.Linear head in the compute dtype: float32 as it is; bf16 as
    flax's `Dense` with dtype bfloat16 (JAX fields/fields.py:98-102): x,
    the weight and the bias cast to bf16, the product rounded to bf16,
    then the bias added in bf16."""
    if dtype == torch.float32:
        return lin(x)
    return x.to(dtype) @ lin.weight.t().to(dtype) + lin.bias.to(dtype)


def wn_weight(weight_v, weight_g):
    """The weight-normalized weight exactly as JAX `wn_apply` forms it:
    v * (g / (||v|| + 1e-12)), the norm per output unit. v (out, in),
    g (out, 1), as torch's weight_norm names them; torch's own
    weight_norm has no 1e-12."""
    norm = torch.linalg.norm(weight_v, dim=1, keepdim=True)
    return weight_v * (weight_g / (norm + 1e-12))


class WNLinear(nn.Module):
    """y = x @ wn_weight(v, g).T + b (JAX fields/mlp.py:127 `WNDense`),
    with the reference's parameter names `weight_v`, `weight_g`, `bias`
    (anisdf_pdf_network.py:410-411)."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(dout, din))
        self.weight_g = nn.Parameter(torch.empty(dout, 1))
        self.bias = nn.Parameter(torch.zeros(dout))
        # JAX `_wn_init` with WNDense's lecun_normal direction
        with torch.no_grad():
            lecun_normal_(self.weight_v)
            self.reset_norm()

    def reset_norm(self):
        """g = ||v|| per output unit (torch weight_norm's init)."""
        self.weight_g.copy_(torch.linalg.norm(self.weight_v, dim=1,
                                              keepdim=True))

    def forward(self, x, dtype: torch.dtype = torch.float32):
        """In float32, or in bf16 as JAX `wn_apply` with a dtype
        (fields/mlp.py:105-120): the normalized weight is formed in
        float32, then it, x and the bias are cast to bf16 and
        x @ w + b is computed in bf16."""
        w = wn_weight(self.weight_v, self.weight_g)
        if dtype == torch.float32:
            return F.linear(x, w, self.bias)
        return x.to(dtype) @ w.t().to(dtype) + self.bias.to(dtype)


@torch.no_grad()
def geometric_init_(layers, d_pe: int, skip_in):
    """The IDR geometric init of a weight-normalized SDF MLP (JAX
    fields/mlp.py:147 `geometric_mlp_params` with its bias 0.5;
    reference anisdf_pdf_network.py:379-413), on WNLinear `layers` whose
    first takes the positional encoding of xyz (d_pe channels, the raw
    xyz first):
      * the last layer: v ~ N(sqrt(pi) / sqrt(in), 1e-4), bias -0.5;
      * the first: v ~ N(0, sqrt(2) / sqrt(out)) on the xyz columns,
        its encoding columns zero;
      * a skip layer: the same normal, the columns of the re-concatenated
        encoding (its last d_pe - 3 inputs) zero;
      * the others: N(0, sqrt(2) / sqrt(out));
    zero biases but the last, and g = ||v|| per output unit. The sdf
    then starts near |x| - 0.5."""
    n = len(layers)
    for l, lin in enumerate(layers):
        v = lin.weight_v
        dout, din = v.shape
        lin.bias.zero_()
        if l == n - 1:
            nn.init.normal_(v, mean=math.sqrt(math.pi) / math.sqrt(din),
                            std=1e-4)
            lin.bias.fill_(-0.5)
        else:
            nn.init.normal_(v, std=math.sqrt(2.0) / math.sqrt(dout))
            if l == 0:
                v[:, 3:] = 0.0
            elif l in skip_in:
                v[:, din - (d_pe - 3):] = 0.0
        lin.reset_norm()
