"""Skip-concat MLP stacks of nn.Linear layers, run through kernel K1.

JAX counterpart: animatable_nerf_tpu/fields/mlp.py:36-92 (`SkipMLP`):
a D-layer ReLU MLP whose ORIGINAL input is re-concatenated in front of
the activations after each layer in `skips` — `[x, h]`, after the
activation of that layer (reference tpose_nerf_network.py:66-71). The
JAX package selects its Pallas kernel with a `fused` switch; here the
stack always goes through ops/skip_mlp.py, which launches the CUDA
kernel on the card and runs its plain version on the CPU.
"""

from __future__ import annotations

from torch import nn

from ..ops.skip_mlp import skip_mlp


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
    """nn.Linear weights (out, in) -> K1's (W (in, out), b) pairs."""
    return [(lin.weight.t().contiguous(), lin.bias) for lin in linears]


def run_skip_mlp(x, linears, skips, act_last: bool = False):
    """Apply a stack of nn.Linear layers as one K1 call (ReLU)."""
    return skip_mlp(
        x.contiguous(), kernel_layers(linears), skips=tuple(skips),
        act="relu", act_last=act_last,
    )
