"""Kernel K1 (csrc/skip_mlp.cu) on the card against its plain PyTorch
version. Needs an NVIDIA GPU and nvcc, and skips elsewhere; it imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel).
"""

import numpy as np
import pytest
import torch

from animatable_nerf_tpu_torch.ops import skip_mlp as k1

TOL = dict(rtol=1e-5, atol=1e-5)

# (din, widths, skips, act, act_last)
SMALL = {
    "relu_skip2": (39, [64, 64, 64, 64, 16], (2,), "relu", False),
    "softplus": (39, [64, 64, 64, 64, 16], (2,), "softplus", False),
    "act_last": (21, [32, 32, 32], (0,), "relu", True),
    # widths that are no multiple of 4: the kernel's scalar copy paths
    "odd_widths": (13, [30, 30, 7], (0,), "relu", False),
}
PRODUCTION = {
    "bw_field": (191, [256] * 8 + [24], (4,), "relu", False),
    "tpose_trunk": (63, [256] * 8, (4,), "relu", True),
}


def make_layers(rng, din, widths, skips):
    """Seeded (W (in, out), b) pairs wired like SkipMLP."""
    layers = []
    d_in = din
    for i, w in enumerate(widths):
        W = (rng.randn(d_in, w) / np.sqrt(d_in)).astype(np.float32)
        b = (rng.randn(w) * 0.1).astype(np.float32)
        layers.append((W, b))
        d_in = w + (din if (i in skips and i < len(widths) - 1) else 0)
    return layers


def make_case(spec, rows, seed):
    din, widths, skips, act, act_last = spec
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (rows, din)).astype(np.float32)
    return x, make_layers(rng, din, widths, skips), skips, act, act_last


def torch_layers(layers, device="cpu"):
    return [(torch.tensor(w, device=device), torch.tensor(b, device=device))
            for w, b in layers]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 1000])
@pytest.mark.parametrize("name", sorted({**SMALL, **PRODUCTION}))
def test_cuda_kernel_matches_plain(cuda_device, name, rows):
    spec = {**SMALL, **PRODUCTION}[name]
    x, layers, skips, act, act_last = make_case(spec, rows, 3)
    tl = torch_layers(layers, cuda_device)
    xt = torch.tensor(x, device=cuda_device)
    before = k1.skip_mlp.launches
    got = k1.skip_mlp(xt, tl, skips, act, act_last)
    torch.cuda.synchronize()
    assert k1.skip_mlp.launches == before + (1 if rows else 0)
    plain = k1.skip_mlp_plain(xt, tl, skips, act, act_last)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_inputs(cuda_device):
    x, layers, skips, act, act_last = make_case(SMALL["relu_skip2"], 8, 4)
    tl = torch_layers(layers, cuda_device)
    xt = torch.tensor(x, device=cuda_device)
    with pytest.raises(ValueError):
        k1.skip_mlp(xt.double(), tl, skips)
    with pytest.raises(ValueError):
        k1.skip_mlp(xt, [(w.t(), b) for w, b in tl], skips)
    with pytest.raises(ValueError):
        k1.skip_mlp(xt, tl[1:], skips)
    with pytest.raises(ValueError):
        k1.skip_mlp(xt, torch_layers(layers), skips)  # weights on the CPU
