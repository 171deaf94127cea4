"""Kernels K1 (csrc/skip_mlp.cu), K2 and K3 (csrc/knn.cu) on the card
against their plain PyTorch versions. Needs an NVIDIA GPU and nvcc, and
skips elsewhere; it imports nothing of JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel). K2
and K3 round every operation as their plain versions do (no FMA, the
same order), so they must agree to the bit: atol = rtol = 0.
"""

import numpy as np
import pytest
import torch

from animatable_nerf_tpu_torch.ops import knn
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


# (N queries, M vertices, C channels): SMPL's vertex count, M just past
# and just short of a 1024-vertex tile, and fewer vertices than a tile
KNN_SHAPES = [(4000, 6890, 24), (257, 1025, 7), (1000, 1023, 24),
              (33, 5, 3)]


def knn_case(n, m, c, seed, dup=0):
    """Seeded queries around a seeded vertex cloud; `dup` exact copies
    of vertex 0 at the end pin the lowest-index tie-break."""
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    if dup:
        ref[-dup:] = ref[0]
    src = (ref[rng.randint(0, m, n)]
           + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    vals = rng.uniform(0, 1, (m, c)).astype(np.float32)
    return src, ref, vals


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KNN_SHAPES)
def test_cuda_knn_blend_matches_plain(cuda_device, shape):
    n, m, c = shape
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_case(n, m, c, 5, dup=min(3, m - 1)))
    k = min(5, m)
    before = knn.knn_blend.launches
    got_v, got_d = knn.knn_blend(src, ref, vals, k=k)
    torch.cuda.synchronize()
    assert knn.knn_blend.launches == before + 1
    ref_v, ref_d = knn.knn_blend_plain(src, ref, vals, k=k)
    np.testing.assert_array_equal(got_v.cpu().numpy(), ref_v.cpu().numpy())
    np.testing.assert_array_equal(got_d.cpu().numpy(), ref_d.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KNN_SHAPES)
def test_cuda_min_dist_matches_plain(cuda_device, shape):
    n, m, _ = shape
    src, ref, _ = knn_case(n, m, 1, 6)
    src, ref = torch.tensor(src, device=cuda_device), torch.tensor(ref, device=cuda_device)
    before = knn.min_dist.launches
    got = knn.min_dist(src, ref)
    torch.cuda.synchronize()
    assert knn.min_dist.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  knn.min_dist_plain(src, ref).cpu().numpy())


@pytest.mark.cuda
def test_cuda_inputs_never_reach_the_plain_versions(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(knn, "knn_blend_plain", refuse)
    monkeypatch.setattr(knn, "min_dist_plain", refuse)
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_case(300, 700, 24, 7))
    knn.knn_blend(src, ref, vals)
    knn.min_dist(src, ref)
    packed, margin, bounds = knn.build_pdist_payload(ref, res=16)
    torch.cuda.synchronize()
    assert packed.shape == (15, 15, 15, 8) and packed.is_cuda


@pytest.mark.cuda
def test_cuda_knn_rejects_bad_inputs(cuda_device):
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_case(16, 40, 24, 8))
    with pytest.raises(ValueError):
        knn.knn_blend(src.double(), ref, vals)
    with pytest.raises(ValueError):
        knn.knn_blend(src, ref[:4], vals[:4])  # M < k
    with pytest.raises(ValueError):
        knn.knn_blend(src, ref.t().contiguous().t(), vals)  # not contiguous
    with pytest.raises(ValueError):
        knn.knn_blend(src, ref, vals.cpu())
    with pytest.raises(ValueError):
        knn.min_dist(src, ref.cpu())
