"""Kernels K1 (csrc/skip_mlp.cu) and K2-K6 (csrc/knn.cu) on the card
against their plain PyTorch versions. Needs an NVIDIA GPU and nvcc, and
skips elsewhere; it imports nothing of JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel); its
bf16 form within BF16_REL_TOL = 2e-2 of the output's largest value; the
same for K1's gradient (ops/skip_mlp.py `SkipMLPFunction`) against
autograd through the plain version, and for a train step on the card
against the same step on the CPU (loss rtol 1e-4, each gradient leaf
within 1e-2 of its largest entry: rounding in the canonical points is
multiplied by the positional encoding, as between the JAX and port CPU
steps, tests/test_torch_train.py, which measured 2.3e-3); the same for
a train step of SDF-PDF, NeRF-PDF and NeuS-PDF and a stage-2 step of
AniNeRF (novel pose) and of the four aligned families, and a stage-2
step of AlignedLBW and AlignedLBWPDF, and for a compacted train step
(`train_keep_frac` > 0) against the dense step on the card, for the
eval items (the
novel-pose item, a distorted camera at ratio 0.5, the aligned
families' items and novel-pose items: maps within 1e-4; without the
distance grid, within 1e-5 of the grid render, whose survivors it
keeps; a mesh's vertices within 2% of the voxel, the same faces; a
carved novel view: the same counts, maps within 1e-4; the baselines'
point ops on the capsule: the same indices; their splat at 1024x1024:
the same winners but on at most 4 pixels; an NHR or NT item: rgb and
mask within 1e-4, NHR's within twice what one ulp of its vertices moves
the CPU's forward, if more, but at most 5e-3), and K1's
gradient of a
gradient within 1e-5 of each tensor's scale (the backward and its
derivative are the plain version's on both sides), as for K2's gradient
(the plain vjp over the selected vertices on both sides). K2-K6
round every operation as their plain versions do (no FMA, the same
order), so they must agree to the bit: atol = rtol = 0.
"""

import numpy as np
import pytest
import torch
from knn_cases import BLOCKED_CASES, KINDS, blocked_inputs, knn_inputs

from animatable_nerf_tpu_torch.models.common import grid_d5_upper
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
    # the bf16 form's widest inputs: a 250-wide row spans 33 aligned
    # 16-byte runs of x; 256 is the most x takes (its fewest stages);
    # 80-wide layers take the 256-wide n-tile with zeros past 80
    "wide_x": (250, [48, 48, 5], (0,), "softplus", False),
    "full_x": (256, [80, 80, 10], (1,), "relu", True),
}
PRODUCTION = {
    "bw_field": (191, [256] * 8 + [24], (4,), "relu", False),
    "tpose_trunk": (63, [256] * 8, (4,), "relu", True),
    "resd_field": (135, [256] * 8 + [3], (4,), "relu", False),
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
# rows: around the kernel's 128-row block and its 64-row warpgroups
@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 127, 128, 129, 1000, 4097])
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


# K1's bf16 form against its plain bf16 version: two bf16 steps of the
# output's largest value (chip_smoke.py K1_BF16_REL_TOL; products summed
# in float32 in another order move a value across a bf16 rounding)
BF16_REL_TOL = 2e-2


@pytest.mark.cuda
# rows: around the 128-row tile and the 64-row warpgroups, an odd number
# of tiles (257, 4097), and more tiles than the card has SMs, so that a
# block walks several (33,797 rows: 265 tiles)
@pytest.mark.parametrize("rows", [0, 1, 65, 127, 128, 129, 255, 256, 257,
                                  4097, 33797])
@pytest.mark.parametrize("name", sorted({**SMALL, **PRODUCTION}))
def test_cuda_bf16_kernel_matches_plain(cuda_device, name, rows):
    """A bf16 input launches the bf16 form, counted apart, and never the
    float32 one."""
    spec = {**SMALL, **PRODUCTION}[name]
    x, layers, skips, act, act_last = make_case(spec, rows, 3)
    tl = torch_layers(layers, cuda_device)
    xt = torch.tensor(x, device=cuda_device).to(torch.bfloat16)
    before = (k1.skip_mlp.launches, k1.skip_mlp.launches_bf16)
    got = k1.skip_mlp(xt, tl, skips, act, act_last)
    torch.cuda.synchronize()
    assert (k1.skip_mlp.launches, k1.skip_mlp.launches_bf16) == (
        before[0], before[1] + (1 if rows else 0))
    plain = k1.skip_mlp_plain(xt, tl, skips, act, act_last)
    assert got.dtype == plain.dtype == torch.float32
    if rows:
        err = (got - plain).abs().max().item()
        assert err <= BF16_REL_TOL * max(1.0, plain.abs().max().item()), err


@pytest.mark.cuda
def test_cuda_bf16_kernel_takes_an_unaligned_input(cuda_device):
    """x one row into a larger tensor (at width 191 not 16-byte aligned,
    which the kernel's bulk copies need) gives what a fresh copy gives."""
    x, layers, skips, act, act_last = make_case(PRODUCTION["bw_field"], 300, 4)
    tl = torch_layers(layers, cuda_device)
    view = torch.tensor(x, device=cuda_device).to(torch.bfloat16)[1:]
    assert view.data_ptr() % 16
    got = k1.skip_mlp(view, tl, skips, act, act_last)
    want = k1.skip_mlp(view.clone(), tl, skips, act, act_last)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_bf16_field_keeps_its_own_pack(cuda_device):
    """A field in bf16 packs its weights for the bf16 form beside the
    float32 pack, and matches its CPU plain version."""
    from animatable_nerf_tpu_torch.fields.fields import (
        ResidualField,
        set_compute_dtype,
    )

    torch.manual_seed(0)
    field = ResidualField().to(cuda_device)
    rng = np.random.RandomState(13)
    pts = torch.tensor(rng.uniform(-1, 1, (300, 3)).astype(np.float32),
                       device=cuda_device)
    pose = torch.tensor(rng.normal(0, 0.3, 72).astype(np.float32),
                        device=cuda_device)
    with torch.no_grad():
        field.residual(pts, pose)
        set_compute_dtype(field, torch.bfloat16)
        got = field.residual(pts, pose)
        assert field._k1_packed_bf16[1].dtype == torch.bfloat16
        assert field._k1_packed[1].dtype == torch.float32
        plain = field.cpu().residual(pts.cpu(), pose.cpu())
    err = (got.cpu() - plain).abs().max().item()
    assert err <= BF16_REL_TOL * max(1.0, plain.abs().max().item()), err


@pytest.mark.cuda
def test_cuda_field_packs_once_per_weight_version(cuda_device):
    """A field packs its weights on its first call, reuses the pack
    while the weights stay, and packs anew after an in-place update."""
    from animatable_nerf_tpu_torch.fields.fields import ResidualField

    torch.manual_seed(0)
    field = ResidualField().to(cuda_device)
    rng = np.random.RandomState(13)
    pts = torch.tensor(rng.uniform(-1, 1, (300, 3)).astype(np.float32),
                       device=cuda_device)
    pose = torch.tensor(rng.normal(0, 0.3, 72).astype(np.float32),
                        device=cuda_device)
    with torch.no_grad():
        first = field.residual(pts, pose)
        pack = field._k1_packed[1]
        field.residual(pts, pose)
        assert field._k1_packed[1] is pack
        field.resd_fc.weight.mul_(2.0)
        moved = field.residual(pts, pose)
        assert field._k1_packed[1] is not pack
        plain = field.cpu().residual(pts.cpu(), pose.cpu())
    assert not torch.equal(first, moved)
    np.testing.assert_allclose(moved.cpu().numpy(), plain.numpy(), **TOL)


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


# one training step's dense points: 512 rays x 64 samples
TRAIN_ROWS = 32768


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PRODUCTION))
def test_cuda_k1_gradient_matches_autograd_of_plain(cuda_device, name):
    """K1 with a gradient (SkipMLPFunction) at one train step's rows:
    the forward is the kernel's, the gradients of x, W and b those of
    autograd through skip_mlp_plain."""
    x, layers, skips, act, act_last = make_case(PRODUCTION[name], TRAIN_ROWS, 5)
    grads = []
    for fn in (k1.skip_mlp, k1.skip_mlp_plain):
        xt = torch.tensor(x, device=cuda_device, requires_grad=True)
        tl = [(w.requires_grad_(), b.requires_grad_())
              for w, b in torch_layers(layers, cuda_device)]
        out = fn(xt, tl, skips, act, act_last)
        g = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
        out.backward(g)
        grads.append([out.detach()] + [t.grad for t in (xt, *[u for wb in tl for u in wb])])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_k1_with_grad_launches_the_kernel_and_keeps_a_grad_fn(
        cuda_device, monkeypatch):
    """A CUDA call whose input requires grad returns an output with a
    grad_fn (its weights and input get a gradient), launches K1, and
    does not run the plain forward: the plain version runs only in the
    backward's recompute."""
    x, layers, skips, act, act_last = make_case(PRODUCTION["bw_field"], 300, 6)
    plain_calls = []
    plain = k1.skip_mlp_plain
    monkeypatch.setattr(k1, "skip_mlp_plain",
                        lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    xt = torch.tensor(x, device=cuda_device, requires_grad=True)
    tl = [(w.requires_grad_(), b) for w, b in torch_layers(layers, cuda_device)]
    before = k1.skip_mlp.launches
    out = k1.skip_mlp(xt, tl, skips, act, act_last)
    assert out.grad_fn is not None
    assert k1.skip_mlp.launches == before + 1 and not plain_calls
    out.sum().backward()
    assert len(plain_calls) == 1 and k1.skip_mlp.launches == before + 1
    assert xt.grad is not None and all(w.grad is not None for w, _ in tl)
    assert all(b.grad is None for _, b in tl)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One AniNeRF train step (configs/synthetic.yaml, 64 rays of 16
    samples, perturb 0, the tracked weights) on the card and on the
    CPU: loss, each gradient leaf, and K1 launched three times."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train.trainer import (
        Trainer, collate_rays, stack_batch)

    cfg = load_config("configs/synthetic.yaml",
                      ["N_rand", "64", "N_samples", "16", "perturb", "0"])
    state = aninerf_state_dict(read_checkpoint(
        "data/trained_model/deform/synthetic/latest.flax")["params"])
    ds = engine.make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[4], 64)])
    results = []
    for device in ("cpu", cuda_device):
        model = engine.make_model(cfg)
        model.load_state_dict(state)
        trainer = Trainer(cfg, model.to(device), device)
        before = k1.skip_mlp.launches
        loss, _, _ = trainer.loss({k: v[0] for k, v in batch.items()})
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()},
                        k1.skip_mlp.launches - before))
    (cpu_loss, cpu_g, cpu_n), (gpu_loss, gpu_g, gpu_n) = results
    assert cpu_n == 0 and gpu_n == 3
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-4)
    for name, want in cpu_g.items():
        err = (gpu_g[name] - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_k1_gradient_of_gradient_matches_autograd_of_plain(cuda_device):
    """A loss on d(u . y)/dx through K1 at one train step's rows of the
    displacement field's wiring, differentiated again with respect to x
    and every layer, against autograd-of-autograd through
    skip_mlp_plain: the backward keeps a graph under create_graph."""
    x, layers, skips, act, act_last = make_case(PRODUCTION["resd_field"],
                                                TRAIN_ROWS, 8)
    gen = torch.Generator(cuda_device).manual_seed(2)
    u = torch.randn(TRAIN_ROWS, 3, device=cuda_device, generator=gen)
    results = []
    for fn in (k1.skip_mlp, k1.skip_mlp_plain):
        xt = torch.tensor(x, device=cuda_device, requires_grad=True)
        tl = [(w.requires_grad_(), b.requires_grad_())
              for w, b in torch_layers(layers, cuda_device)]
        before = k1.skip_mlp.launches
        y = fn(xt, tl, skips, act, act_last)
        (g,) = torch.autograd.grad((y * u).sum(), xt, create_graph=True)
        flat = [xt] + [t for wb in tl for t in wb]
        second = torch.autograd.grad((g * g).sum(), flat, allow_unused=True)
        results.append((k1.skip_mlp.launches - before,
                        [torch.zeros_like(t) if d is None else d
                         for d, t in zip(second, flat)]))
    torch.cuda.synchronize()
    (n_kernel, got), (n_plain, want) = results
    assert n_kernel == 1 and n_plain == 0
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * max(1.0, b.abs().max().item()), err


def pdf_step_inputs(family="sdf_pdf", n_rays=64, n_samples=16):
    """configs/synthetic_<family>.yaml at n_rays x n_samples (perturb 0),
    the tracked weights and one seeded train batch."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    cfg = load_config(f"configs/synthetic_{family}.yaml",
                      ["N_rand", str(n_rays), "N_samples", str(n_samples),
                       "perturb", "0"])
    state = param_codec(engine.make_model(cfg))[0](read_checkpoint(
        f"data/trained_model/deform/synthetic_{family}/latest.flax")["params"])
    ds = engine.make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    return cfg, state, stack_batch([collate_rays(ds[4], n_rays)])


def pdf_trainer(cfg, state, device):
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    model = engine.make_model(cfg)
    model.load_state_dict(state)
    return Trainer(cfg, model.to(device), device)


@pytest.mark.cuda
def test_cuda_sdf_pdf_train_step_matches_cpu(cuda_device):
    """One SDF-PDF train step (64 rays of 16 samples, the tracked
    weights) on the card and on the CPU: loss and stats, each gradient
    leaf, K1 launched twice and K2 once on the card, neither on the CPU."""
    cfg, state, batch = pdf_step_inputs()
    results = []
    for device in ("cpu", cuda_device):
        trainer = pdf_trainer(cfg, state, device)
        before = (k1.skip_mlp.launches, knn.knn_blend.launches)
        loss, stats, _ = trainer.loss({k: v[0] for k, v in batch.items()})
        loss.backward()
        results.append((
            {k: float(v.detach()) for k, v in stats.items()},
            {n: p.grad.cpu() for n, p in trainer.model.named_parameters()},
            (k1.skip_mlp.launches - before[0], knn.knn_blend.launches - before[1])))
    (cpu_s, cpu_g, cpu_n), (gpu_s, gpu_g, gpu_n) = results
    assert cpu_n == (0, 0) and gpu_n == (2, 1)
    assert set(cpu_s) == {"offset_loss", "grad_loss", "ograd_loss",
                          "mask_loss", "img_loss", "loss"}
    for k, v in cpu_s.items():
        np.testing.assert_allclose(gpu_s[k], v, rtol=1e-4, err_msg=k)
    for name, want in cpu_g.items():
        err = (gpu_g[name] - want).abs().max().item()
        assert torch.isfinite(gpu_g[name]).all(), name
        assert err <= 1e-2 * want.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_sdf_pdf_train_forward_takes_no_plain_version(cuda_device,
                                                           monkeypatch):
    """SDFPDF.train_forward on the card launches K1 twice and K2 once; no
    KNN plain version runs, and the plain skip-MLP runs once, as the
    recompute of K1's backward inside the observed-space normal (the
    gradient the forward itself takes)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
                 "knn_blend_blocked_plain", "knn_blend_celled_plain",
                 "_select_blend"):
        monkeypatch.setattr(knn, name, refuse)
    plain_calls = []
    plain = k1.skip_mlp_plain
    monkeypatch.setattr(k1, "skip_mlp_plain",
                        lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    cfg, state, batch = pdf_step_inputs()
    trainer = pdf_trainer(cfg, state, cuda_device)
    before = (k1.skip_mlp.launches, knn.knn_blend.launches)
    loss, _, ret = trainer.loss({k: v[0] for k, v in batch.items()})
    assert (k1.skip_mlp.launches - before[0],
            knn.knn_blend.launches - before[1]) == (2, 1)
    assert len(plain_calls) == 1
    assert ret["observed_gradients"].grad_fn is not None
    loss.backward()
    # the backward recomputes each of the two K1 calls once more
    assert k1.skip_mlp.launches - before[0] == 2 and len(plain_calls) >= 2
    assert all(torch.isfinite(p.grad).all()
               for p in trainer.model.parameters() if p.grad is not None)


# per train step of NeRF-PDF and NeuS-PDF on the card: (K1, K2)
# launches in the forward, and the plain skip-MLP's calls in it (K1's
# backward recomputed inside NeuS's observed-space normal)
FAMILY_TRAIN = {"nerf_pdf": ((1, 1), 0), "neus_pdf": ((2, 1), 1)}
FAMILY_STATS = {
    "nerf_pdf": {"offset_loss", "img_loss", "loss"},
    "neus_pdf": {"offset_loss", "grad_loss", "ograd_loss", "mask_loss",
                 "img_loss", "loss"}}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILY_TRAIN))
def test_cuda_pdf_family_train_step_matches_cpu(cuda_device, family):
    """One NeRF-PDF or NeuS-PDF train step (64 rays of 16 samples, the
    tracked weights) on the card and on the CPU: loss and stats, each
    gradient leaf, and K1 and K2 launched FAMILY_TRAIN's times on the
    card, never on the CPU."""
    cfg, state, batch = pdf_step_inputs(family=family)
    results = []
    for device in ("cpu", cuda_device):
        trainer = pdf_trainer(cfg, state, device)
        before = (k1.skip_mlp.launches, knn.knn_blend.launches)
        loss, stats, _ = trainer.loss({k: v[0] for k, v in batch.items()})
        loss.backward()
        results.append((
            {k: float(v.detach()) for k, v in stats.items()},
            {n: p.grad.cpu() for n, p in trainer.model.named_parameters()},
            (k1.skip_mlp.launches - before[0], knn.knn_blend.launches - before[1])))
    (cpu_s, cpu_g, cpu_n), (gpu_s, gpu_g, gpu_n) = results
    assert cpu_n == (0, 0) and gpu_n == FAMILY_TRAIN[family][0]
    assert set(cpu_s) == FAMILY_STATS[family]
    for k, v in cpu_s.items():
        np.testing.assert_allclose(gpu_s[k], v, rtol=1e-4, err_msg=k)
    for name, want in cpu_g.items():
        err = (gpu_g[name] - want).abs().max().item()
        assert torch.isfinite(gpu_g[name]).all(), name
        assert err <= 1e-2 * want.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILY_TRAIN))
def test_cuda_pdf_family_train_forward_takes_no_plain_version(
        cuda_device, family, monkeypatch):
    """NeRFPDF and NeuSPDF `train_forward` on the card launch K1 and K2
    FAMILY_TRAIN's times; no KNN plain version runs, and the plain
    skip-MLP runs only as the recompute of K1's backward: in the forward
    once for NeuS-PDF (inside the observed-space normal), never for
    NeRF-PDF, and once more a K1 call in the backward."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
                 "knn_blend_blocked_plain", "knn_blend_celled_plain",
                 "_select_blend"):
        monkeypatch.setattr(knn, name, refuse)
    plain_calls = []
    plain = k1.skip_mlp_plain
    monkeypatch.setattr(k1, "skip_mlp_plain",
                        lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    cfg, state, batch = pdf_step_inputs(family=family)
    trainer = pdf_trainer(cfg, state, cuda_device)
    (n_k1, n_k2), n_plain = FAMILY_TRAIN[family]
    before = (k1.skip_mlp.launches, knn.knn_blend.launches)
    loss, _, _ = trainer.loss({k: v[0] for k, v in batch.items()})
    assert (k1.skip_mlp.launches - before[0],
            knn.knn_blend.launches - before[1]) == (n_k1, n_k2)
    assert len(plain_calls) == n_plain
    loss.backward()
    assert k1.skip_mlp.launches - before[0] == n_k1
    assert len(plain_calls) == n_plain + n_k1
    assert all(torch.isfinite(p.grad).all()
               for p in trainer.model.parameters() if p.grad is not None)


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

    for name in ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
                 "knn_blend_blocked_plain", "knn_blend_celled_plain",
                 "_select_blend"):
        monkeypatch.setattr(knn, name, refuse)
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_case(300, 700, 24, 7))
    knn.knn_blend(src, ref, vals)
    knn.min_dist(src, ref)
    knn.kth_distance(src, ref)
    packed, margin, bounds = knn.build_pdist_payload(ref, res=16)
    d5_packed, _ = knn.build_d5_payload(ref, res=16)
    frame = {"d5_packed": d5_packed, "pdist_bounds": bounds}
    knn.knn_blend_blocked(src, grid_d5_upper(src, frame),
                          *knn.build_knn_blocks(ref, vals))
    payload, _ = knn.build_cell_knn(ref, vals, res=(8, 8, 8), cap=256)
    knn.knn_blend_celled(src, *(payload[k] for k in CELL_KEYS))
    torch.cuda.synchronize()
    assert packed.shape == (15, 15, 15, 8) and packed.is_cuda
    assert d5_packed.shape == (15, 15, 15, 8) and d5_packed.is_cuda


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
    with pytest.raises(ValueError):
        knn.kth_distance(src, ref[:4])  # M < k
    with pytest.raises(ValueError):
        knn.kth_distance(src, ref, k=9)  # past the kernel's templates
    blocks = knn.build_knn_blocks(ref, vals)
    d5ub = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):
        knn.knn_blend_blocked(src, d5ub[:8], *blocks)
    with pytest.raises(ValueError, match="whole blocks"):
        knn.knn_blend_blocked(src, d5ub, *blocks[:2], blocks[2].repeat(3, 1))
    with pytest.raises(ValueError, match="at most 1024"):
        knn.knn_blend_blocked(src, d5ub, blocks[0].repeat(16, 1),
                              blocks[1].repeat(16, 1), blocks[2])
    payload, _ = knn.build_cell_knn(ref, vals, res=(8, 8, 8), cap=64)
    lists = [payload[k] for k in CELL_KEYS]
    with pytest.raises(ValueError):
        knn.knn_blend_celled(src, *lists[:2], lists[2].long(), lists[3])
    with pytest.raises(ValueError):
        knn.knn_blend_celled(src.double(), *lists)


# M: fewer vertices than a 128-vertex block and one past it (K5's last
# block then holds 123 or 127 pads), one past a 1024-vertex tile, SMPL's
CULL_M = [5, 129, 1025, 6890]
CELL_KEYS = ("cknn_verts", "cknn_vals", "cknn_lut", "cknn_bounds")


@pytest.mark.cuda
@pytest.mark.parametrize("m", CULL_M)
def test_cuda_kth_distance_matches_plain(cuda_device, m):
    src, ref, _ = (torch.tensor(a, device=cuda_device)
                   for a in knn_case(1001, m, 1, 9, dup=min(3, m - 1)))
    before = knn.kth_distance.launches
    got = knn.kth_distance(src, ref)
    torch.cuda.synchronize()
    assert knn.kth_distance.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  knn.kth_distance_plain(src, ref).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", CULL_M)
def test_cuda_knn_blend_blocked_matches_plain(cuda_device, m):
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_case(1003, m, 24, 10))
    blocks = knn.build_knn_blocks(ref, vals)
    packed, bounds = knn.build_d5_payload(ref, res=16)
    d5ub = grid_d5_upper(src, {"d5_packed": packed, "pdist_bounds": bounds})
    before = knn.knn_blend_blocked.launches
    got_v, got_d = knn.knn_blend_blocked(src, d5ub, *blocks)
    torch.cuda.synchronize()
    assert knn.knn_blend_blocked.launches == before + 1
    ref_v, ref_d = knn.knn_blend_blocked_plain(src, d5ub, *blocks)
    np.testing.assert_array_equal(got_v.cpu().numpy(), ref_v.cpu().numpy())
    np.testing.assert_array_equal(got_d.cpu().numpy(), ref_d.cpu().numpy())
    # the bound is certified and this cloud has no ties: K2's result
    flat_v, flat_d = knn.knn_blend(src, ref, vals)
    np.testing.assert_array_equal(got_v.cpu().numpy(), flat_v.cpu().numpy())
    np.testing.assert_array_equal(got_d.cpu().numpy(), flat_d.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", CULL_M)
def test_cuda_knn_blend_celled_matches_plain(cuda_device, m):
    """A spherical shell of vertices: the cells inside it route to the
    fallback slot, and the queries at its centre use it."""
    src, ref, vals = knn_case(997, m, 24, 11)
    ref = 0.5 * ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    src[:40] = np.random.RandomState(12).normal(0, 0.02, (40, 3))
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in (src, ref, vals))
    payload, _ = knn.build_cell_knn(ref, vals, res=(8, 8, 8), cap=1024)
    lists = [payload[k] for k in CELL_KEYS]
    n_slots = lists[0].shape[0]
    assert int((knn.cell_slots(src, *lists[2:]) == n_slots - 1).sum()) >= 40
    before = knn.knn_blend_celled.launches
    got_v, got_d = knn.knn_blend_celled(src, *lists)
    torch.cuda.synchronize()
    assert knn.knn_blend_celled.launches == before + 1
    ref_v, ref_d = knn.knn_blend_celled_plain(src, *lists)
    np.testing.assert_array_equal(got_v.cpu().numpy(), ref_v.cpu().numpy())
    np.testing.assert_array_equal(got_d.cpu().numpy(), ref_d.cpu().numpy())


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_knn_blend_adversarial(cuda_device, kind, k):
    """tests/knn_cases.py's cases at SMPL's 6890 vertices (resident in
    shared memory), 1001 queries: no multiple of a warp or of any block
    size the launch picks."""
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_inputs(kind, 1001, 6890, 24, 21))
    before = knn.knn_blend.launches
    got = knn.knn_blend(src, ref, vals, k=k)
    torch.cuda.synchronize()
    assert knn.knn_blend.launches == before + 1
    assert_bits_equal(got, knn.knn_blend_plain(src, ref, vals, k=k))


@pytest.mark.cuda
def test_cuda_knn_blend_beyond_shared_memory(cuda_device):
    """20,000 vertices (320 KB as float4) do not fit a block's shared
    memory: the kernel walks them in global memory."""
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_inputs("duplicates", 777, 20000, 5, 22))
    got = knn.knn_blend(src, ref, vals)
    torch.cuda.synchronize()
    assert_bits_equal(got, knn.knn_blend_plain(src, ref, vals))


@pytest.mark.cuda
def test_cuda_knn_layouts_built_once_per_version(cuda_device):
    """K2 and K5 build their vertex layouts on a frame's first call and
    reuse them for the rest, as the engine's 64 calls of a frame do."""
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_inputs("cloud", 300, 700, 24, 23))
    builds = knn._sweep_layout.builds
    for _ in range(3):
        knn.knn_blend(src, ref, vals)
    assert knn._sweep_layout.builds == builds + 1
    ref.add_(0.01)
    moved = knn.knn_blend(src, ref, vals)
    assert knn._sweep_layout.builds == builds + 2
    assert_bits_equal(moved, knn.knn_blend_plain(src, ref, vals))
    blocks = knn.build_knn_blocks(ref, vals)
    d5ub = torch.full((300,), 10.0, device=cuda_device)
    builds = knn._blocked_layout.builds
    for _ in range(3):
        knn.knn_blend_blocked(src, d5ub, *blocks)
    assert knn._blocked_layout.builds == builds + 1
    # K3 and K4 share one layout: a frame's K4 and K3 build it once
    builds = knn._grid_layout.builds
    knn.kth_distance(src, ref)
    knn.min_dist(src, ref)
    knn.min_dist(src, ref)
    assert knn._grid_layout.builds == builds + 1
    ref.mul_(1.5)
    moved = knn.min_dist(src, ref)
    assert knn._grid_layout.builds == builds + 2
    np.testing.assert_array_equal(moved.cpu().numpy(),
                                  knn.min_dist_plain(src, ref).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind,radius", BLOCKED_CASES)
def test_cuda_knn_blend_blocked_adversarial(cuda_device, kind, radius, k):
    """K5 on tests/knn_cases.py's cases: 1003 queries (4 tiles, the last
    ragged), 2000 vertices (16 blocks, the last with 48 pads at 1e6);
    kept lists empty (the NaN query's tile, and radius 0 away from the
    cloud), of odd length and full (radius 10)."""
    src, ref, vals, d5ub = (torch.tensor(a, device=cuda_device) for a in
                            blocked_inputs(kind, radius, 1003, 2000, 24, k, 24))
    blocks = knn.build_knn_blocks(ref, vals)
    keep = knn.blocked_cull(*knn.blocked_tiles(src, d5ub, blocks[2])[2:])
    lengths = keep.sum(1)
    if radius == "zero":  # three tiles away, the ragged one at its pads
        assert bool((lengths == 0).any()) and bool((lengths % 2 == 1).any())
    elif radius == "huge":
        assert bool(keep.all())
    before = knn.knn_blend_blocked.launches
    got = knn.knn_blend_blocked(src, d5ub, *blocks, k=k)
    torch.cuda.synchronize()
    assert knn.knn_blend_blocked.launches == before + 1
    assert_bits_equal(got, knn.knn_blend_blocked_plain(src, d5ub, *blocks, k=k))


def grid_plain(src, ref, k):
    return (knn.min_dist_plain(src, ref) if k == 1
            else knn.kth_distance_plain(src, ref, k))


def grid_call(src, ref, k):
    """K3 for k = 1, else K4; checks that it launched once."""
    wrapper = knn.min_dist if k == 1 else knn.kth_distance
    before = wrapper.launches
    out = knn.min_dist(src, ref) if k == 1 else knn.kth_distance(src, ref, k)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_grid_dist_adversarial(cuda_device, kind, k):
    """K3 and K4 on tests/knn_cases.py's cases: 1001 queries (no whole
    number of warps or blocks), 6890 vertices (216 runs, the last with 22
    pads at +inf)."""
    src, ref, _ = (torch.tensor(a, device=cuda_device)
                   for a in knn_inputs(kind, 1001, 6890, 1, 25))
    np.testing.assert_array_equal(grid_call(src, ref, k).cpu().numpy(),
                                  grid_plain(src, ref, k).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_cuda_grid_dist_on_a_capsule_frame(cuda_device, k):
    """The engine's 96^3 grid builds over capsule frame 0's posed
    vertices, and the counting build's counts of the same walk."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_dataset

    cfg = load_config("configs/synthetic_sdf_pdf.yaml", [], run_type="evaluate")
    cfg.eval = True
    pverts = torch.as_tensor(make_dataset(cfg, "test")[0]["pvertices"],
                             device=cuda_device)
    nodes, _, _ = knn.pdist_grid_nodes(pverts, 96)
    got = grid_call(nodes, pverts, k)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  grid_plain(nodes, pverts, k).cpu().numpy())
    ranked, swept, tested, full = knn.grid_dist_counts(nodes, pverts, k).tolist()
    assert 0 < swept <= ranked <= (nodes.shape[0] // 32) * 216
    assert 0 < full <= tested < 0.2 * nodes.shape[0] * pverts.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("m", [20000, 60000])
def test_cuda_grid_dist_beyond_smpl(cuda_device, m, k):
    """More vertices than SMPL's: 625 runs, and 1875, whose keys (60 KB a
    block) need the opt-in to more than 48 KB of shared memory."""
    src, ref, _ = (torch.tensor(a, device=cuda_device)
                   for a in knn_inputs("duplicates", 777, m, 1, 26))
    np.testing.assert_array_equal(grid_call(src, ref, k).cpu().numpy(),
                                  grid_plain(src, ref, k).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m", [("cloud", 6890), ("duplicates", 6890),
                                    ("plane", 1001), ("cloud", 5),
                                    ("cloud", 60000)])
def test_cuda_grid_layout_matches_torch_ops(cuda_device, kind, m):
    """The layout the wrappers build on the card in three launches is
    `grid_layout`'s, bit for bit: the same Morton order, pads and boxes."""
    _, ref, _ = (torch.tensor(a, device=cuda_device)
                 for a in knn_inputs(kind, 1, m, 1, 28))
    for got, want in zip(knn._grid_layout_cuda(ref), knn.grid_layout(ref)):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_grid_dist_counts_take_k_1_or_5(cuda_device):
    src, ref, _ = (torch.tensor(a, device=cuda_device)
                   for a in knn_inputs("cloud", 100, 700, 1, 27))
    before = (knn.min_dist.launches, knn.kth_distance.launches)
    for k in (1, 5):
        ranked, swept, tested, full = knn.grid_dist_counts(src, ref, k).tolist()
        assert 0 < swept <= ranked and 0 < full <= tested <= 100 * 704
    assert (knn.min_dist.launches, knn.kth_distance.launches) == before
    with pytest.raises(ValueError, match="k = 1 or 5"):
        knn.grid_dist_counts(src, ref, 3)


def pdf_family_item(family, device):
    """Test item 0 of configs/synthetic_<family>.yaml rendered by the
    port's engine on `device` (eval tiles of 1024 rays, a 24^3 distance
    grid) from the tracked weights: the maps, the candidate and survivor
    counts, and the launches of K1, K2 and K3 in the render."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config

    cfg = load_config(f"configs/synthetic_{family}.yaml",
                      ["eval_tile", "1024", "knn_grid_res", "24"],
                      run_type="evaluate")
    cfg.eval = True
    eng = engine.Engine(cfg, device)
    eng.load_params()
    before = (k1.skip_mlp.launches, knn.knn_blend.launches,
              knn.min_dist.launches)
    out, _ = eng.render_item(engine.make_dataset(cfg, "test")[0])
    launches = tuple(n - b for n, b in zip(
        (k1.skip_mlp.launches, knn.knn_blend.launches, knn.min_dist.launches),
        before))
    return out, dict(eng.stats), launches


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["nerf_pdf", "neus_pdf"])
def test_cuda_pdf_family_item_matches_cpu(cuda_device, family, monkeypatch):
    """A NeRF-PDF and a NeuS-PDF eval item on the card against the CPU:
    the same candidates and survivors (K2 and K3 are bit-equal to their
    plain versions), the maps within 1e-4 (K1's 3xTF32 and cuBLAS against
    the CPU's float32), K1 and K2 launched once a tile and K3 once for
    the frame on the card, none on the CPU, and no plain KNN version
    reached by a CUDA tensor."""
    cpu_out, cpu_stats, cpu_n = pdf_family_item(family, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
                 "knn_blend_blocked_plain", "knn_blend_celled_plain",
                 "_select_blend"):
        monkeypatch.setattr(knn, name, refuse)
    out, stats, n = pdf_family_item(family, cuda_device)
    tiles = stats["tiles"]
    assert cpu_n == (0, 0, 0) and n == (tiles, tiles, 1) and tiles > 1
    assert stats == cpu_stats
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5


ANIM_CFG = "configs/synthetic_novel_pose.yaml"
ANIM_CKPT = "data/trained_model/deform/synthetic_2f_anim/latest.flax"


@pytest.mark.cuda
def test_cuda_animation_step_matches_cpu(cuda_device, monkeypatch):
    """One AniNeRF stage-2 step (train/animation.py, 4096 seeded points
    a branch, the tracked stage-2 weights) on the card and on the CPU,
    on the same points: loss and stats, `novel_pose_bw`'s gradient leaf
    by leaf, no gradient elsewhere, and K1 launched six times on the
    card (the novel-pose field, the frozen field and the density trunk
    in each branch), none on the CPU."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train import animation
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    n = 4096
    units = np.random.RandomState(0).rand(2, n, 3).astype(np.float32)
    calls = []

    def fixed(gen, bounds, count):
        u = torch.tensor(units[len(calls) % 2], device=bounds.device)
        calls.append(count)
        return bounds[0] + (bounds[1] - bounds[0]) * u

    monkeypatch.setattr(animation, "uniform_box_points", fixed)
    cfg = load_config(ANIM_CFG, ["aninerf_animation", "True",
                                 "n_anim_samples", str(n), "N_rand", "64"])
    state = aninerf_state_dict(read_checkpoint(ANIM_CKPT)["params"])
    ds = engine.make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[4], 64)])
    results = []
    for device in ("cpu", cuda_device):
        model = engine.make_model(cfg)
        model.load_state_dict(state)
        trainer = animation.AnimationTrainer(cfg, model.to(device), device)
        before = k1.skip_mlp.launches
        loss, stats, _ = trainer.loss({k: v[0] for k, v in batch.items()})
        loss.backward()
        results.append(({k: float(v.detach()) for k, v in stats.items()},
                        {name: None if p.grad is None else p.grad.cpu()
                         for name, p in model.named_parameters()},
                        k1.skip_mlp.launches - before))
    (cpu_s, cpu_g, cpu_n), (gpu_s, gpu_g, gpu_n) = results
    assert cpu_n == 0 and gpu_n == 6 and calls == [n] * 4
    for k, v in cpu_s.items():
        np.testing.assert_allclose(gpu_s[k], v, rtol=1e-4, err_msg=k)
    for name, want in cpu_g.items():
        assert (want is None) == (gpu_g[name] is None), name
        assert (want is None) != name.startswith("novel_pose_bw."), name
        if want is not None:
            err = (gpu_g[name] - want).abs().max().item()
            assert err <= 1e-2 * want.abs().max().item(), (name, err)


def novel_pose_item(device):
    """Test item 0 of the novel-pose split (frame 2, view 3) rendered
    from the tracked stage-2 weights with `test_novel_pose` on `device`
    (eval tiles of 1024 rays): the maps, the counts and K1's launches."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config

    cfg = load_config(ANIM_CFG, ["test_novel_pose", "True", "exp_name",
                                 "synthetic_2f_anim", "eval_tile", "1024"],
                      run_type="evaluate")
    cfg.eval = True
    eng = engine.Engine(cfg, device)
    eng.load_params()
    before = k1.skip_mlp.launches
    out, _ = eng.render_item(engine.make_dataset(cfg, "test")[0])
    return out, dict(eng.stats), k1.skip_mlp.launches - before


@pytest.mark.cuda
def test_cuda_novel_pose_item_matches_cpu(cuda_device):
    """A novel-pose eval item on the card against the CPU: the same
    candidates and survivors, the maps within 1e-4 (K1's 3xTF32 against
    the CPU's float32), and K1 twice a tile on the card (the novel-pose
    field and the NeRF trunk), never on the CPU."""
    cpu_out, cpu_stats, cpu_n = novel_pose_item("cpu")
    out, stats, n = novel_pose_item(cuda_device)
    assert cpu_n == 0 and n == 2 * stats["tiles"] and stats["tiles"] > 1
    assert stats == cpu_stats
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5


def camera_item(root, device):
    """Test item 0 (frame 0, view 3) of a distorted copy of the synthetic
    human (data/distorted_copy.py: lens distortion, half-size masks) read
    at ratio 0.5, rendered from the synthetic_2f weights on `device`
    (eval tiles of 1024 rays): the maps, the counts and K1's launches."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.distorted_copy import config_opts

    cfg = load_config(ANIM_CFG, config_opts(root) + ["eval_tile", "1024"],
                      run_type="evaluate")
    cfg.eval = True
    eng = engine.Engine(cfg, device)
    eng.load_params()
    item = engine.make_dataset(cfg, "test")[0]
    assert (int(item["H"]), int(item["W"])) == (64, 64)
    before = k1.skip_mlp.launches
    out, _ = eng.render_item(item)
    return out, dict(eng.stats), k1.skip_mlp.launches - before


@pytest.mark.cuda
def test_cuda_camera_item_matches_cpu(cuda_device, tmp_path):
    """An AniNeRF eval item of the distorted copy at ratio 0.5 on the card
    against the CPU: the same candidates and survivors, the maps within
    1e-4 (K1's 3xTF32 against the CPU's float32), and K1 twice a tile on
    the card (the blend-weight field and the NeRF trunk), never on the
    CPU."""
    from animatable_nerf_tpu_torch.data.distorted_copy import write_distorted_copy

    root = write_distorted_copy("data/synthetic/human", str(tmp_path / "copy"))
    cpu_out, cpu_stats, cpu_n = camera_item(root, "cpu")
    out, stats, n = camera_item(root, cuda_device)
    assert cpu_n == 0 and n == 2 * stats["tiles"] and stats["tiles"] > 1
    assert stats == cpu_stats
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_knn_blend_indices_match_plain(cuda_device, kind, k):
    """K2 with its index output: the blend, the weighted distance and the
    k selected vertices bit-equal to the plain version's, one launch;
    without it, the launch's outputs unchanged (bit-equal too)."""
    src, ref, vals = (torch.tensor(a, device=cuda_device)
                      for a in knn_inputs(kind, 1001, 6890, 24, 23))
    before = knn.knn_blend.launches
    got = knn.knn_blend(src, ref, vals, k=k, indices=True)
    torch.cuda.synchronize()
    assert knn.knn_blend.launches == before + 1
    assert got[2].dtype == torch.int32 and got[2].shape == (1001, k)
    assert_bits_equal(got, knn.knn_blend_plain(src, ref, vals, k=k,
                                               indices=True))
    assert_bits_equal(knn.knn_blend(src, ref, vals, k=k), got[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cloud", "on_vertices", "duplicates"])
def test_cuda_knn_blend_gradient_matches_cpu(cuda_device, kind):
    """K2's differentiable form (`knn_blend_differentiable`) on the card
    against the CPU: values within 1e-6 (the CPU's float32 divisions and
    square roots may round apart from the card's by an ulp), the
    gradient with respect to the queries and the values (the plain vjp
    over the k selected vertices on both) within 1e-5 of each one's
    scale, finite at queries on a vertex; one launch on the card, none
    in the backward."""
    arrays = knn_inputs(kind, 1001, 6890, 24, 24)
    rng = np.random.RandomState(25)
    cot = (rng.randn(1001, 24).astype(np.float32),
           rng.randn(1001, 1).astype(np.float32))
    results = []
    for device in ("cpu", cuda_device):
        src, ref, vals = (torch.tensor(a, device=device) for a in arrays)
        src.requires_grad_(True)
        vals.requires_grad_(True)
        before = knn.knn_blend.launches
        out = knn.knn_blend_differentiable(src, ref, vals)
        grads = torch.autograd.grad(
            out, (src, vals), tuple(torch.tensor(c, device=device)
                                    for c in cot))
        results.append(([t.detach().cpu() for t in out],
                         [g.cpu() for g in grads],
                         knn.knn_blend.launches - before))
    (cpu_out, cpu_g, cpu_n), (out, grads, n) = results
    assert (cpu_n, n) == (0, 1)
    for got, want in zip(out, cpu_out):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
    for got, want in zip(grads, cpu_g):
        finite = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), finite)
        err = (got[finite] - want[finite]).abs().max().item()
        assert err <= 1e-5 * max(1.0, want[finite].abs().max().item()), err


ALIGNED_FAMILIES = ("lbw", "pbw", "smpl", "lbw_pdf")
# per family on the card: K1's launches an eval tile, and (K1, K2) a
# train step's forward
ALIGNED_LAUNCHES = {"lbw": (1, (2, 2)), "pbw": (1, (2, 2)),
                    "smpl": (0, (0, 1)), "lbw_pdf": (2, (3, 2))}


def aligned_model(family, cfg):
    """configs/synthetic_aligned_<family>.yaml's model on the composed
    weights (compat/compose.py)."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.compat.compose import compose_aligned
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec

    model = engine.make_model(cfg)
    model.load_state_dict(param_codec(model)[0](compose_aligned(family)),
                          strict=True)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("family", ALIGNED_FAMILIES)
def test_cuda_aligned_item_and_step_match_cpu(cuda_device, family,
                                              monkeypatch):
    """An aligned eval item (item 0, eval tiles of 1024 rays, a 24^3
    distance grid) and a train step (64 rays of 16 samples) on the
    composed weights, on the card against the CPU: the same candidates
    and survivors and the maps within 1e-4; the step's loss and stats
    within 1e-4, the whole gradient within 1e-3 of its L2 norm and each
    leaf within 1e-2 of its largest entry, or, on a leaf float32 cannot
    resolve, within twice the move of the CPU's own gradient when the
    rays' directions move by one ulp (LBW's `bw_linears.0.bias` here,
    tests/test_torch_train_aligned.py);
    K1, K2 and K3 launched as ALIGNED_LAUNCHES says on the card, never on
    the CPU, and no plain KNN version reached by a CUDA tensor."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train.trainer import (
        Trainer, collate_rays, stack_batch)

    cfg_file = f"configs/synthetic_aligned_{family}.yaml"
    eval_cfg = load_config(cfg_file, ["eval_tile", "1024", "knn_grid_res",
                                      "24"], run_type="evaluate")
    eval_cfg.eval = True
    item = engine.make_dataset(eval_cfg, "test")[0]
    cfg = load_config(cfg_file, ["N_rand", "64", "N_samples", "16",
                                 "perturb", "0"])
    ds = engine.make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = {k: v[0] for k, v in stack_batch([collate_rays(ds[4], 64)]).items()}

    def counts():
        return (k1.skip_mlp.launches, knn.knn_blend.launches,
                knn.min_dist.launches)

    results = []
    for device in ("cpu", cuda_device):
        if device != "cpu":
            def refuse(*args, **kwargs):
                raise AssertionError("a CUDA tensor reached a plain version")

            for name in ("knn_blend_plain", "min_dist_plain",
                         "kth_distance_plain", "_select_blend"):
                monkeypatch.setattr(knn, name, refuse)
        eng = engine.Engine(eval_cfg, device)
        eng.model.load_state_dict(aligned_model(family, eval_cfg).state_dict())
        before = counts()
        out, _ = eng.render_item(item)
        eval_n = tuple(a - b for a, b in zip(counts(), before))
        trainer = Trainer(cfg, aligned_model(family, cfg).to(device), device)
        before = counts()
        loss, stats, _ = trainer.loss(batch)
        step_n = tuple(a - b for a, b in zip(counts(), before))
        loss.backward()
        results.append((out, dict(eng.stats), eval_n,
                        {k: float(v.detach()) for k, v in stats.items()},
                        {n: p.grad.cpu()
                         for n, p in trainer.model.named_parameters()
                         if p.grad is not None}, step_n))
    monkeypatch.undo()  # the CPU's plain versions again, for `moved`
    (cpu_out, cpu_stats, cpu_en, cpu_s, cpu_g, cpu_sn), (
        out, stats, en, s, g, sn) = results
    tiles = stats["tiles"]
    per_tile, (step_k1, step_k2) = ALIGNED_LAUNCHES[family]
    assert cpu_en == (0, 0, 0) and cpu_sn == (0, 0, 0)
    assert en == (per_tile * tiles, tiles, 1) and tiles > 1
    assert sn == (step_k1, step_k2, 0)
    assert stats == cpu_stats
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5
    for k, v in cpu_s.items():
        np.testing.assert_allclose(s[k], v, rtol=1e-4, err_msg=k)
    assert set(g) == set(cpu_g)
    moved = None
    for name, want in cpu_g.items():
        err = (g[name] - want).abs().max().item()
        assert torch.isfinite(g[name]).all(), name
        if err > 1e-2 * want.abs().max().item():
            # a leaf float32 cannot resolve: the CPU's own gradient of it
            # moves as far when the rays' directions move by one ulp
            if moved is None:
                trainer = Trainer(cfg, aligned_model(family, cfg), "cpu")
                trainer.loss(dict(batch, ray_d=np.nextafter(
                    batch["ray_d"], np.float32(np.inf))))[0].backward()
                moved = {n: p.grad for n, p in
                         trainer.model.named_parameters() if p.grad is not None}
            shift = (moved[name] - want).abs().max().item()
            assert shift >= err / 2, (name, err, shift)
    l2 = (sum(float(((g[n] - w).double() ** 2).sum()) for n, w in cpu_g.items())
          / sum(float((w.double() ** 2).sum()) for w in cpu_g.values())) ** 0.5
    assert l2 <= 1e-3, l2


@pytest.mark.cuda
def test_cuda_min_dist_on_a_tile_without_the_grid(cuda_device, monkeypatch):
    """Pass 1 without the distance grid (SDF-PDF, knn_grid_res 0, eval
    tiles of 1024 rays): K3 on one tile's posed points, 64 samples of
    each ray in ray order, most far outside the body shell, bit-equal to
    its plain version; the engine's render of the item launches K3 once
    a tile, builds its vertex layout once for the frame, reaches no
    plain KNN version, and keeps the survivors of the grid render."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
    from animatable_nerf_tpu_torch.core.sampling import (
        stratified_z_vals, z_vals_to_pts)

    opts = ["eval_tile", "1024"]
    cfg = load_config("configs/synthetic_sdf_pdf.yaml",
                      opts + ["knn_grid_res", "0"], run_type="evaluate")
    cfg.eval = True
    eng = engine.Engine(cfg, cuda_device)
    eng.load_params()
    item = engine.make_dataset(cfg, "test")[0]
    frame = eng._device_frame(item)
    assert "pdist_packed" not in frame
    rays = {k: torch.as_tensor(np.asarray(item[k])[:1024], device=cuda_device)
            for k in ("ray_o", "ray_d", "near", "far")}
    z = stratified_z_vals(rays["near"], rays["far"], 64)
    pose = world_points_to_pose_points(
        z_vals_to_pts(rays["ray_o"], rays["ray_d"], z).reshape(-1, 3),
        frame["R"], frame["Th"]).contiguous()
    np.testing.assert_array_equal(
        knn.min_dist(pose, frame["pvertices"]).cpu().numpy(),
        knn.min_dist_plain(pose, frame["pvertices"]).cpu().numpy())

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    eng.clear_frame_cache()
    launches, builds = knn.min_dist.launches, knn._grid_layout.builds
    with monkeypatch.context() as m:
        for name in ("knn_blend_plain", "min_dist_plain", "_select_blend"):
            m.setattr(knn, name, refuse)
        out, _ = eng.render_item(item)
    tiles = eng.stats["tiles"]
    assert knn.min_dist.launches - launches == tiles > 1
    assert knn._grid_layout.builds - builds == 1
    grid = engine.Engine(load_config("configs/synthetic_sdf_pdf.yaml",
                                     opts + ["knn_grid_res", "24"],
                                     run_type="evaluate"), cuda_device)
    grid.load_params()
    want, _ = grid.render_item(item)
    assert eng.stats["n_survivors"] == grid.stats["n_survivors"]
    assert eng.stats["n_candidates"] < grid.stats["n_candidates"]
    for k in ("rgb_map", "acc_map", "depth_map"):
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lbw", "lbw_pdf"])
def test_cuda_aligned_novel_pose_item_and_stage2_step_match_cpu(
        cuda_device, family, monkeypatch):
    """An aligned family's novel-pose item (item 0 of
    configs/synthetic_aligned_<f>_novel_pose.yaml, eval tiles of 1024
    rays, a 24^3 distance grid) and a stage-2 step (4096 seeded points a
    branch) on the composed novel-pose weights, on the card against the
    CPU: the same candidates and survivors and the maps within 1e-4;
    the step's loss and stats within 1e-4, a gradient for
    `novel_pose_bw` alone, the whole of it within 1e-3 of its L2 norm
    and each leaf within 1e-2 of its largest entry; on the card K1 once
    (LBW) or twice (LBWPDF) a tile, K2 once a tile, K3 once, and K1 and
    K2 four times a step; none on the CPU."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.compat.compose import compose_novel_pose
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train import animation
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    n = 4096
    units = np.random.RandomState(0).rand(2, n, 3).astype(np.float32)
    calls = []

    def fixed(gen, bounds, count):
        u = torch.tensor(units[len(calls) % 2], device=bounds.device)
        calls.append(count)
        return bounds[0] + (bounds[1] - bounds[0]) * u

    monkeypatch.setattr(animation, "uniform_box_points", fixed)
    cfg_file = f"configs/synthetic_aligned_{family}_novel_pose.yaml"
    eval_cfg = load_config(cfg_file, ["test_novel_pose", "True", "eval_tile",
                                      "1024", "knn_grid_res", "24"],
                           run_type="evaluate")
    eval_cfg.eval = True
    item = engine.make_dataset(eval_cfg, "test")[0]
    cfg = load_config(cfg_file, ["aninerf_animation", "True",
                                 "n_anim_samples", str(n), "N_rand", "64"])
    ds = engine.make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = {k: v[0] for k, v in stack_batch([collate_rays(ds[4], 64)]).items()}
    params = compose_novel_pose(family)

    def counts():
        return (k1.skip_mlp.launches, knn.knn_blend.launches,
                knn.min_dist.launches)

    results = []
    for device in ("cpu", cuda_device):
        eng = engine.Engine(eval_cfg, device)
        eng.load_params(params)
        before = counts()
        out, _ = eng.render_item(item)
        eval_n = tuple(a - b for a, b in zip(counts(), before))
        model = engine.make_model(cfg)
        model.load_state_dict(param_codec(model)[0](params), strict=True)
        trainer = animation.AnimationTrainer(cfg, model.to(device), device)
        before = counts()
        loss, stats, _ = trainer.loss(batch)
        step_n = tuple(a - b for a, b in zip(counts(), before))
        loss.backward()
        results.append((out, dict(eng.stats), eval_n,
                        {k: float(v.detach()) for k, v in stats.items()},
                        {name: p.grad.cpu() for name, p in
                         model.named_parameters() if p.grad is not None},
                        step_n))
    (cpu_out, cpu_stats, cpu_en, cpu_s, cpu_g, cpu_sn), (
        out, stats, en, s, g, sn) = results
    tiles = stats["tiles"]
    assert cpu_en == cpu_sn == (0, 0, 0) and calls == [n] * 4
    assert en == ({"lbw": 1, "lbw_pdf": 2}[family] * tiles, tiles, 1)
    assert sn == (4, 4, 0) and tiles > 1 and stats == cpu_stats
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.5
    for k, v in cpu_s.items():
        np.testing.assert_allclose(s[k], v, rtol=1e-4, err_msg=k)
    assert set(g) == set(cpu_g) and len(g) == 19
    assert all(name.startswith("novel_pose_bw.") for name in g)
    for name, want in cpu_g.items():
        assert torch.isfinite(g[name]).all(), name
        err = (g[name] - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (name, err)
    l2 = (sum(float(((g[k] - w).double() ** 2).sum()) for k, w in cpu_g.items())
          / sum(float((w.double() ** 2).sum()) for w in cpu_g.values())) ** 0.5
    assert l2 <= 1e-3, l2


# family: (config, mesh dataset opts, K1 launches a sweep tile, K2 a tile)
MESH_CASES = {
    "aninerf": ("configs/synthetic.yaml", [], 2, 0),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml",
                ["test_dataset_module", "lib.datasets.anisdf_mesh_dataset"], 0, 1),
}


# a vertex's move between the card and the CPU, as a share of the voxel
MESH_VERTEX_TOL = 0.02


def mesh_of(family, device, monkeypatch):
    """Frame 0's mesh at voxel 0.05, swept in tiles of 2048 points, on
    `device`: (the mesh, its stats, K1's and K2's launches)."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config

    cfg_file, opts, _, _ = MESH_CASES[family]
    cfg = load_config(cfg_file, ["vis_posed_mesh", "True", "voxel_size",
                                 "[0.05, 0.05, 0.05]", *opts],
                      run_type="visualize")
    monkeypatch.setattr(engine, "SWEEP_TILE", 2048)
    eng = engine.Engine(cfg, device)
    eng.load_params()
    item = engine.make_dataset(cfg, "test")[0]
    before = (k1.skip_mlp.launches, knn.knn_blend.launches)
    mesh = eng.extract_mesh(item)
    return mesh, dict(eng.mesh_stats), (k1.skip_mlp.launches - before[0],
                                        knn.knn_blend.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(MESH_CASES))
def test_cuda_mesh_matches_cpu(cuda_device, family, monkeypatch):
    """`Engine.extract_mesh` on the card against the CPU: the same
    vertex and face counts and faces, the canonical and posed vertices
    within MESH_VERTEX_TOL of a grid edge (K1's 3xTF32 against the CPU's
    float32 moves a vertex along its edge by the field's error over the
    field's change along the edge, which is small where the level set
    grazes the edge: 3 of AniNeRF's 17,634 vertices moved by 2.3e-4 m,
    0.46% of the voxel, on the H100); K1 and K2 launched a sweep
    tile as MESH_CASES says (and by the SDF re-pose: K1 twice, K2 once),
    never on the CPU."""
    cpu_mesh, cpu_stats, cpu_n = mesh_of(family, "cpu", monkeypatch)
    mesh, stats, n = mesh_of(family, cuda_device, monkeypatch)
    _, _, k1_tile, k2_tile = MESH_CASES[family]
    repose = (2, 1) if family == "sdf_pdf" else (0, 0)
    assert cpu_n == (0, 0) and stats["tiles"] > 1
    assert n == (k1_tile * stats["tiles"] + repose[0],
                 k2_tile * stats["tiles"] + repose[1])
    assert stats["vertices"] == cpu_stats["vertices"] > 100
    assert stats["faces"] == cpu_stats["faces"]
    np.testing.assert_array_equal(mesh["triangle"], cpu_mesh["triangle"])
    for k in ("vertex", "posed_vertex"):
        np.testing.assert_allclose(mesh[k], cpu_mesh[k], rtol=0,
                                   atol=MESH_VERTEX_TOL * 0.05, err_msg=k)


# family: (config, the opts that select its novel-view dataset)
NOVEL_VIEW_CASES = {
    "aninerf": ("configs/synthetic.yaml", []),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml",
                ["test_dataset_module",
                 "lib.datasets.tpose_pdf_novel_view_dataset"]),
}


def carved_novel_view(family, device):
    """View 1 of a 4-view spiral at ratio 0.5, rendered with the training
    views' carve (eval tiles of 1024 rays) on `device`: the maps, the
    counts, and K1's, K2's and K3's launches."""
    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config

    cfg_file, opts = NOVEL_VIEW_CASES[family]
    cfg = load_config(cfg_file, ["vis_novel_view", "True", "render_views", "4",
                                 "ratio", "0.5", "eval_tile", "1024", *opts],
                      run_type="visualize")
    eng = engine.Engine(cfg, device)
    eng.load_params()
    item = engine.make_dataset(cfg, "test")[1]
    wrappers = (k1.skip_mlp, knn.knn_blend, knn.min_dist)
    before = [w.launches for w in wrappers]
    out, _ = eng.render_item(item, visibility=True)
    return out, dict(eng.stats), tuple(w.launches - b
                                       for w, b in zip(wrappers, before))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(NOVEL_VIEW_CASES))
def test_cuda_carved_novel_view_matches_cpu(cuda_device, family):
    """A novel view carved by the training views' masks on the card
    against the CPU: the same candidates, survivors and carved
    survivors, the maps within 1e-4 (K1's 3xTF32 against the CPU's
    float32), and K1 (twice a tile for AniNeRF, once for SDF-PDF's
    displacement field), K2 once a tile and K3 once a frame (the 96^3
    grid) on the card for SDF-PDF, none of them on the CPU."""
    cpu_out, cpu_stats, cpu_n = carved_novel_view(family, "cpu")
    out, stats, n = carved_novel_view(family, cuda_device)
    tiles = stats["tiles"]
    assert cpu_n == (0, 0, 0) and tiles >= 1
    assert n == ((2 * tiles, 0, 0) if family == "aninerf"
                 else (tiles, tiles, 1))
    assert stats == cpu_stats and 0 < stats["n_carved"] < stats["n_survivors"]
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_allclose(out[k], cpu_out[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert out["acc_map"].max() > 0.1


# the ceiling of NHR's item bound against the CPU, from the CPU's ulp
# controls on record (1.73e-3 on the capsule's test item 0)
NHR_FWD_CEIL = 5e-3


def capsule_frame():
    """Frame 0 of the capsule root: its world vertices and camera 3."""
    root = "data/synthetic/capsule"
    cams = np.load(f"{root}/annots.npy", allow_pickle=True).item()["cams"]
    verts = np.load(f"{root}/vertices/0.npy").astype(np.float32)
    K = np.asarray(cams["K"][3], np.float32)
    R = np.asarray(cams["R"][3], np.float32)
    T = (np.asarray(cams["T"][3]) / 1000.0).astype(np.float32)
    return verts, K, R, T


@pytest.mark.cuda
def test_cuda_point_ops_match_cpu(cuda_device):
    """NHR's point ops at its first level on the capsule's 6890 vertices
    (FPS to 4096, both ball queries, 3-NN back): the same indices on the
    card as on the CPU (the squared distances are fused multiply-adds
    on both, ops/pointnet2.py), the 3-NN distances within 1e-6."""
    from animatable_nerf_tpu_torch.ops import pointnet2 as pn2

    verts = torch.from_numpy(capsule_frame()[0])[None]
    out = {}
    for dev in ("cpu", cuda_device):
        xyz = verts.to(dev)
        idx = pn2.furthest_point_sample(xyz, 4096)
        centres = pn2.gather_points(xyz, idx)
        balls = [pn2.ball_query(r, n, xyz, centres) for r, n in ((0.1, 16),
                                                                 (0.5, 32))]
        dist, nn = pn2.three_nn(xyz, centres)
        out[str(dev)] = [t.cpu() for t in (idx, *balls, dist, nn)]
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    for a, b in zip(cpu[:3] + cpu[4:], gpu[:3] + gpu[4:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(gpu[3], cpu[3], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_splat_matches_cpu(cuda_device):
    """The capsule's vertices splatted at 1024x1024 (K scaled by 8),
    radius 2: the same winners but on at most 4 pixels, the features,
    depth and their gradient equal elsewhere."""
    from animatable_nerf_tpu_torch.ops.rasterize import rasterize_points

    verts, K, R, T = capsule_frame()
    K = K.copy()
    K[:2] *= 8
    feats = np.random.RandomState(0).randn(len(verts), 6).astype(np.float32)
    w = np.random.RandomState(1).randn(1024, 1024, 6).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        f = torch.tensor(feats, device=dev, requires_grad=True)
        ras = rasterize_points(*(torch.as_tensor(a, device=dev)
                                 for a in (verts,)), f,
                               *(torch.as_tensor(a, device=dev) for a in (K, R, T)),
                               1024, 1024, splat_radius=2)
        out[str(dev)] = ({k: v.detach().cpu() for k, v in ras.items()}, f, ras)
    (cpu, cf, cras), (gpu, gf, gras) = out["cpu"], out[str(cuda_device)]
    same = cpu["index"] == gpu["index"]
    assert int((~same).sum()) <= 4 and int(cpu["mask"].sum()) > 10000
    for k in ("feature_map", "depth"):
        assert torch.equal(cpu[k][same], gpu[k][same]), k
    keep = torch.from_numpy(w) * same[..., None]
    (cras["feature_map"] * keep).sum().backward()
    (gras["feature_map"] * keep.to(cuda_device)).sum().backward()
    torch.testing.assert_close(gf.grad.cpu(), cf.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["nhr", "nt"])
def test_cuda_baseline_forward_matches_cpu(cuda_device, family, tmp_path):
    """A test item of the capsule's baseline copy through NHR or NT at
    full widths from the seeded start: rgb and mask within 1e-4 of the
    CPU's (the same plain PyTorch; cuDNN and the CPU order their sums
    otherwise)."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.baseline_prep import (
        config_opts, write_baseline_copy)
    from animatable_nerf_tpu_torch.device import select_device
    from animatable_nerf_tpu_torch.engine import initial_model, make_dataset

    select_device(cuda_device)  # TF32 off, as the entry points run
    copy = write_baseline_copy("data/synthetic/capsule", str(tmp_path / "c"))
    cfg = load_config(f"configs/synthetic_{family}.yaml", config_opts(copy),
                      run_type="evaluate")
    cfg.eval = True
    item = make_dataset(cfg, "test")[0]

    def forward(dev, it):
        model = initial_model(cfg).to(dev).eval()
        frame = {k: torch.as_tensor(np.asarray(it[k], np.float32), device=dev)
                 for k in model.frame_keys}
        with torch.no_grad():
            o = model(frame)
        return {k: o[k].cpu() for k in ("rgb_map", "mask")}

    cpu, gpu = forward("cpu", item), forward(cuda_device, item)
    tol = 1e-4
    if family == "nhr":
        # PointNet++'s batch norms over a few points double a rounding
        # difference at each level: the bound is at least twice what one
        # ulp of the canonical vertices moves the CPU's own forward, and
        # at most NHR_FWD_CEIL (chip_smoke.py's BASELINE_NHR_FWD_CEIL)
        tpose = np.asarray(item["tpose"], np.float32)
        moved = forward("cpu", {**item, "tpose": np.nextafter(
            tpose, np.float32(np.inf))})
        tol = max(tol, 2 * max(float((moved[k] - cpu[k]).abs().max())
                               for k in cpu))
        assert tol <= NHR_FWD_CEIL, f"the CPU's ulp control gives {tol}"
    for k, v in cpu.items():
        torch.testing.assert_close(gpu[k], v, rtol=0, atol=tol, msg=k)


# per compacted train step (`train_keep_frac` > 0, a 16^3 distance grid)
# on the card, the frame's first: K1, K2 and K3 launches in the forward
COMPACT_TRAIN = {"nerf_pdf": (1, 1, 1), "sdf_pdf": (2, 1, 1),
                 "neus_pdf": (2, 1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(COMPACT_TRAIN))
def test_cuda_compacted_train_step_matches_dense_and_takes_no_plain_version(
        cuda_device, family, monkeypatch):
    """A compacted train step on the card (64 rays of 16 samples, the
    tracked weights): its forward launches K1, K2 and K3 (the frame's
    grid) COMPACT_TRAIN's times and runs no KNN plain version; the loss
    and stats within rtol 1e-4, each gradient leaf within 1e-2 of its
    largest entry, of the dense step on the card."""
    from animatable_nerf_tpu_torch.config import load_config

    cfg, state, batch = pdf_step_inputs(family=family)
    b = {k: v[0] for k, v in batch.items()}
    dense = pdf_trainer(cfg, state, cuda_device)
    loss, d_stats, _ = dense.loss(b)
    loss.backward()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
                 "knn_blend_blocked_plain", "knn_blend_celled_plain",
                 "_select_blend"):
        monkeypatch.setattr(knn, name, refuse)
    opts = ["N_rand", "64", "N_samples", "16", "perturb", "0",
            "train_keep_frac", "0.5", "knn_grid_res", "16"]
    trainer = pdf_trainer(load_config(f"configs/synthetic_{family}.yaml",
                                      opts), state, cuda_device)
    before = (k1.skip_mlp.launches, knn.knn_blend.launches,
              knn.min_dist.launches)
    loss, stats, ret = trainer.loss(b)
    assert (k1.skip_mlp.launches - before[0], knn.knn_blend.launches
            - before[1], knn.min_dist.launches - before[2]) == COMPACT_TRAIN[family]
    assert 0 < ret["resd_mask"].numel() < 64 * 16
    loss.backward()
    for k, v in d_stats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    got = dict(trainer.model.named_parameters())
    for name, p in dense.model.named_parameters():
        err = (got[name].grad - p.grad).abs().max().item()
        assert torch.isfinite(got[name].grad).all(), name
        assert err <= 1e-2 * p.grad.abs().max().item(), (name, err)
