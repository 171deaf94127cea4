"""Kernel K1 (fused skip-MLP): the port's plain version against the JAX
twin `_ref_forward` and the Pallas kernel in interpret mode, the CPU
dispatch, the packed weight layouts, and CPU rehearsals of the kernel's
3xTF32 arithmetic and of its bf16 form's chunks and roundings. The CUDA
kernel's own tests are in test_torch_cuda.py.

Tolerance: rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel); the
3xTF32 split is held to the same bar; the bf16 rehearsal within
BF16_REL_TOL of the output's largest value, as the bf16 kernel on the
card (test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animatable_nerf_tpu.ops.mlp_pallas import _ref_forward, fused_skip_mlp

from animatable_nerf_tpu_torch.fields.fields import ResidualField
from animatable_nerf_tpu_torch.fields.mlp import kernel_layers, packed_layers
from animatable_nerf_tpu_torch.ops import skip_mlp as k1

from test_torch_cuda import (
    BF16_REL_TOL,
    PRODUCTION,
    SMALL,
    TOL,
    make_case,
    torch_layers,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, and the emulations' many small products
    crawl (tests/test_torch_train_compaction.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_plain_matches_ref_and_interpret(name):
    x, layers, skips, act, act_last = make_case(SMALL[name], 77, 0)
    got = k1.skip_mlp_plain(torch.tensor(x), torch_layers(layers), skips,
                            act, act_last).numpy()
    jl = [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    ref = _ref_forward(jnp.asarray(x), jl, skips, act, act_last)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    pallas = fused_skip_mlp(jnp.asarray(x), jl, skips=skips, act=act,
                            act_last=act_last, interpret=True, tile=128)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("name", sorted(PRODUCTION))
def test_production_wirings_full_width(name):
    x, layers, skips, act, act_last = make_case(PRODUCTION[name], 64, 1)
    got = k1.skip_mlp_plain(torch.tensor(x), torch_layers(layers), skips,
                            act, act_last).numpy()
    jl = [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    ref = _ref_forward(jnp.asarray(x), jl, skips, act, act_last)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    pallas = fused_skip_mlp(jnp.asarray(x), jl, skips=skips, act=act,
                            act_last=act_last, interpret=True, tile=64)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    x, layers, skips, act, act_last = make_case(SMALL["relu_skip2"], 50, 2)
    before = k1.skip_mlp.launches
    tl = torch_layers(layers)
    got = k1.skip_mlp(torch.tensor(x), tl, skips, act, act_last)
    plain = k1.skip_mlp_plain(torch.tensor(x), tl, skips, act, act_last)
    assert torch.equal(got, plain)
    assert k1.skip_mlp.launches == before


def test_other_devices_raise():
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.skip_mlp(x, [(torch.zeros(3, 2, device="meta"),
                         torch.zeros(2, device="meta"))])


def tf32(v):
    """The TF32 value the tensor cores read: v rounded to 10 mantissa
    bits, to nearest with ties away from zero (the cvt.rna rule), by bit
    arithmetic on the float32 view."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def emulate_3xtf32(x, packed, act, act_last):
    """The kernel's arithmetic on the CPU, from the packed weights: per
    layer the bias, then for each step of 8 input features lo(a)hi(w),
    hi(a)lo(w) and hi(a)hi(w) added in that order in float32, where
    hi = tf32(v) and lo = tf32(v - hi)."""
    fn = {"relu": torch.relu, "softplus": torch.nn.functional.softplus,
          "none": lambda h: h}[act]
    din_p = k1._round_up(packed.din, k1.PACK_K)
    xp = torch.nn.functional.pad(x, (0, din_p - packed.din))
    a = xp
    n_layers = len(packed.weights)
    for i in range(n_layers):
        w, b = k1.unpack_layer(packed, i)
        w_hi = tf32(w)
        w_lo = tf32(w - w_hi)
        a_hi = tf32(a)
        a_lo = tf32(a - a_hi)
        acc = b.expand(a.shape[0], -1).clone()
        for k in range(0, a.shape[1], 8):
            acc = acc + a_lo[:, k:k + 8] @ w_hi[k:k + 8]
            acc = acc + a_hi[:, k:k + 8] @ w_lo[k:k + 8]
            acc = acc + a_hi[:, k:k + 8] @ w_hi[k:k + 8]
        if i < n_layers - 1 or act_last:
            acc = fn(acc)
        a = torch.cat([xp, acc], dim=-1) if i in packed.skips else acc
    return a[:, :packed.douts[-1]]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11  # halfway between two TF32 values: rounds up
    v = torch.tensor([1.0, one, -one, 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    got = tf32(v)
    assert got[:4].tolist() == [1.0, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10, 1.0]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


@pytest.mark.parametrize("name", sorted(PRODUCTION))
def test_3xtf32_emulation_matches_plain_and_ref(name):
    x, layers, skips, act, act_last = make_case(PRODUCTION[name], 256, 5)
    tl = torch_layers(layers)
    got = emulate_3xtf32(torch.tensor(x), k1.pack_layers(tl, skips), act,
                         act_last).numpy()
    plain = k1.skip_mlp_plain(torch.tensor(x), tl, skips, act, act_last)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    jl = [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    ref = _ref_forward(jnp.asarray(x), jl, skips, act, act_last)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", sorted({**SMALL, **PRODUCTION}))
def test_pack_layers_places_every_segment(name):
    """Each padded W holds the true rows at their segments' padded
    offsets (x first after a skip) and zeros elsewhere, and the bias is
    zero-padded."""
    x, layers, skips, act, act_last = make_case({**SMALL, **PRODUCTION}[name],
                                                4, 6)
    tl = torch_layers(layers)
    packed = k1.pack_layers(tl, skips)
    din = x.shape[1]
    din_p = k1._round_up(din, k1.PACK_K)
    prev = None
    for i, (w, b) in enumerate(tl):
        wp, bp = k1.unpack_layer(packed, i)
        dout = w.shape[1]
        n_p = k1._round_up(dout, k1.PACK_K)
        segs = [(0, din)] if i == 0 else (
            [(0, din), (din_p, prev)] if (i - 1) in skips else [(0, prev)])
        k_p = sum(k1._round_up(t, k1.PACK_K) for _, t in segs)
        assert wp.shape == (k_p, n_p) and bp.shape == (n_p,)
        expect = torch.zeros(k_p, n_p)
        row = 0
        for off, t in segs:
            expect[off:off + t, :dout] = w[row:row + t]
            row += t
        assert torch.equal(wp, expect)
        assert torch.equal(bp[:dout], b) and not bp[dout:].any()
        prev = dout
    assert packed.douts == tuple(w.shape[1] for w, _ in tl)


def padded_bf16_layers(layers, skips, din):
    """Each layer's W^T (N_p, K_p) as the bf16 form pads it, built
    directly from the segments: inputs at offsets padded to 64 (x first
    after a skip), outputs padded to 16; float32 holding bf16 values."""
    out, segs = [], [(din, -(-din // 64) * 64)]
    for i, (w, _) in enumerate(layers):
        dout = w.shape[1]
        n_p = -(-dout // 16) * 16
        wt = np.zeros((n_p, sum(p for _, p in segs)), np.float32)
        row = col = 0
        for t, p in segs:
            wt[:dout, col:col + t] = w[row:row + t].T
            row, col = row + t, col + p
        out.append(torch.tensor(wt).to(torch.bfloat16).float().numpy())
        segs = [(dout, -(-dout // 64) * 64)]
        if i in skips and i < len(layers) - 1:
            segs = [(din, -(-din // 64) * 64)] + segs
    return out


@pytest.mark.parametrize("name", sorted({**SMALL, **PRODUCTION}))
def test_pack_layers_bf16_swizzled_layout(name):
    """The bf16 pack puts W^T's element (n, k) at chunk k // 32, row n of
    64 bytes, 16-byte unit (k % 32) // 8 XOR (n // 2) % 4, position k %
    8 (the layout wgmma reads with the 64-byte swizzle), and
    unpack_layer gives the padded W back."""
    x, layers, skips, act, act_last = make_case({**SMALL, **PRODUCTION}[name],
                                                4, 6)
    tl = torch_layers(layers)
    packed = k1.pack_layers(tl, skips, dtype=torch.bfloat16)
    assert packed.dtype == torch.bfloat16
    for i, wt in enumerate(padded_bf16_layers(layers, skips, x.shape[1])):
        n_p, k_p = wt.shape
        n, k = np.meshgrid(np.arange(n_p), np.arange(k_p), indexing="ij")
        index = (k // 32) * n_p * 32 + n * 32 \
            + (((k % 32) // 8) ^ ((n // 2) % 4)) * 8 + k % 8
        flat = packed.weights[i].float().numpy()
        assert flat.shape == (n_p * k_p,)
        np.testing.assert_array_equal(flat[index], wt)
        wp, bp = k1.unpack_layer(packed, i)
        np.testing.assert_array_equal(wp.float().numpy(), wt.T)
        b = tl[i][1].to(torch.bfloat16).float()
        assert torch.equal(bp[:b.shape[0]], b) and not bp[b.shape[0]:].any()


def emulate_bf16(x, packed, act, act_last):
    """The bf16 kernel's arithmetic on the CPU, from the packed weights:
    x and h zero-padded to 64 columns a segment, each layer's product
    summed chunk by chunk of 32 input features in float32 from zero,
    then the kernel's epilogue: the product rounded to bf16, the bias
    added, rounded and activated into bf16 h (zeros in its padded
    columns), or for the last layer without act_last the float32 sum."""
    fn = {"relu": torch.relu, "softplus": torch.nn.functional.softplus,
          "none": lambda h: h}[act]
    bf16 = torch.bfloat16
    pad = k1.PACK_K_BF16
    xp = torch.nn.functional.pad(x.float(), (0, k1._round_up(packed.din, pad)
                                             - packed.din))
    a = xp
    n_layers = len(packed.weights)
    for i in range(n_layers):
        w, b = k1.unpack_layer(packed, i)
        w = w.float()
        acc = torch.zeros(a.shape[0], w.shape[1])
        step = k1.BF16_CHUNK_K
        for k in range(0, a.shape[1], step):
            acc = acc + a[:, k:k + step] @ w[k:k + step]
        v = acc.to(bf16).float() + b
        if i < n_layers - 1 or act_last:
            v = fn(v.to(bf16).float()).to(bf16).float()
        if i == n_layers - 1:
            return v[:, :packed.douts[-1]]
        h = torch.nn.functional.pad(v[:, :packed.douts[i]], (
            0, k1._round_up(packed.douts[i], pad) - packed.douts[i]))
        a = torch.cat([xp, h], dim=-1) if i in packed.skips else h


@pytest.mark.parametrize("name", sorted({**SMALL, **PRODUCTION}))
def test_bf16_emulation_matches_plain(name):
    """The bf16 form's chunks and roundings, run from the pack, agree
    with the plain bf16 version (the JAX bf16 trunk's rounding)."""
    x, layers, skips, act, act_last = make_case({**SMALL, **PRODUCTION}[name],
                                                96, 7)
    tl = torch_layers(layers)
    xb = torch.tensor(x).to(torch.bfloat16)
    got = emulate_bf16(xb, k1.pack_layers(tl, skips, dtype=torch.bfloat16),
                       act, act_last)
    plain = k1.skip_mlp_plain(xb, tl, skips, act, act_last)
    assert got.shape == plain.shape
    err = (got - plain).abs().max().item()
    assert err <= BF16_REL_TOL * max(1.0, plain.abs().max().item()), err


def test_packed_layers_follow_in_place_updates():
    """The pack is kept per weight version: the same object while the
    weights stay, a new one after an in-place change or a swapped
    parameter, each equal to a fresh pack of the weights of that time."""
    torch.manual_seed(1)
    field = ResidualField()
    linears = [*field.resd_linears, field.resd_fc]
    first = packed_layers(field, linears, (4,), 135)
    assert packed_layers(field, linears, (4,), 135) is first
    with torch.no_grad():
        field.resd_linears[2].weight.add_(0.5)
    second = packed_layers(field, linears, (4,), 135)
    assert second is not first
    fresh = k1.pack_layers(kernel_layers(linears), (4,), 135)
    for got, want in zip(second.weights, fresh.weights):
        assert torch.equal(got, want)
    assert not torch.equal(second.weights[2], first.weights[2])
    field.resd_fc.bias = torch.nn.Parameter(field.resd_fc.bias + 1.0)
    third = packed_layers(field, [*field.resd_linears, field.resd_fc],
                          (4,), 135)
    assert third is not second
    assert torch.equal(third.biases[-1][:3], field.resd_fc.bias.detach())
