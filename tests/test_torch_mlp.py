"""Kernel K1 (fused skip-MLP): the port's plain version against the JAX
twin `_ref_forward` and the Pallas kernel in interpret mode, the CPU
dispatch, the packed weight layout, and a CPU rehearsal of the kernel's
3xTF32 arithmetic. The CUDA kernel's own tests are in
test_torch_cuda.py.

Tolerance: rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel); the
3xTF32 split is held to the same bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animatable_nerf_tpu.ops.mlp_pallas import _ref_forward, fused_skip_mlp

from animatable_nerf_tpu_torch.fields.fields import ResidualField
from animatable_nerf_tpu_torch.fields.mlp import kernel_layers, packed_layers
from animatable_nerf_tpu_torch.ops import skip_mlp as k1

from test_torch_cuda import PRODUCTION, SMALL, TOL, make_case, torch_layers


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
