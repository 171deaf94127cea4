"""Kernel K1 (fused skip-MLP): the port's plain version against the JAX
twin `_ref_forward` and the Pallas kernel in interpret mode, and the CPU
dispatch. The CUDA kernel's own tests are in test_torch_cuda.py.

Tolerance: rtol = atol = 1e-5, float32 against float32 summed in
another order (tests/test_ops.py's tolerance for the same kernel).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animatable_nerf_tpu.ops.mlp_pallas import _ref_forward, fused_skip_mlp

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
