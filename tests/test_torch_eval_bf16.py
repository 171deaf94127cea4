"""`compute_dtype bfloat16` on the CPU: the port's bf16 eval tile of each
of the eight volumetric families against the JAX package's bf16 model
on the same weights (the tracked checkpoints; the aligned families'
composed from them, compat/compose.py) and the same 64 rays of 16
samples of test item 0, JAX through its plain XLA path, as its own
tests run it; the port's bf16 tile against its own float32 tile; and
K1's plain bf16 form (`skip_mlp_plain`) against JAX's bf16 `SkipMLP`.

Tolerances:
  * K1's plain bf16 form against JAX's SkipMLP(dtype=bfloat16) at
    small widths: within one bf16 step (2^-8) of the output's largest
    value, on at most SKIP_MLP_SHARE = 1% of the values (both multiply
    bf16 values in float32 and round where XLA rounds; the float32 sums
    run in other orders, which can move a product across a bf16
    rounding boundary). Measured: equal to the bit.
  * A bf16 tile against JAX's bf16 tile: the maps within BF16_MAP_MAX =
    2e-2 on every value and BF16_MAP_TOL = 2e-3 on all but
    BF16_OUTLIER_SHARE = 5% of them (depth relative to its largest
    value): the two frameworks round bf16 at other places in the heads,
    the weight-normalized layers and softplus, and a flipped rounding
    in a 256-wide trunk moves the next layer by a bf16 step. The
    candidate and survivor counts are JAX's (the filters stay float32).
    Measured: within 5.2e-4 on seven families; NeuS-PDF, whose alpha is
    a difference of sigmoids of the sdf times its inverse variance,
    within 1.0e-2 (acc), 1.6% of its values over 2e-3.
  * A bf16 tile against the port's float32 tile: rgb within 2e-2, JAX's
    own guard of the bf16 render (tests/test_models.py:303-335), and
    the same survivors. Measured: at most 8.2e-3 (NeuS-PDF), 1.5e-3 on
    the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.fields.mlp import SkipMLP

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.ops.skip_mlp import skip_mlp, skip_mlp_plain

TILE_RAYS = 64
N_SAMPLES = 16
GRID = ["knn_grid_res", "16"]
BF16 = ["compute_dtype", "bfloat16"]
SKIP_MLP_SHARE = 1e-2
BF16_MAP_MAX = 2e-2
BF16_MAP_TOL = 2e-3
BF16_OUTLIER_SHARE = 5e-2
RGB_GUARD = 2e-2
FAMILIES = ("aninerf", "nerf_pdf", "sdf_pdf", "neus_pdf", "lbw", "pbw",
            "smpl", "lbw_pdf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores; module-scoped, so the module fixtures'
    torch work runs on one thread too (tests/test_torch_mesh.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    if family == "aninerf":
        return "configs/synthetic.yaml"
    if family in ("nerf_pdf", "sdf_pdf", "neus_pdf"):
        return f"configs/synthetic_{family}.yaml"
    return f"configs/synthetic_aligned_{family}.yaml"


def as_flax(tree):
    """A param tree as flax holds it: every `layers` that a msgpack file
    keys "0", "1", ... a list."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == "layers" and isinstance(v, dict)
                and sorted(v) == sorted(map(str, range(len(v))))):
            v = [v[str(i)] for i in range(len(v))]
        out[k] = [as_flax(x) for x in v] if isinstance(v, list) else as_flax(v)
    return out


def flax_params(family):
    if family == "aninerf":
        return read_checkpoint("data/trained_model/deform/synthetic/latest.flax")["params"]
    if family in ("nerf_pdf", "sdf_pdf", "neus_pdf"):
        return read_checkpoint(
            f"data/trained_model/deform/synthetic_{family}/latest.flax")["params"]
    return compose_aligned(family)


@pytest.mark.parametrize("act_last", [False, True])
def test_skip_mlp_plain_bf16_matches_jax(act_last):
    """K1's plain bf16 form against JAX's SkipMLP with dtype bfloat16 (an
    output head) and, with act_last, against the same loop with every
    layer activated (JAX's TPoseNeRF trunk, fields/fields.py:104-116),
    on seeded numpy weights and inputs, at small widths."""
    rng = np.random.default_rng(3)
    din, width, depth, out = 35, 64, 4, 24
    x = rng.standard_normal((256, din)).astype(np.float32)
    module = SkipMLP(depth=depth, width=width, out_dim=out, skips=(2,),
                     dtype=jnp.bfloat16)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                              * 0.3), params)
    p = params["params"]
    names = [f"lin{i}" for i in range(depth)] + ([] if act_last else ["out"])
    layers = [(torch.tensor(np.asarray(p[n]["kernel"])),
               torch.tensor(np.asarray(p[n]["bias"]))) for n in names]
    if act_last:
        def trunk(xb):
            h = xb
            for i, n in enumerate(names):
                h = jax.nn.relu(h @ p[n]["kernel"].astype(jnp.bfloat16)
                                + p[n]["bias"].astype(jnp.bfloat16))
                if i == 2:
                    h = jnp.concatenate([xb, h], axis=-1)
            return h.astype(jnp.float32)
        ref = np.asarray(jax.jit(trunk)(jnp.asarray(x).astype(jnp.bfloat16)))
    else:
        ref = np.asarray(jax.jit(module.apply)(params, jnp.asarray(x)))
    xb = torch.tensor(x).to(torch.bfloat16)
    got = skip_mlp_plain(xb, layers, skips=(2,), act_last=act_last)
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - ref)
    step = 2.0 ** -8 * np.abs(ref).max()
    assert diff.max() <= step, diff.max()
    assert (diff > 0).mean() <= SKIP_MLP_SHARE
    # the wrapper takes the plain version on the CPU, launching nothing
    before = (skip_mlp.launches, skip_mlp.launches_bf16)
    assert torch.equal(skip_mlp(xb, layers, skips=(2,), act_last=act_last), got)
    assert (skip_mlp.launches, skip_mlp.launches_bf16) == before


@pytest.fixture(scope="module", params=FAMILIES)
def tiles(request):
    """One tile of test item 0 through JAX's bf16 model and the port's
    bf16 and float32 engines, from the same weights."""
    family = request.param
    cfg = cfg_file(family)
    jc = j_load_config(cfg, GRID + BF16, run_type="evaluate")
    jc.eval = True
    j_eng = j_engine.Engine(jc)
    j_item = j_engine.make_dataset(jc, "test")[0]
    j_frame = j_eng._device_frame(j_item)
    params = as_flax(flax_params(family))
    jm = j_eng.model.clone(eval_keep_frac=1.0)
    assert jm.dtype == jnp.bfloat16
    rays = {k: np.asarray(j_item[k], np.float32)[::7][:TILE_RAYS]
            for k in ("ray_o", "ray_d", "near", "far")}
    z = stratified_z_vals(torch.tensor(rays["near"]), torch.tensor(rays["far"]),
                          N_SAMPLES)
    viewdir = torch.tensor(rays["ray_d"])
    wpts = z_vals_to_pts(torch.tensor(rays["ray_o"]), viewdir, z)
    apply = jax.jit(lambda p, w, v, zz, f: jm.apply(
        p, w, v, zz, f, train=False, precomposite=True))
    ref = apply(params, wpts.numpy(), rays["ray_d"], z.numpy(), j_frame)
    out = {"family": family, "jax": ref}
    for name, opts in (("bf16", GRID + BF16), ("f32", GRID)):
        tc = load_config(cfg, opts, run_type="evaluate")
        tc.eval = True
        eng = t_engine.Engine(tc, "cpu")
        eng.load_params(params)
        frame = eng._device_frame(t_engine.make_dataset(tc, "test")[0])
        out[name] = eng.model(wpts, viewdir, z, frame)
    return out


def test_bf16_tile_matches_jax(tiles):
    ref, got = tiles["jax"], tiles["bf16"]
    assert not bool(ref["compact_overflow"])
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        diff = np.abs(g - r) / (1.0 if k != "depth_map" else max(1.0, np.abs(r).max()))
        assert diff.max() <= BF16_MAP_MAX, (k, diff.max())
        assert (diff > BF16_MAP_TOL).mean() <= BF16_OUTLIER_SHARE, (
            k, (diff > BF16_MAP_TOL).mean())
    assert got["n_candidates"] == int(np.asarray(ref["compact_count"]).sum())
    if "compact_count_exact" in ref:
        assert got["n_survivors"] == int(
            np.asarray(ref["compact_count_exact"]).sum())
    assert got["n_survivors"] > 100


def test_bf16_tile_within_jax_guard_of_f32(tiles):
    """JAX's own guard of its bf16 render: rgb within 2e-2 of float32.
    The filters stay float32, so the survivors are the same."""
    bf16, f32 = tiles["bf16"], tiles["f32"]
    assert bf16["n_survivors"] == f32["n_survivors"] > 100
    delta = (bf16["rgb_map"] - f32["rgb_map"]).abs().max().item()
    assert 0.0 < delta <= RGB_GUARD, delta
