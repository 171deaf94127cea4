"""The port's NeRF-PDF and NeuS-PDF pieces against the JAX package: the
NeuS opacity, the inverse-variance scalar, the color network without
normals, one eval tile of each model against the flax model's eval path
(`precomposite=True`, as JAX's renderer calls it) with the tracked
weights carried by the new state dicts, strict loads of the tracked
checkpoints and the param-tree round trips.

Tolerances: rtol = atol = 1e-6 for `neus_alpha` and the variance
(elementwise float32); 1e-5 for the color network (as
tests/test_torch_pdf.py); on a tile's maps |d| <= 1e-4 on all but 0.1%
of the values and <= 5e-4 on every value (as
tests/test_torch_slice_sdf.py: 8x256 and 9x256 stacks summed in another
order, and the KNN blend by differences against JAX's matmul form off
the TPU, which can move a point at the 0.1 filter edge), and the tile's
candidate and survivor counts equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.compat.torch_export import export_nerf_pdf, export_neus_pdf
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.sdf import neus_alpha as j_neus_alpha
from animatable_nerf_tpu.fields.fields import (
    ColorNetwork as JColorNetwork,
    SingleVarianceNetwork as JSingleVarianceNetwork,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.compat.jax_params import (
    nerf_pdf_param_tree,
    nerf_pdf_state_dict,
    neus_pdf_param_tree,
    neus_pdf_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.core.sdf import neus_alpha
from animatable_nerf_tpu_torch.fields.fields import SingleVarianceNetwork
from animatable_nerf_tpu_torch.models.pdf import SDF_FILL, NeRFPDF, NeuSPDF
from animatable_nerf_tpu_torch.train.checkpoints import param_codec

ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
MAP_TOL = 1e-4
MAP_MAX = 5e-4
OUTLIER_SHARE = 1e-3
N_LATENTS = 4
TILE_RAYS = 256
N_SAMPLES = 64
FAMILIES = {
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml", NeRFPDF,
                 nerf_pdf_state_dict, nerf_pdf_param_tree, export_nerf_pdf,
                 "nerf_network"),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml", NeuSPDF,
                 neus_pdf_state_dict, neus_pdf_param_tree, export_neus_pdf,
                 "sdf_network"),
}


def ckpt(family):
    return f"data/trained_model/deform/synthetic_{family}/latest.flax"


def neus_grid(seed):
    """Ray-ordered sdf (8, 16): crossings, rays filled with SDF_FILL but
    for one sample (a ray with a single survivor, first, inside and
    last), and an all-fill ray."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-0.3, 0.3, 16, dtype=np.float32)
    sdf = (z[None] * rng.uniform(-1.5, 1.5, (8, 1))
           + rng.normal(0, 0.02, (8, 16))).astype(np.float32)
    sdf[2:6] = SDF_FILL
    sdf[2, 0], sdf[3, 7], sdf[4, 15] = -0.01, 0.004, 0.02
    sdf[5, 9:12] = (-0.02, 0.0, 0.03)  # a run of survivors
    sdf[0, 4:10] = SDF_FILL  # fill inside a ray
    return sdf


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("inv_var", [1.0, 24.5, 1e3])
def test_neus_alpha_matches_jax(seed, inv_var):
    sdf = neus_grid(seed)
    ref = np.asarray(j_neus_alpha(jnp.asarray(sdf), jnp.float32(inv_var)))
    got = neus_alpha(torch.tensor(sdf), torch.tensor(inv_var)).numpy()
    np.testing.assert_allclose(got, ref, **ELEM_TOL)
    # the last sample repeats the residual before it
    cdf = 1.0 / (1.0 + np.exp(-sdf.astype(np.float64) * inv_var))
    p_last = cdf[:, -2] - cdf[:, -1]
    np.testing.assert_allclose(
        got[:, -1], np.clip((p_last + 1e-5) / (cdf[:, -1] + 1e-5), 0, 1),
        rtol=1e-4, atol=1e-6)
    # a lone survivor's next neighbour is the fill
    c, c_fill = cdf[3, 7], 1.0 / (1.0 + np.exp(-SDF_FILL * inv_var))
    np.testing.assert_allclose(
        got[3, 7], np.clip((c - c_fill + 1e-5) / (c + 1e-5), 0, 1),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("value", [-0.3, 0.2, 0.7])
def test_single_variance_matches_flax(value):
    ref = JSingleVarianceNetwork().apply(
        {"params": {"variance": jnp.float32(value)}})
    net = SingleVarianceNetwork()
    with torch.no_grad():
        net.variance.fill_(value)
    np.testing.assert_allclose(net().item(), float(ref), **ELEM_TOL)
    assert SingleVarianceNetwork()().item() == pytest.approx(np.exp(2.0),
                                                             rel=1e-6)


@pytest.mark.parametrize("latent_index", [0, 3])
def test_color_network_without_normals_matches_flax(latent_index):
    rng = np.random.RandomState(11)
    n = 96
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    vd = rng.randn(n, 3).astype(np.float32)
    feat = rng.randn(n, 256).astype(np.float32)
    jm = JColorNetwork(num_latents=N_LATENTS, use_normals=False)
    params = jm.init(jax.random.PRNGKey(5), pts, None, vd, feat,
                     jnp.int32(0))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)
    # carried by the NeRF-PDF state dict, around a fresh model's weights
    model = NeRFPDF(num_latents=N_LATENTS)
    tree = nerf_pdf_param_tree(dict(model.named_parameters()))
    tree = {"params": {**tree["params"], "color_network": params}}
    model.load_state_dict(nerf_pdf_state_dict(tree), strict=True)
    net = model.tpose_human.color_network
    assert net.lin0.weight_v.shape == (256, 3 + 27 + 256)
    assert not net.use_normals
    ref = jm.apply({"params": params}, pts, None, vd, feat,
                   jnp.int32(latent_index))
    with torch.no_grad():
        got = net(torch.tensor(pts), None, torch.tensor(vd),
                  torch.tensor(feat), latent_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tracked_checkpoint_strict_loads_and_round_trips(family):
    cfg, model_cls, to_state, to_tree, export, net = FAMILIES[family]
    params = read_checkpoint(ckpt(family))["params"]
    state = to_state(params)
    model = model_cls(num_latents=N_LATENTS)
    model.load_state_dict(state, strict=True)
    assert param_codec(model) == (to_state, to_tree)
    # the JAX exporter's names and values (it takes flax's layer list)
    inner = dict(params["params"])
    layers = inner[net]["layers"]
    inner[net] = {"layers": [layers[str(i)] for i in range(len(layers))]}
    ref = export(inner)
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(v).reshape(state[k].shape),
                                      err_msg=k)
    # state dict -> param tree -> state dict, and the tree is the file's
    tree = to_tree(dict(model.named_parameters()))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v, np.float32).reshape(
            flat[k].shape), err_msg=k)
    again = to_state(tree)
    for k, v in state.items():
        assert torch.equal(again[k], v), k
    with pytest.raises(KeyError):
        to_tree({**dict(model.named_parameters()), "stray.weight": state[k]})


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def tile_setup(request):
    """Both packages' engines on the family's config (knn_grid_res 24),
    their frames of test item 0, the JAX model with every point within
    its compaction capacity, and a tile of that item's rays."""
    family = request.param
    cfg = FAMILIES[family][0]
    opts = ["knn_grid_res", "24"]
    jc = j_load_config(cfg, opts, run_type="evaluate")
    tc = load_config(cfg, opts, run_type="evaluate")
    jc.eval = tc.eval = True
    j_eng = j_engine.Engine(jc)
    j_item = j_engine.make_dataset(jc, "test")[0]
    j_frame = j_eng._device_frame(j_item)
    params = read_checkpoint(ckpt(family))["params"]
    # flax holds the network's layers as a list (the file as "0", "1", ...)
    net = FAMILIES[family][5]
    layers = params["params"][net]["layers"]
    params = {"params": {**params["params"], net: {
        "layers": [layers[str(i)] for i in range(len(layers))]}}}
    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params(params)
    t_frame = t_eng._device_frame(t_engine.make_dataset(tc, "test")[0])
    jm = j_eng.model.clone(eval_keep_frac=1.0)
    apply = jax.jit(lambda p, w, v, z, f: jm.apply(
        p, w, v, z, f, train=False, precomposite=True))
    rays = {k: np.asarray(j_item[k], np.float32)[::5][:TILE_RAYS]
            for k in ("ray_o", "ray_d", "near", "far")}
    return {"family": family, "apply": apply, "params": params,
            "j_frame": j_frame, "t_eng": t_eng, "t_frame": t_frame,
            "rays": rays}


def render_tile(setup, shift=0.0, shrink=0.0):
    """The tile through both models: ray origins moved by `shift` along
    x, and the canonical box shrunk by `shrink` on every side."""
    rays = dict(setup["rays"])
    rays["ray_o"] = rays["ray_o"] + np.float32([shift, 0.0, 0.0])
    z = stratified_z_vals(torch.tensor(rays["near"]), torch.tensor(rays["far"]),
                          N_SAMPLES)
    wpts = z_vals_to_pts(torch.tensor(rays["ray_o"]), torch.tensor(rays["ray_d"]), z)
    tb = np.asarray(setup["j_frame"]["tbounds"], np.float32)
    tb = tb + np.float32(shrink) * np.float32([[1.0], [-1.0]])
    j_frame = {**setup["j_frame"], "tbounds": jnp.asarray(tb)}
    t_frame = {**setup["t_frame"], "tbounds": torch.tensor(tb)}
    ref = setup["apply"](setup["params"], wpts.numpy(), rays["ray_d"], z.numpy(),
                         j_frame)
    assert not bool(ref["compact_overflow"])
    got = setup["t_eng"].model(wpts, torch.tensor(rays["ray_d"]), z, t_frame)
    return ref, got


def assert_maps_match(ref, got):
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        diff = np.abs(g - r) / (1.0 if k != "depth_map" else max(1.0, np.abs(r).max()))
        assert diff.max() <= MAP_MAX, (k, diff.max())
        assert (diff > MAP_TOL).mean() <= OUTLIER_SHARE, (k, (diff > MAP_TOL).sum())


@pytest.mark.parametrize("case", ["body", "box_shrunk", "far"])
def test_tile_matches_flax_eval(tile_setup, case):
    """One 256-ray tile of item 0: on the body; with the canonical box
    shrunk by 0.15 on every side, so many survivors lie outside it (their
    own alpha and rgb are zeroed, but NeuS keeps their sdf in their
    neighbours' CDF); and 3 away from the body, where pass 1 and pass
    2 keep only the point each forces on. The port's candidates and
    survivors are JAX's pass-1 and exact counts."""
    shift, shrink = {"body": (0.0, 0.0), "box_shrunk": (0.0, 0.15),
                     "far": (3.0, 0.0)}[case]
    ref, got = render_tile(tile_setup, shift, shrink)
    assert_maps_match(ref, got)
    assert got["n_candidates"] == int(np.asarray(ref["compact_count"]).sum())
    assert got["n_survivors"] == int(np.asarray(ref["compact_count_exact"]).sum())
    if case == "far":
        assert got["n_survivors"] == 1
        assert float(got["acc_map"].max()) < 1e-3
    else:
        assert got["n_survivors"] > 1000
        assert float(got["acc_map"].max()) > 0.5
    tile_setup[case] = got["acc_map"].numpy()
    if case == "box_shrunk":
        body = tile_setup.get("body")
        if body is None:
            body = render_tile(tile_setup)[1]["acc_map"].numpy()
        assert np.abs(body - tile_setup[case]).max() > 0.1
