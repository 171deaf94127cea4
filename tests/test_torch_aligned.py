"""The aligned families' evaluation on the CPU: the port against the JAX
package (animatable_nerf_tpu/models/aligned.py) on the same inputs and
weights. The weights are composed from the tracked checkpoints
(compat/compose.py `compose_aligned`), or those moved by seeded noise; the
frame is test item 0 of configs/synthetic_aligned_<f>.yaml (the capsule
subject) with its distance grid at knn_grid_res 24, and a tile is 96 of
its rays at 32 samples.

Tolerances:
  * `PoseCondBWField` against flax: 1e-5 (an 8x256 stack in float32
    summed in another order, then a softmax).
  * A tile against the JAX model's `_eval_compacted`
    (`precomposite=True`, as JAX's renderer calls it): rgb, acc and depth
    within MAP_TOL = 1e-4 (depth relative to its largest value); the
    port's candidates equal JAX's pass-1 count (`compact_count`), and its
    survivors the points whose exact weighted distance JAX keeps. The
    KNN blend by differences against JAX's matmul form may move a point
    within FLIP_BAND of the threshold, at most MAX_FLIPS of them; none
    did in these tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.compat.torch_export import EXPORTERS
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.models.aligned import PoseCondBWField as JPoseCondBWField
from animatable_nerf_tpu.models.common import keep_mask_with_argmin
from animatable_nerf_tpu.ops.knn_pallas import sample_blend_closest_points_fused

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.compose import FAMILIES, compose_aligned
from animatable_nerf_tpu_torch.compat.jax_params import aligned_state_dict
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.fields.fields import PoseCondBWField
from animatable_nerf_tpu_torch.models.aligned import (
    AlignedLBW,
    AlignedLBWPDF,
    AlignedPBW,
    AlignedSMPL,
)
from animatable_nerf_tpu_torch.train.checkpoints import param_codec, write_start

FIELD_TOL = dict(rtol=1e-5, atol=1e-5)
MAP_TOL = 1e-4
FLIP_BAND = 1e-5
MAX_FLIPS = 4
TILE_RAYS = 96
N_SAMPLES = 32
GRID_OPTS = ["knn_grid_res", "24"]
CLASSES = {"lbw": AlignedLBW, "pbw": AlignedPBW, "smpl": AlignedSMPL,
           "lbw_pdf": AlignedLBWPDF}


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    return f"configs/synthetic_aligned_{family}.yaml"


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_flax(tree):
    """A param tree as flax holds it: the NeRF network's layers a list
    (a msgpack file keys them "0", "1", ...)."""
    inner = dict(tree["params"])
    layers = inner["nerf_network"]["layers"]
    if isinstance(layers, dict):
        inner["nerf_network"] = {
            "layers": [layers[str(i)] for i in range(len(layers))]}
    return {"params": inner}


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request, tmp_path_factory):
    """One family's engines on item 0 (JAX's with every point within its
    compaction capacity), the flax model's parameter shapes, the composed
    weights and those moved by noise, and a tile of that item's rays.
    The composed tree is written (`write_start`) to a temporary
    directory, which both configs take as their `trained_model_dir`."""
    family = request.param
    model_dir = str(tmp_path_factory.mktemp(f"aligned_{family}"))
    write_start(model_dir, compose_aligned(family))
    jc = j_load_config(cfg_file(family), GRID_OPTS, run_type="evaluate")
    tc = load_config(cfg_file(family), GRID_OPTS, run_type="evaluate")
    jc.eval = tc.eval = True
    jc.trained_model_dir = tc.trained_model_dir = model_dir
    j_eng = j_engine.Engine(jc)
    j_ds = j_engine.make_dataset(jc, "test")
    j_frame = j_eng._device_frame(j_ds[0])
    # the flax model's parameter shapes, traced without a compile
    z = jnp.ones((8, N_SAMPLES))
    shapes = jax.eval_shape(lambda: j_eng.model.init(
        jax.random.PRNGKey(3), jnp.zeros((8, N_SAMPLES, 3)), jnp.ones((8, 3)),
        z, j_frame, train=False))
    t_eng = t_engine.Engine(tc, "cpu")
    t_frame = t_eng._device_frame(t_engine.make_dataset(tc, "test")[0])
    jm = j_eng.model.clone(eval_keep_frac=1.0)
    apply = jax.jit(lambda p, w, v, z, f: jm.apply(
        p, w, v, z, f, train=False, precomposite=True))
    item = j_ds[0]
    rays = {k: np.asarray(item[k], np.float32)[::7][:TILE_RAYS]
            for k in ("ray_o", "ray_d", "near", "far")}
    composed = as_flax(compose_aligned(family))
    # "random" weights: the composed ones moved by seeded noise of a
    # tenth of each leaf's spread
    rng = np.random.RandomState(7)
    noisy = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * a.std() * rng.randn(*a.shape)).astype(np.float32),
        composed)
    return {"family": family, "jc": jc, "j_eng": j_eng, "shapes": shapes,
            "composed": composed, "random": noisy, "apply": apply,
            "j_frame": j_frame, "t_eng": t_eng, "t_frame": t_frame,
            "rays": rays}


def test_composed_tree_loads_strictly_in_both_packages(setup):
    """compose_aligned's tree has exactly the leaves and shapes of the
    flax model's init; JAX's Engine.load_params restores the written
    file against that template; the port strict-loads its state dict,
    whose names and values are the JAX exporter's, and writes the same
    tree back."""
    family = setup["family"]
    composed = compose_aligned(family)
    got = leaves(as_flax(composed))
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(setup["shapes"])}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    template = jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype),
                                      setup["shapes"])
    for k, v in leaves(setup["j_eng"].load_params(template)).items():
        np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)

    model = CLASSES[family](num_latents=4, norm_th=0.1)
    to_state, to_tree = param_codec(model)
    state = to_state(composed)
    model.load_state_dict(state, strict=True)
    ref = EXPORTERS[f"aligned_{family}"](as_flax(composed)["params"])
    if family == "pbw":  # the unread frame-latent table, as JAX writes it
        assert torch.equal(state["bw_latent.weight"], torch.zeros(5, 128))
        ref["bw_latent.weight"] = np.zeros((5, 128), np.float32)
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(
            state[k].numpy(), np.asarray(v).reshape(state[k].shape), err_msg=k)
    back = leaves(as_flax(to_tree(dict(model.named_parameters()))))
    assert set(back) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        to_tree({**dict(model.named_parameters()), "stray.weight": state[k]})


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_cond_bw_field_matches_flax(seed):
    """[PE(xyz), pose] through the 8x256 stack, over the log prior,
    softmaxed: against flax's PoseCondBWField on its initial weights
    moved by noise, at random points, priors and a pose."""
    rng = np.random.RandomState(seed)
    n = 80
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    prior = rng.dirichlet(np.ones(24) * 0.3, n).astype(np.float32)
    prior[:5] = 0.0
    prior[:5, 3] = 1.0  # a one-hot prior: log(0 + 1e-9) elsewhere
    pose = rng.normal(0, 0.4, 72).astype(np.float32)
    jf = JPoseCondBWField()
    params = jf.init(jax.random.PRNGKey(seed), pts, prior, pose)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a)).astype(
            np.float32), params)
    want = np.asarray(jf.apply(params, pts, prior, pose))
    field = PoseCondBWField(num_latents=5)
    state = aligned_state_dict({"params": {
        **compose_aligned("smpl")["params"], "bw_field": params["params"]}})
    field.load_state_dict({k: v for k, v in state.items()
                           if k.startswith("bw_")}, strict=True)
    with torch.no_grad():
        got = field(torch.tensor(pts), torch.tensor(prior),
                    torch.tensor(pose)).numpy()
    np.testing.assert_allclose(got, want, **FIELD_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def render_tile(setup, params, norm_th=None):
    """The tile through both models on `params` (a flax tree), the port's
    with its threshold set to `norm_th` when given (JAX's model cloned
    with it). Returns (JAX's outputs, the port's, the JAX exact keep
    mask over the candidates' weighted distances, the port's pnorm of
    the tile's points)."""
    rays = setup["rays"]
    z = stratified_z_vals(torch.tensor(rays["near"]), torch.tensor(rays["far"]),
                          N_SAMPLES)
    wpts = z_vals_to_pts(torch.tensor(rays["ray_o"]), torch.tensor(rays["ray_d"]),
                         z)
    apply = setup["apply"]
    if norm_th is not None:
        jm = setup["j_eng"].model.clone(eval_keep_frac=1.0, norm_th=norm_th)
        apply = jax.jit(lambda p, w, v, zz, f: jm.apply(
            p, w, v, zz, f, train=False, precomposite=True))
    ref = apply(params, wpts.numpy(), rays["ray_d"], z.numpy(),
                setup["j_frame"])
    assert not bool(ref["compact_overflow"])
    model = setup["t_eng"].model
    model.load_state_dict(aligned_state_dict(params), strict=True)
    saved = model.norm_th
    if norm_th is not None and model.reads_norm_th:
        model.norm_th = norm_th
    try:
        got = model(wpts, torch.tensor(rays["ray_d"]), z, setup["t_frame"])
    finally:
        model.norm_th = saved
    return ref, got, wpts


def assert_tile_matches(setup, ref, got, wpts, th):
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        scale = max(1.0, np.abs(r).max()) if k == "depth_map" else 1.0
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert got["n_candidates"] == int(np.asarray(ref["compact_count"]).sum())
    # the survivors: JAX's exact filter over the same candidates
    frame = setup["t_frame"]
    pose = world_points_to_pose_points(wpts.reshape(-1, 3), frame["R"],
                                       frame["Th"])
    _, jd = sample_blend_closest_points_fused(
        jnp.asarray(pose.numpy()), setup["j_frame"]["pvertices"],
        setup["j_frame"]["weights"])
    from animatable_nerf_tpu_torch.models.common import grid_pdist_keep
    cand = torch.nonzero(grid_pdist_keep(pose, frame, th)).squeeze(1).numpy()
    want = int(np.asarray(keep_mask_with_argmin(np.asarray(jd)[cand, 0],
                                                th)).sum())
    flips = abs(got["n_survivors"] - want)
    assert flips <= MAX_FLIPS
    if flips:
        assert np.sort(np.abs(np.asarray(jd)[cand, 0] - th))[flips - 1] <= FLIP_BAND


@pytest.mark.parametrize("weights", ["composed", "random"])
def test_tile_matches_jax_eval(setup, weights):
    """One tile on the composed weights and on them moved by seeded
    noise: maps, candidates and survivors against JAX's
    `_eval_compacted`."""
    ref, got, wpts = render_tile(setup, setup[weights])
    th = setup["t_eng"].model.norm_th
    assert th == setup["j_eng"].model._filter_th() == 0.1
    assert_tile_matches(setup, ref, got, wpts, th)
    assert got["n_survivors"] > 300
    if weights == "composed":
        assert float(got["acc_map"].max()) > 0.5


def test_norm_th_read_by_lbw_and_pbw_only(setup):
    """At norm_th 0.05 LBW and PBW filter at 0.05 and SMPL and LBWPDF
    still at 0.1, as JAX's `_filter_th`; the tile against JAX's at that
    threshold."""
    family = setup["family"]
    jm = setup["j_eng"].model.clone(norm_th=0.05)
    port = CLASSES[family](num_latents=4, norm_th=0.05)
    assert port.norm_th == jm._filter_th() == (
        0.05 if family in ("lbw", "pbw") else 0.1)
    ref, got, wpts = render_tile(setup, setup["composed"], norm_th=0.05)
    assert_tile_matches(setup, ref, got, wpts, port.norm_th)
    _, at_01, _ = render_tile(setup, setup["composed"])
    fewer = got["n_survivors"] < at_01["n_survivors"]
    assert fewer == (family in ("lbw", "pbw"))
