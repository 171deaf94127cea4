"""Pass 1 without the distance grid (`knn_grid_res 0`) on the CPU: the
KNN families' eval tile (models/pdf.py `KNNFamily.forward`) with pass 1
on every point's nearest-vertex distance (kernel K3's contract, its plain
version here) against the JAX package's no-grid tile (models/pdf.py
:171-178, models/aligned.py :243-255, `nearest_distance_fused`), for
NeRF-PDF, NeuS-PDF and AlignedLBW on their tracked or composed weights;
the no-grid tile against the grid tile of the same rays; and the engine
with `knn_blocked True` and no grid, which takes the flat pass 2 as JAX
does.

Tolerances (those of tests/test_torch_pdf_families.py, whose reasons
hold here): a tile's maps within MAP_TOL = 1e-4 on all but 0.1% of the
values and MAP_MAX = 5e-4 on every value (depth relative to its largest
value); the candidate counts equal JAX's pass-1 count, the survivor
counts JAX's exact count. The no-grid tile against the grid tile of the
port: the same survivors, so the same maps to the bit. The engine's
item against the JAX engine's: the same map tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.models.common import keep_mask_with_argmin
from animatable_nerf_tpu_torch.ops.knn import min_dist_plain

MAP_TOL = 1e-4
MAP_MAX = 5e-4
OUTLIER_SHARE = 1e-3
TILE_RAYS = 64
N_SAMPLES = 16
NO_GRID = ["knn_grid_res", "0"]
# family: (config, the flax tree's network with a layer list)
FAMILIES = {
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml", "nerf_network"),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml", "sdf_network"),
    "aligned_lbw": ("configs/synthetic_aligned_lbw.yaml", "nerf_network"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread (its
    module fixtures too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_params(family):
    """The family's weights as flax holds them (the layer list a list)."""
    if family == "aligned_lbw":
        params = compose_aligned("lbw")
    else:
        params = read_checkpoint(
            f"data/trained_model/deform/synthetic_{family}/latest.flax")["params"]
    net = FAMILIES[family][1]
    layers = params["params"][net]["layers"]
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    return {"params": {**params["params"], net: {"layers": layers}}}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def setup(request):
    """Both packages' engines on the family's config without the grid,
    the port's also with the grid at 24^3, their frames of test item 0,
    JAX's model with every point within its compaction capacity, and a
    tile of that item's rays."""
    family = request.param
    cfg = FAMILIES[family][0]
    jc = j_load_config(cfg, NO_GRID, run_type="evaluate")
    tc = load_config(cfg, NO_GRID, run_type="evaluate")
    gc = load_config(cfg, ["knn_grid_res", "24"], run_type="evaluate")
    jc.eval = tc.eval = gc.eval = True
    j_eng = j_engine.Engine(jc)
    j_item = j_engine.make_dataset(jc, "test")[0]
    j_frame = j_eng._device_frame(j_item)
    params = flax_params(family)
    item = t_engine.make_dataset(tc, "test")[0]
    engines = {}
    for name, c in (("no_grid", tc), ("grid", gc)):
        eng = t_engine.Engine(c, "cpu")
        eng.load_params(params)
        engines[name] = (eng, eng._device_frame(item))
    jm = j_eng.model.clone(eval_keep_frac=1.0)
    apply = jax.jit(lambda p, w, v, z, f: jm.apply(
        p, w, v, z, f, train=False, precomposite=True))
    rays = {k: np.asarray(j_item[k], np.float32)[::9][:TILE_RAYS]
            for k in ("ray_o", "ray_d", "near", "far")}
    return {"family": family, "apply": apply, "params": params,
            "j_frame": j_frame, "engines": engines, "rays": rays}


def tile_inputs(setup, shift=0.0):
    rays = dict(setup["rays"])
    rays["ray_o"] = rays["ray_o"] + np.float32([shift, 0.0, 0.0])
    z = stratified_z_vals(torch.tensor(rays["near"]), torch.tensor(rays["far"]),
                          N_SAMPLES)
    wpts = z_vals_to_pts(torch.tensor(rays["ray_o"]), torch.tensor(rays["ray_d"]),
                         z)
    return wpts, torch.tensor(rays["ray_d"]), z


def port_tile(setup, grid, wpts, viewdir, z):
    eng, frame = setup["engines"]["grid" if grid else "no_grid"]
    return eng.model(wpts, viewdir, z, frame)


def assert_maps_match(ref, got):
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        diff = np.abs(g - r) / (1.0 if k != "depth_map" else max(1.0, np.abs(r).max()))
        assert diff.max() <= MAP_MAX, (k, diff.max())
        assert (diff > MAP_TOL).mean() <= OUTLIER_SHARE, (k, (diff > MAP_TOL).sum())


def test_frames_hold_no_grid(setup):
    """Neither package attaches a distance grid at knn_grid_res 0."""
    _, frame = setup["engines"]["no_grid"]
    assert "pdist_packed" not in frame and "pdist_packed" not in setup["j_frame"]
    assert "pdist_packed" in setup["engines"]["grid"][1]


@pytest.mark.parametrize("case", ["body", "beyond_threshold"])
def test_tile_without_grid_matches_jax(setup, case):
    """One tile of item 0 on the body, and 3 away from it, where every
    point lies beyond the threshold and pass 1 keeps only the tile's
    argmin, which pass 2 forces on again: the maps, candidates and
    survivors against JAX's no-grid tile."""
    wpts, viewdir, z = tile_inputs(setup, 3.0 if case != "body" else 0.0)
    ref = setup["apply"](setup["params"], wpts.numpy(), viewdir.numpy(),
                         z.numpy(), setup["j_frame"])
    assert not bool(ref["compact_overflow"])
    got = port_tile(setup, False, wpts, viewdir, z)
    assert_maps_match(ref, got)
    assert got["n_candidates"] == int(np.asarray(ref["compact_count"]).sum())
    if "compact_count_exact" in ref:
        assert got["n_survivors"] == int(
            np.asarray(ref["compact_count_exact"]).sum())
    if case == "body":
        assert got["n_survivors"] > 100
        assert float(got["acc_map"].max()) > 0.3
        return
    # no point under the threshold: the forced argmin alone, the point
    # nearest the posed vertices
    eng, frame = setup["engines"]["no_grid"]
    pose = world_points_to_pose_points(wpts.reshape(-1, 3), frame["R"],
                                       frame["Th"])
    d = min_dist_plain(pose, frame["pvertices"])
    assert float(d.min()) > eng.model.norm_th
    assert got["n_candidates"] == got["n_survivors"] == 1
    assert float(got["acc_map"].max()) < 1e-3


def test_no_grid_keeps_the_grid_survivors(setup):
    """Pass 1 only narrows what pass 2 sees: without the grid the tile
    has fewer candidates (the exact nearest distance, not its grid
    bound), the same survivors and so the same maps, to the bit."""
    wpts, viewdir, z = tile_inputs(setup)
    no_grid = port_tile(setup, False, wpts, viewdir, z)
    grid = port_tile(setup, True, wpts, viewdir, z)
    assert no_grid["n_candidates"] < grid["n_candidates"]
    assert no_grid["n_survivors"] == grid["n_survivors"] > 100
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert torch.equal(no_grid[k], grid[k]), k
    # the candidates are the points the exact distance keeps
    eng, frame = setup["engines"]["no_grid"]
    pose = world_points_to_pose_points(wpts.reshape(-1, 3), frame["R"],
                                       frame["Th"])
    keep = keep_mask_with_argmin(min_dist_plain(pose, frame["pvertices"]),
                                 eng.model.norm_th)
    assert no_grid["n_candidates"] == int(keep.sum())


@pytest.mark.parametrize("res", ["0", "1"])
def test_knn_blocked_without_grid_takes_the_flat_path(res):
    """knn_grid_res <= 1 with knn_blocked True (SDF-PDF): no grid and no
    vertex blocks, as JAX builds them only with a grid, so pass 2 is the
    flat K2; the engine's item (a cut of item 0) equals the render
    without knn_blocked to the bit and the JAX engine's render of it."""
    cfg = "configs/synthetic_sdf_pdf.yaml"
    opts = ["knn_grid_res", res, "knn_blocked", "True", "eval_tile", "256",
            "N_samples", str(N_SAMPLES)]
    tc = load_config(cfg, opts, run_type="evaluate")
    tc.eval = True
    eng = t_engine.Engine(tc, "cpu")
    eng.load_params()
    assert not eng.knn_blocked and eng.pdist_res == 0
    item = dict(t_engine.make_dataset(tc, "test")[0])
    for k in ("ray_o", "ray_d", "near", "far"):
        item[k] = np.asarray(item[k])[::12]
    out, _ = eng.render_item(item)
    frame = eng._device_frame(item)
    assert not {"pdist_packed", "d5_packed", "knn_verts"} & set(frame)
    flat = t_engine.Engine(load_config(cfg, opts[:2] + opts[4:],
                                       run_type="evaluate"), "cpu")
    flat.load_params()
    want, _ = flat.render_item(item)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    assert eng.stats == flat.stats and eng.stats["n_survivors"] > 100
    if res == "1":
        return
    jc = j_load_config(cfg, opts, run_type="evaluate")
    jc.eval = True
    j_eng = j_engine.Engine(jc)
    j_params = j_eng.load_params(j_eng.init_params(jax.random.PRNGKey(0)))
    j_out, _ = j_eng.render_item(j_params, item)
    assert_maps_match(j_out, {k: torch.as_tensor(v) for k, v in out.items()})
