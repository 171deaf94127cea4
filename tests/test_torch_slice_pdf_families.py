"""The NeRF-PDF and NeuS-PDF evaluation slices end to end, on the CPU:
test item 0 (frame 0, view 3) of configs/synthetic_nerf_pdf.yaml and
configs/synthetic_neus_pdf.yaml rendered from the tracked checkpoints by
the JAX engine and by the port's CLI (`python -m
animatable_nerf_tpu_torch.run --type evaluate --device cpu`, cut to that
item), then scored by both evaluators. `knn_grid_res 24` keeps the CPU
build of the per-frame distance grid cheap; `eval_tile 1024` cuts the
item into several tiles, so the stride interleave and the per-tile
argmin forcing are exercised.

Tolerances: |d rgb_map|, |d acc_map| <= 1e-4 (float32; 8x256 and 9x256
stacks summed in another order) on all but 0.1% of the rays, and those
rays each hold a kept sample whose 5th and 6th nearest posed vertices
lie within TIE_BAND in squared distance. JAX's KNN off the TPU takes
distances in the matmul form |q|^2 - 2 q.v + |v|^2, whose float32
rounding (a few ulps of |q|^2 + |v|^2, under 1 here) can order such a
near-tie the other way than the port's differences; the other 5th
neighbour moves that sample's blend weights, hence its canonical point,
and a trained NeRF's color there, by far more than rounding (measured:
3 rays of 5253 on NeRF-PDF's item 0, at most 5.2e-4, ties within
1.3e-7). |d PSNR| <= 0.01 dB against the same ground truth; the largest
candidate and survivor counts of a tile equal to the JAX engine's
worst-tile pass-1 and exact counts, which its programs return (each
tile's own counts are held to JAX's in tests/test_torch_pdf_families.py).
"""

import jax
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.evaluators.image import ImageEvaluator as JImageEvaluator

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import run
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator
from animatable_nerf_tpu_torch.models.pdf import NeRFPDF, NeuSPDF

OPTS = ["eval_tile", "1024", "knn_grid_res", "24"]
MAP_TOL = 1e-4
OUTLIER_SHARE = 1e-3
TIE_BAND = 1e-6
NORM_TH = 0.1
N_SAMPLES = 64  # the configs' N_samples
PSNR_TOL_DB = 0.01
FAMILIES = {"nerf_pdf": NeRFPDF, "neus_pdf": NeuSPDF}


@pytest.fixture(autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg_file(family):
    return f"configs/synthetic_{family}.yaml"


def jax_render(family, opts):
    """The JAX engine's render of test item 0 and its worst tile's
    (pass-1, exact) survivor counts, from its last (non-overflowing)
    program."""
    jc = j_load_config(cfg_file(family), opts, run_type="evaluate")
    jc.eval = True
    eng = j_engine.Engine(jc)
    ds = j_engine.make_dataset(jc, "test")
    params = eng.load_params(eng.init_params(jax.random.PRNGKey(0), ds))
    ladder, counts = eng._run_ladder, []

    def recording(run_at):
        def run_counted(frac):
            out = run_at(frac)
            counts.append((int(np.asarray(out["compact_count"]).max()),
                           int(np.asarray(out["compact_count_exact"]).max())))
            return out
        return ladder(run_counted)

    eng._run_ladder = recording
    out, n = eng.render_item(params, ds[0])
    return out, n, counts[-1]


def port_cli_render(family, opts, monkeypatch):
    """The port's CLI on the CPU, cut to test item 0: the run's config,
    device and metrics, the item and its maps, and each tile's counts."""
    runs, renders, tiles = [], [], []
    real_eval, real_render = t_engine.run_evaluate, t_engine.Engine.render_item

    def one_item(cfg, device):
        runs.append((cfg, device, real_eval(cfg, device, max_items=1)))

    def render_item(eng, item):
        forward = eng.model.forward

        def record_tile(*args, **kwargs):
            out = forward(*args, **kwargs)
            tiles.append((out["n_candidates"], out["n_survivors"]))
            return out

        eng.model.forward = record_tile
        out = real_render(eng, item)
        renders.append((type(eng.model), item, out))
        return out

    with monkeypatch.context() as m:
        m.setattr(t_engine, "run_evaluate", one_item)
        m.setattr(t_engine.Engine, "render_item", render_item)
        run.main(["--type", "evaluate", "--cfg_file", cfg_file(family),
                  "--device", "cpu", *opts])
    (cfg, device, res), = runs
    (model_type, item, (out, n)), = renders
    return {"cfg": cfg, "device": device, "res": res, "model": model_type,
            "item": item, "maps": out, "n": n, "tiles": tiles}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def rendered(request, tmp_path_factory):
    family = request.param
    result_dir = tmp_path_factory.mktemp("result")
    opts = OPTS + ["result_dir", str(result_dir)]
    j_out, j_n, j_tiles = jax_render(family, opts)
    with pytest.MonkeyPatch.context() as monkeypatch:
        port = port_cli_render(family, opts, monkeypatch)
    assert j_n == port["n"] == len(port["item"]["ray_o"])
    return {"family": family, "jax": j_out, "jax_tiles": j_tiles,
            "result_dir": result_dir, **port}


def near_tie_rays(item, rays):
    """For each of the item's `rays`, whether one of its samples passes
    the exact filter (the port's plain KNN) with its 5th and 6th nearest
    posed vertices within TIE_BAND in squared distance."""
    from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
    from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
    from animatable_nerf_tpu_torch.core.sampling import (
        stratified_z_vals,
        z_vals_to_pts,
    )

    def rows(key):
        return torch.tensor(np.asarray(item[key], np.float32)[rays])

    z = stratified_z_vals(rows("near"), rows("far"), N_SAMPLES)
    pts = world_points_to_pose_points(
        z_vals_to_pts(rows("ray_o"), rows("ray_d"), z).reshape(-1, 3),
        torch.tensor(np.asarray(item["R"], np.float32)),
        torch.tensor(np.asarray(item["Th"], np.float32)))
    verts = torch.tensor(np.asarray(item["pvertices"], np.float32))
    _, wdist = sample_blend_closest_points(
        pts, verts, torch.tensor(np.asarray(item["weights"], np.float32)))
    d2 = torch.topk(((pts[:, None] - verts[None]) ** 2).sum(-1), 6, dim=1,
                    largest=False).values
    tied = (wdist[:, 0] < NORM_TH) & (d2[:, 5] - d2[:, 4] < TIE_BAND)
    return tied.reshape(len(rays), -1).any(1).numpy()


def test_item_maps_match_jax(rendered):
    j_out, t_out = rendered["jax"], rendered["maps"]
    off = np.zeros(len(t_out["acc_map"]), bool)
    for k in ("rgb_map", "acc_map"):
        assert t_out[k].shape == j_out[k].shape, k
        assert np.isfinite(t_out[k]).all(), k
        diff = np.abs(t_out[k] - j_out[k]).reshape(len(off), -1).max(1)
        off |= diff > MAP_TOL
    assert off.mean() <= OUTLIER_SHARE, off.sum()
    rays = np.nonzero(off)[0]
    assert near_tie_rays(rendered["item"], rays).all(), rays
    assert t_out["acc_map"].max() > 0.5


def test_worst_tile_counts_match_jax(rendered):
    tiles = rendered["tiles"]
    assert len(tiles) > 1 and min(s for _, s in tiles) > 1
    assert all(c >= s for c, s in tiles)
    assert (max(c for c, _ in tiles), max(s for _, s in tiles)) == rendered["jax_tiles"]


def test_item_psnr_matches_jax(rendered):
    item = rendered["item"]
    args = (np.asarray(item["rgb"]), np.asarray(item["mask_at_box"]),
            int(item["H"]), int(item["W"]))
    ref = JImageEvaluator(str(rendered["result_dir"])).evaluate(
        rendered["jax"]["rgb_map"], *args, save_images=False)
    got = ImageEvaluator(str(rendered["result_dir"])).evaluate(
        rendered["maps"]["rgb_map"], *args)
    assert abs(got["psnr"] - ref["psnr"]) <= PSNR_TOL_DB
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    assert ref["psnr"] > 15.0
    assert rendered["res"]["psnr"] == pytest.approx(got["psnr"])


def test_cli_evaluates_on_cpu(rendered):
    """The CLI dispatched the family's config to its model and the PDF
    dataset on the CPU, scored the item and wrote metrics.npy."""
    cfg, res = rendered["cfg"], rendered["res"]
    assert rendered["device"] == "cpu"
    assert cfg.network_module == rendered["family"]
    assert rendered["model"] is FAMILIES[rendered["family"]]
    assert len(res["items"]) == 1 and res["items"][0]["n_survivors"] > 0
    assert res["items"][0]["n_survivors"] == sum(s for _, s in rendered["tiles"])
    assert (rendered["result_dir"] / cfg.task / cfg.exp_name
            / "metrics.npy").exists()


@pytest.mark.parametrize("cfg_path,opts,match", [
    ("configs/synthetic.yaml", ["init_sdf", "synthetic_sdf_pdf"],
     "init_sdf loads an SDF network; AniNeRF has none"),
    (cfg_file("nerf_pdf"), ["init_sdf", "synthetic_sdf_pdf"],
     "init_sdf loads an SDF network; NeRFPDF has none")])
def test_run_train_refuses_before_any_work(cfg_path, opts, match, tmp_path):
    """`run_train` refuses an `init_sdf` on a family without an SDF
    network (where JAX's non-strict partial load reads nothing) before
    it builds a model or a directory."""
    cfg = load_config(
        cfg_path, opts + ["trained_model_dir", str(tmp_path / "m"),
                          "record_dir", str(tmp_path / "r")],
        run_type="train")
    with pytest.raises(NotImplementedError, match=match):
        t_engine.run_train(cfg, "cpu")
    assert not (tmp_path / "m").exists() and not (tmp_path / "r").exists()
