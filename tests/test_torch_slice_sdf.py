"""The SDF-PDF evaluation slice end to end, on the CPU: test item 0
(frame 0, view 3) of configs/synthetic_sdf_pdf.yaml rendered from the
tracked checkpoint by the JAX engine and by the port's engine, then
scored by both evaluators. `knn_grid_res 24` keeps the CPU build of the
per-frame distance grid cheap; `eval_tile 1024` cuts the item into
several tiles, so the stride interleave and the per-tile argmin forcing
are exercised.

Tolerances: |d rgb_map|, |d acc_map| <= 1e-4 on all but 0.1% of the
values and <= 5e-4 on every value (float32; an 8x256 displacement MLP, a
9x256 SDF network with autograd normals and the color network, summed
in another order; and the KNN blend by differences against JAX's matmul
form off the TPU, which can move a point at the 0.1 filter edge).
Measured: 2 of 15,759 rgb values and 1 of 5,253 acc values exceed 1e-4,
at most 3.0e-4 and 1.9e-4. |d PSNR| <= 0.01 dB against the same ground
truth.
"""

import jax
import numpy as np
import pytest

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.evaluators.image import ImageEvaluator as JImageEvaluator

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator
from animatable_nerf_tpu_torch.models.pdf import SDFPDF

CFG = "configs/synthetic_sdf_pdf.yaml"
OPTS = ["eval_tile", "1024", "knn_grid_res", "24"]
MAP_TOL = 1e-4
MAP_MAX = 5e-4
OUTLIER_SHARE = 1e-3
PSNR_TOL_DB = 0.01


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    result_dir = str(tmp_path_factory.mktemp("result"))
    opts = OPTS + ["result_dir", result_dir]
    jc = j_load_config(CFG, opts, run_type="evaluate")
    tc = load_config(CFG, opts, run_type="evaluate")
    jc.eval = tc.eval = True

    j_eng = j_engine.Engine(jc)
    j_ds = j_engine.make_dataset(jc, "test")
    params = j_eng.load_params(j_eng.init_params(jax.random.PRNGKey(0), j_ds))
    j_out, j_n = j_eng.render_item(params, j_ds[0])

    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params()
    assert isinstance(t_eng.model, SDFPDF)
    tiles = []
    forward = t_eng.model.forward

    def record_tile(*args, **kwargs):
        out = forward(*args, **kwargs)
        tiles.append((out["n_candidates"], out["n_survivors"]))
        return out

    t_eng.model.forward = record_tile
    t_item = t_engine.make_dataset(tc, "test")[0]
    t_out, t_n = t_eng.render_item(t_item)
    assert j_n == t_n == len(t_item["ray_o"])
    return {"jax": j_out, "port": t_out, "item": t_item, "tiles": tiles,
            "frame": t_eng._device_frame(t_item), "result_dir": result_dir}


def test_item_maps_match_jax(rendered):
    j_out, t_out = rendered["jax"], rendered["port"]
    for k in ("rgb_map", "acc_map"):
        assert t_out[k].shape == j_out[k].shape, k
        assert np.isfinite(t_out[k]).all(), k
        diff = np.abs(t_out[k] - j_out[k])
        assert diff.max() <= MAP_MAX, (k, diff.max())
        assert (diff > MAP_TOL).mean() <= OUTLIER_SHARE, (k, (diff > MAP_TOL).sum())
    assert t_out["acc_map"].max() > 0.5


def test_every_tile_has_an_exact_survivor(rendered):
    """The argmin forcing of the two filter passes only decides a tile
    without exact survivors; JAX's dense ladder rung forces over the
    whole tile, its compacted path (and the port) over the pass-1
    candidates. Every tile keeps more than its forced point, so the
    semantics agree; pass 1 is a superset of the exact survivors."""
    tiles = rendered["tiles"]
    assert len(tiles) > 1
    assert min(s for _, s in tiles) > 1, tiles
    assert all(c >= s for c, s in tiles)
    frame = rendered["frame"]
    assert frame["pdist_packed"].shape == (23, 23, 23, 8)


def test_item_psnr_matches_jax(rendered):
    item = rendered["item"]
    args = (np.asarray(item["rgb"]), np.asarray(item["mask_at_box"]),
            int(item["H"]), int(item["W"]))
    ref = JImageEvaluator(rendered["result_dir"]).evaluate(
        rendered["jax"]["rgb_map"], *args, save_images=False)
    got = ImageEvaluator(rendered["result_dir"]).evaluate(
        rendered["port"]["rgb_map"], *args)
    assert abs(got["psnr"] - ref["psnr"]) <= PSNR_TOL_DB
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    assert ref["psnr"] > 15.0


def test_cli_evaluates_sdf_pdf_on_cpu(tmp_path, monkeypatch):
    """`python -m animatable_nerf_tpu_torch.run --type evaluate` on the
    SDF-PDF config (cut to one item) dispatches to the SDF-PDF model and
    the PDF dataset, scores and writes metrics.npy."""
    from animatable_nerf_tpu_torch import run

    runs = []
    real = t_engine.run_evaluate

    def one_item(cfg, device):
        runs.append((cfg, device, real(cfg, device, max_items=1)))

    monkeypatch.setattr(t_engine, "run_evaluate", one_item)
    run.main(["--type", "evaluate", "--cfg_file", CFG, "--device", "cpu",
              *OPTS, "result_dir", str(tmp_path)])
    (cfg, device, res), = runs
    assert device == "cpu" and cfg.network_module == "sdf_pdf"
    assert len(res["items"]) == 1 and res["psnr"] > 15.0
    assert res["items"][0]["n_survivors"] > 0
    assert (tmp_path / cfg.task / cfg.exp_name / "metrics.npy").exists()


@pytest.mark.parametrize("run_type,opts", [
    ("train", ["network_module", "nerf_pdf", "aninerf_animation", "True"]),
    ("train", ["network_module", "neus_pdf", "aninerf_animation", "True"])])
def test_options_not_ported_yet_raise(run_type, opts, tmp_path):
    """Options the port lacks raise before any work: the stage-2
    (novel-pose) training of the NeRF-PDF and NeuS-PDF families (their
    stage 1 is ported)."""
    cfg = load_config(CFG, opts + ["trained_model_dir", str(tmp_path / "m"),
                                   "record_dir", str(tmp_path / "r")],
                      run_type=run_type)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        t_engine.run_train(cfg, "cpu")
    assert not (tmp_path / "m").exists() and not (tmp_path / "r").exists()


def render_tile(rendered, opts=()):
    """256 of the item's rays (every 16th, across the body), one tile of
    `eval_tile 256`, through an engine on the config with `opts`:
    (maps, stats)."""
    cfg = load_config(CFG, OPTS + ["eval_tile", "256"] + list(opts),
                      run_type="evaluate")
    cfg.eval = True
    eng = t_engine.Engine(cfg, "cpu")
    eng.load_params()
    item = dict(rendered["item"])
    for k in ("ray_o", "ray_d", "near", "far"):
        item[k] = np.asarray(item[k])[::16][:int(cfg.eval_tile)]
    out, _ = eng.render_item(item)
    return out, eng.stats


@pytest.fixture(scope="module")
def plain_tile(rendered):
    return render_tile(rendered)


@pytest.mark.parametrize("opts", [["seg_filter", "True"], ["slab_filter", "8"]])
def test_filter_keys_render_the_item_as_without_them(plain_tile, rendered,
                                                     opts):
    """JAX's make_model passes seg_filter to no model and slab_filter to
    AniNeRF alone, so the SDF-PDF item (one tile of it, to keep the CPU
    run short) renders exactly as without them."""
    out, stats = render_tile(rendered, opts)
    assert stats == plain_tile[1]
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.array_equal(out[k], plain_tile[0][k]), k


def test_importance_sampling_renders_the_item(plain_tile, rendered):
    """`use_importance` (here N_importance 16) on one tile of the item:
    the coarse pass, the fine samples from its weights, the fine pass on
    the union, with more survivors than the stratified render and
    finite maps that differ from it (SDF-PDF's alpha takes a fixed
    step, so denser samples add opacity). The tiles are held to JAX's
    render_rays in tests/test_torch_eval_options.py."""
    out, stats = render_tile(rendered, ["use_importance", "True",
                                        "N_importance", "16"])
    assert stats["n_survivors"] > plain_tile[1]["n_survivors"] > 0
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert np.isfinite(out[k]).all(), k
    assert not np.array_equal(out["rgb_map"], plain_tile[0]["rgb_map"])
    assert out["acc_map"].max() > 0.5
