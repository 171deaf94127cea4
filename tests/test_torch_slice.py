"""The evaluation slice end to end, on the CPU: test item 0 (frame 0,
view 3) of configs/synthetic.yaml rendered from the tracked checkpoint
by the JAX engine and by the port's engine, then scored by both
evaluators.

Tolerances: max |d rgb_map|, |d acc_map| <= 1e-4 (float32; two chained
8x256 MLPs, an LBS inverse and 64-sample compositing summed in another
order), and |d PSNR| <= 0.01 dB against the same ground truth.
"""

import jax
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.evaluators.image import ImageEvaluator as JImageEvaluator

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator

CFG = "configs/synthetic.yaml"
# small tiles: 7400 rays pad to 8 tiles of 1024, so the stride
# interleave and the per-tile argmin forcing are exercised
OPTS = ["eval_tile", "1024"]
MAP_TOL = 1e-4
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
    j_item = j_ds[0]
    j_out, j_n = j_eng.render_item(params, j_item)

    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params()
    tiles = []
    forward = t_eng.model.forward

    def record_tile(*args, **kwargs):
        out = forward(*args, **kwargs)
        tiles.append(out["n_survivors"])
        return out

    t_eng.model.forward = record_tile
    t_item = t_engine.make_dataset(tc, "test")[0]
    t_out, t_n = t_eng.render_item(t_item)
    assert j_n == t_n == len(t_item["ray_o"])
    return {"jax": j_out, "port": t_out, "item": t_item, "tiles": tiles,
            "result_dir": result_dir}


def test_item_maps_match_jax(rendered):
    j_out, t_out = rendered["jax"], rendered["port"]
    for k in ("rgb_map", "acc_map"):
        assert t_out[k].shape == j_out[k].shape, k
        assert np.isfinite(t_out[k]).all(), k
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    assert t_out["acc_map"].max() > 0.5


def test_every_tile_has_an_exact_survivor(rendered):
    """The argmin forcing of the two filter passes only decides the
    result of a tile without exact survivors; the JAX capacity ladder's
    dense rung forces over the whole tile, the compacted path (and the
    port) over the pass-1 candidates. Every tile of this item keeps more
    than the one forced point, so both semantics give the same maps."""
    tiles = rendered["tiles"]
    assert len(tiles) == 8
    assert min(tiles) > 1, tiles


def test_item_psnr_ssim_match_jax(rendered):
    item = rendered["item"]
    args = (np.asarray(item["rgb"]), np.asarray(item["mask_at_box"]),
            int(item["H"]), int(item["W"]))
    j_ev = JImageEvaluator(rendered["result_dir"])
    ref = j_ev.evaluate(rendered["jax"]["rgb_map"], *args, save_images=False)
    # both evaluators on the same prediction: the metric code agrees
    same = ImageEvaluator(rendered["result_dir"]).evaluate(
        rendered["jax"]["rgb_map"], *args)
    np.testing.assert_allclose(same["psnr"], ref["psnr"], rtol=1e-12)
    np.testing.assert_allclose(same["ssim"], ref["ssim"], rtol=1e-12)
    # the port's render scored by the port
    t_ev = ImageEvaluator(rendered["result_dir"])
    got = t_ev.evaluate(rendered["port"]["rgb_map"], *args)
    assert abs(got["psnr"] - ref["psnr"]) <= PSNR_TOL_DB
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    summary = t_ev.summarize()
    assert summary["psnr"] == pytest.approx(got["psnr"])


def test_cli_evaluates_on_cpu(tmp_path, monkeypatch):
    """`python -m animatable_nerf_tpu_torch.run --type evaluate` (cut to
    one item): the run type dispatches, scores and writes metrics.npy."""
    from animatable_nerf_tpu_torch import run

    runs = []
    real = t_engine.run_evaluate

    def one_item(cfg, device):
        runs.append((cfg, device, real(cfg, device, max_items=1)))

    monkeypatch.setattr(t_engine, "run_evaluate", one_item)
    run.main(["--type", "evaluate", "--cfg_file", CFG, "--device", "cpu",
              *OPTS, "result_dir", str(tmp_path)])
    (cfg, device, res), = runs
    assert device == "cpu"
    assert len(res["items"]) == 1 and np.isfinite(res["psnr"])
    assert (tmp_path / cfg.task / cfg.exp_name / "metrics.npy").exists()
    with pytest.raises(SystemExit, match="unknown --type"):
        run.main(["--type", "train", "--cfg_file", CFG, "--device", "cpu"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
