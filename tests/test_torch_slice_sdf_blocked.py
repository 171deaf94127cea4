"""The `knn_blocked` SDF-PDF evaluation on the CPU: test item 0 of
configs/synthetic_sdf_pdf.yaml rendered with `knn_blocked True` by the
JAX engine and by the port's engine, with tests/test_torch_slice_sdf.py's
options (`knn_grid_res 24`, `eval_tile 1024`).

The port builds each frame's d5 grid and Morton vertex blocks and runs
pass 2 through K5's plain version here. The JAX engine builds them too,
but off the TPU its pass 2 takes the flat KNN (JAX models/common.py:155),
so its render is the flat render: this holds the culled path to it.
Tolerances: those of tests/test_torch_slice_sdf.py, for the same
reasons; the cull itself is exact (no vertex ties on the capsule).
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
from animatable_nerf_tpu_torch.ops import knn

CFG = "configs/synthetic_sdf_pdf.yaml"
OPTS = ["eval_tile", "1024", "knn_grid_res", "24", "knn_blocked", "True"]
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
    j_out, _ = j_eng.render_item(params, j_ds[0])

    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params()
    calls = {"knn_blend_blocked_plain": 0, "knn_blend_plain": 0}
    originals = {name: getattr(knn, name) for name in calls}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return call

    try:
        for name in calls:
            setattr(knn, name, counting(name))
        t_item = t_engine.make_dataset(tc, "test")[0]
        t_out, _ = t_eng.render_item(t_item)
    finally:
        for name, fn in originals.items():
            setattr(knn, name, fn)
    return {"jax": j_out, "port": t_out, "item": t_item, "calls": calls,
            "tiles": t_eng.stats["tiles"], "frame": t_eng._device_frame(t_item),
            "result_dir": result_dir}


def test_blocked_item_maps_match_jax(rendered):
    j_out, t_out = rendered["jax"], rendered["port"]
    for k in ("rgb_map", "acc_map"):
        assert t_out[k].shape == j_out[k].shape, k
        assert np.isfinite(t_out[k]).all(), k
        diff = np.abs(t_out[k] - j_out[k])
        assert diff.max() <= MAP_MAX, (k, diff.max())
        assert (diff > MAP_TOL).mean() <= OUTLIER_SHARE, (k, (diff > MAP_TOL).sum())
    assert t_out["acc_map"].max() > 0.5


def test_blocked_item_psnr_matches_jax(rendered):
    item = rendered["item"]
    args = (np.asarray(item["rgb"]), np.asarray(item["mask_at_box"]),
            int(item["H"]), int(item["W"]))
    ref = JImageEvaluator(rendered["result_dir"]).evaluate(
        rendered["jax"]["rgb_map"], *args, save_images=False)
    got = ImageEvaluator(rendered["result_dir"]).evaluate(
        rendered["port"]["rgb_map"], *args)
    assert abs(got["psnr"] - ref["psnr"]) <= PSNR_TOL_DB
    assert ref["psnr"] > 15.0


def test_blocked_frame_feeds_pass_2(rendered):
    """The frame carries the d5 grid and the Morton blocks of the 6890
    posed vertices, and every tile's pass 2 went through K5's plain
    version, none through K2's."""
    frame = rendered["frame"]
    assert frame["d5_packed"].shape == (23, 23, 23, 8)
    assert frame["knn_verts"].shape == (6912, 3)
    assert frame["knn_values"].shape == (6912, 24)
    assert frame["knn_bboxes"].shape == (54, 8)
    assert rendered["calls"] == {"knn_blend_blocked_plain": rendered["tiles"],
                                 "knn_blend_plain": 0}
