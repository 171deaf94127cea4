"""The port's host side against the JAX package and the libraries it
replaces (PyYAML, cv2, flax.serialization), plus the import guard and
the device rule of the entry points.
"""

import ast
import glob
import os

import cv2
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data import FrameSampler as JFrameSampler
from animatable_nerf_tpu.data.dataset import TPoseDataset as JTPoseDataset
from animatable_nerf_tpu.data.utils import erode_mask_edge as j_erode

from animatable_nerf_tpu_torch import device as t_device
from animatable_nerf_tpu_torch.compat.flax_msgpack import msgpack_restore
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.config.yaml_lite import load_file
from animatable_nerf_tpu_torch.data.dataset import TPoseDataset
from animatable_nerf_tpu_torch.data.decode_cache import (
    ARCHIVE, DecodedImages, image_files,
)
from animatable_nerf_tpu_torch.data.loader import FrameSampler
from animatable_nerf_tpu_torch.data.utils import erode_mask_edge
from animatable_nerf_tpu_torch.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True)
)
DATA_ROOT = "data/synthetic/human"
CKPT = "data/trained_model/deform/synthetic/latest.flax"


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_lite_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        ref = yaml.safe_load(f)
    assert load_file(os.path.join(ROOT, path)) == ref


@pytest.mark.parametrize("cfg_file,opts", [
    ("configs/synthetic.yaml", []),
    ("configs/synthetic.yaml", ["eval_tile", "2048", "test.epoch", "3",
                                "exp_name", "313", "norm_th", "0.1"]),
    ("configs/aninerf_313.yaml", []),
    ("configs/sdf_pdf/anisdf_pdf_s9p.yaml", ["vis_posed_mesh", "True"]),
])
def test_load_config_matches_jax(cfg_file, opts):
    got = load_config(cfg_file, opts, run_type="evaluate")
    ref = j_load_config(cfg_file, opts, run_type="evaluate")
    assert got == ref


def test_decoded_archive_equals_cv2():
    """Every image under the root is in decoded.npz, equal to
    cv2.imread(..., IMREAD_UNCHANGED) of its file."""
    store = DecodedImages(DATA_ROOT)
    files = image_files(DATA_ROOT)
    assert len(files) == 32
    with np.load(os.path.join(DATA_ROOT, ARCHIVE)) as z:
        assert len(z.files) == len(files)
    for path in files:
        np.testing.assert_array_equal(
            store.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
        )


def _eval_cfgs():
    tc = load_config("configs/synthetic.yaml", [], run_type="evaluate")
    jc = j_load_config("configs/synthetic.yaml", [], run_type="evaluate")
    tc.eval = jc.eval = True
    return tc, jc


# arrays that go through float32 4x4 products in another order
_FLOAT_CHAIN = ("A", "big_A")


def test_test_item_matches_jax_dataset():
    """Test-split item 0, array by array: bit-equal except the bone
    transforms (24 chained float32 4x4 products, rtol/atol 1e-6)."""
    tc, jc = _eval_cfgs()
    t_ds, j_ds = TPoseDataset(tc, "test"), JTPoseDataset(jc, "test")
    assert len(t_ds) == len(j_ds) == 4
    got, ref = t_ds[0], j_ds[0]
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k in _FLOAT_CHAIN:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    t_order = list(FrameSampler(t_ds, interval=1, default_count=4))
    j_order = list(JFrameSampler(j_ds, interval=1, default_count=4))
    assert t_order == j_order == [0, 1, 2, 3]


@pytest.mark.parametrize("border", [5, 10])
def test_erode_mask_edge_matches_cv2(border):
    rng = np.random.RandomState(border)
    masks = [cv2.imread(p, cv2.IMREAD_UNCHANGED) != 0
             for p in sorted(glob.glob(f"{DATA_ROOT}/mask_cihp/*/*.png"))[:4]]
    masks += [rng.rand(37, 53) < 0.5, np.ones((20, 30), bool)]
    for m in masks:
        m = m.astype(np.uint8)
        np.testing.assert_array_equal(erode_mask_edge(m, border), j_erode(m, border))


def test_flax_msgpack_matches_flax():
    with open(CKPT, "rb") as f:
        blob = f.read()
    got = msgpack_restore(blob)
    ref = serialization.msgpack_restore(blob)

    def same(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, path
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    same(got, ref, "")
    assert got["params"]["params"]["bw_field"]["mlp"]["lin5"]["kernel"].shape == (447, 256)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_device.select_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_device.select_device("cuda")
    cfg, _ = _eval_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg)
    assert t_device.select_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert Engine(cfg, "cpu").device.type == "cpu"


_FORBIDDEN = ("jax", "flax", "animatable_nerf_tpu", "jaxlib", "optax",
              # none of these is on the card's machine
              "PIL", "yaml", "msgpack",
              # the repository's tools/ that the port has its copies of
              "convert_vgg_weights", "prepare_lbs_meta", "prepare_blend_weights",
              "render_uv_maps", "render_skeleton", "import_torch_checkpoint")


def _forbidden(name: str) -> bool:
    """A top-level module of _FORBIDDEN, or one of the repository's
    tools/ imported as `tools.<name>`."""
    parts = name.split(".")
    return parts[0] in _FORBIDDEN or (parts[0] == "tools" and len(parts) > 1
                                      and parts[1] in _FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    """AST scan: the port package and chip_smoke.py import no jax, flax
    or animatable_nerf_tpu module, no PIL, PyYAML or msgpack, and none of
    the repository's tools/ that the port copies (relative imports stay
    in the port)."""
    files = glob.glob(os.path.join(ROOT, "animatable_nerf_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    bad = [
        (os.path.relpath(f, ROOT), name)
        for f in files for name in _imports(f)
        if _forbidden(name)
    ]
    assert not bad, bad


def test_port_imports_no_cv2_outside_the_archive_writer():
    """AST scan: the port and chip_smoke.py import no cv2, which the
    card's machine lacks (data/camera.py does its undistort and resizes).
    Only data/decode_cache.py's `write_archive`, run once on a machine
    with OpenCV, decodes the image files with it."""
    files = glob.glob(os.path.join(ROOT, "animatable_nerf_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    writer = os.path.join("animatable_nerf_tpu_torch", "data", "decode_cache.py")
    bad = [
        (os.path.relpath(f, ROOT), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] == "cv2" and os.path.relpath(f, ROOT) != writer
    ]
    assert not bad, bad
    assert any(name == "cv2" for name in _imports(os.path.join(ROOT, writer)))
