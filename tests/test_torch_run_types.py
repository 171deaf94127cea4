"""The port's other run types on the CPU (`python -m
animatable_nerf_tpu_torch.run --type dataset | network | evaluate_nv |
lpips | light_stage`) and their host pieces, against the JAX package
(engine.py:699-746, :910-943; run.py:64-94; evaluators/lpips.py;
tools/convert_lpips_weights.py; tools/ply_to_occupancy.py) and the
libraries the port's machines lack (cv2, PIL).

Tolerances:
  * `read_png`: equal to cv2.imread(path)[..., ::-1] bit for bit, on
    PNGs written by cv2, by PIL and by hand (each row filter, several
    IDAT chunks).
  * `evaluate_nv`: the same metrics as JAX's `run_evaluate_external` on
    the same PNG directory (rtol 1e-12: the same numpy on equal inputs).
  * LPIPS: the port's converter writes JAX's .npz exactly; the distances
    within LPIPS_TOL (1e-5) of JAX's on seeded weights at 64x64 (float32
    convolutions summed in another order).
  * `light_stage`: the .npz files equal to JAX's native path byte for
    byte in `compressed_occupancies` and `bounds`.
The runs use the tracked AniNeRF checkpoint of configs/synthetic.yaml on
the human subject at ratio 0.25 (32x32 views).
"""

import json
import os
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.evaluators import lpips as j_lpips

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import run as t_run
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.evaluators import lpips as t_lpips
from animatable_nerf_tpu_torch.visualizers.image import read_png, write_png

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import convert_lpips_weights as j_convert  # noqa: E402
import ply_to_occupancy as j_p2o  # noqa: E402

CFG = "configs/synthetic.yaml"
NHR_CFG = "configs/synthetic_nhr.yaml"
SMALL = ["ratio", "0.25", "N_samples", "16", "eval_tile", "256",
         "test_view", "[3]", "test.num_sampler_ind", "3"]
LPIPS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Module scope, so that it holds before the module fixtures."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cli(*args, device="cpu"):
    return t_run.main(["--device", device, *args])


def no_work(*_a, **_k):
    raise AssertionError("work started")


# ------------------------------------------------------------------ PNG
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def encode_png(path, img, filters, chunks=1):
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG whose row y takes
    filter filters[y % len(filters)], its data split into `chunks` IDAT
    chunks."""
    h, w, _ = img.shape
    raw = img.reshape(h, 3 * w).astype(np.int64)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur, up = raw[y], raw[y - 1] if y else np.zeros(3 * w, np.int64)
        out = []
        for i in range(3 * w):
            a = cur[i - 3] if i >= 3 else 0
            c = up[i - 3] if i >= 3 else 0
            pred = (0, a, up[i], (a + up[i]) // 2, _paeth(a, up[i], c))[kind]
            out.append((cur[i] - pred) % 256)
        rows.append(bytes([kind] + out))
    data = zlib.compress(b"".join(rows))
    cut = np.linspace(0, len(data), chunks + 1).astype(int)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    blob = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[s:e]) for s, e in zip(cut, cut[1:]))
            + chunk(b"IEND", b""))
    Path(path).write_bytes(blob)


_RNG = np.random.RandomState(5)
_NOISE = _RNG.randint(0, 256, (19, 27, 3)).astype(np.uint8)
_YY, _XX = np.mgrid[:19, :27]
_SMOOTH = np.stack([_XX * 9, _YY * 13, (_XX + _YY) * 5], -1).astype(np.uint8)


def _rgba(im):
    return np.concatenate([im, im[..., 1:2]], -1)


# name -> writer of an image (cv2 takes BGR, so the files' colours differ
# from the array's; the comparison is with cv2.imread of the file)
PNG_WRITERS = {
    "cv2_grey": lambda p, im: cv2.imwrite(p, im[..., 0]),
    "cv2_rgb": lambda p, im: cv2.imwrite(p, im),
    "cv2_rgba": lambda p, im: cv2.imwrite(p, _rgba(im)),
    "cv2_rgb16": lambda p, im: cv2.imwrite(
        p, im.astype(np.uint16) * 255 + im[..., ::-1].astype(np.uint16)),
    "pil_grey": lambda p, im: Image.fromarray(im[..., 0]).save(p),
    "pil_grey_alpha": lambda p, im: Image.fromarray(im[..., :2], "LA").save(p),
    "pil_rgb": lambda p, im: Image.fromarray(im).save(p, optimize=True),
    "pil_rgba": lambda p, im: Image.fromarray(_rgba(im)).save(p),
    "pil_palette": lambda p, im: Image.fromarray(im).convert(
        "P", palette=Image.ADAPTIVE, colors=200).save(p),
    "pil_palette_4bit": lambda p, im: Image.fromarray(im).convert(
        "P", palette=Image.ADAPTIVE, colors=12).save(p),
    "pil_1bit": lambda p, im: Image.fromarray(im[..., 0] > 100).save(p),
}


@pytest.mark.parametrize("content", ["noise", "smooth"])
@pytest.mark.parametrize("writer", sorted(PNG_WRITERS))
def test_read_png_equals_cv2(writer, content, tmp_path):
    path = str(tmp_path / f"{writer}.png")
    PNG_WRITERS[writer](path, _NOISE if content == "noise" else _SMOOTH)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (19, 27, 3)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("filters,chunks", [
    ((0,), 1), ((1,), 1), ((2,), 1), ((3,), 1), ((4,), 1),
    ((4, 3, 2, 1, 0), 3)])
def test_read_png_undoes_every_row_filter(filters, chunks, tmp_path):
    path = str(tmp_path / "f.png")
    for img in (_NOISE, _SMOOTH):
        encode_png(path, img, filters, chunks)
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)


def test_read_png_reads_write_png_and_refuses_adam7(tmp_path):
    path = str(tmp_path / "own.png")
    write_png(path, _NOISE)
    np.testing.assert_array_equal(read_png(path), _NOISE)
    blob = bytearray(Path(path).read_bytes())
    blob[28] = 1  # IHDR's interlace byte
    blob[29:33] = struct.pack(">I", zlib.crc32(bytes(blob[12:29])) & 0xFFFFFFFF)
    Path(path).write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="Adam7"):
        read_png(path)


# ---------------------------------------------------------- evaluate_nv
def _write_predictions(pred_dir, frames):
    os.makedirs(pred_dir, exist_ok=True)
    rng = np.random.RandomState(1)
    for f in frames:
        cv2.imwrite(os.path.join(pred_dir, f"frame{f:04d}_view0003.png"),
                    rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))


def test_evaluate_nv_matches_jax(tmp_path):
    """Frames 0 and 2 have a prediction, frame 1 none (skipped): the
    metrics of both packages' readers and evaluators on the same files."""
    pred_dir = str(tmp_path / "pred")
    _write_predictions(pred_dir, (0, 2))
    cfg = load_config(CFG, SMALL + ["result_dir", str(tmp_path / "port")])
    got = t_engine.run_evaluate_external(cfg, pred_dir=pred_dir)
    jc = j_load_config(CFG, SMALL + ["result_dir", str(tmp_path / "jax")])
    want = j_engine.run_evaluate_external(jc, pred_dir=pred_dir)
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    per = np.load(os.path.join(cfg.result_dir, "metrics.npy"),
                  allow_pickle=True).item()
    ref = np.load(os.path.join(jc.result_dir, "metrics.npy"),
                  allow_pickle=True).item()
    assert len(per["psnr"]) == len(ref["psnr"]) == 2
    np.testing.assert_allclose(per["psnr"], ref["psnr"], rtol=1e-12)
    np.testing.assert_allclose(per["ssim"], ref["ssim"], rtol=1e-12)
    # the CLI on the evaluate's default directory, <result_dir>/comparison
    shutil.copytree(pred_dir, os.path.join(cfg.result_dir, "comparison"))
    out = cli("--type", "evaluate_nv", "--cfg_file", CFG, *SMALL,
              "result_dir", str(tmp_path / "port"))
    assert out == got


def test_evaluate_nv_without_predictions_raises_as_jax(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError, match="no prediction images"):
        t_engine.run_evaluate_external(load_config(CFG, SMALL), pred_dir=empty)
    with pytest.raises(FileNotFoundError, match="no prediction images"):
        j_engine.run_evaluate_external(j_load_config(CFG, SMALL), pred_dir=empty)


class StubNHR:
    """Two items with the NHR dataset's keys (whole images: `img`, no
    `rgb`, `H` or rays), for the JAX engine's paths."""
    num_cams = 1

    def __len__(self):
        return 2

    def __getitem__(self, index):
        return {"img": np.zeros((32, 32, 3), np.float32),
                "msk": np.ones((32, 32), np.float32),
                "mask_at_box": np.ones((32, 32), bool),
                "frame_index": np.int32(index), "cam_ind": np.int32(0)}


def test_image_space_evaluate_nv_and_network_refused_where_jax_fails(
        tmp_path, monkeypatch):
    """NHR's items carry `img`, not `rgb` and `H`: JAX's evaluate_nv
    fails with a KeyError at the first file, and its `--type network`
    initializes NHR with a ray batch and fails with a TypeError. The port
    raises for both before a dataset or an engine is made."""
    pred_dir = str(tmp_path / "pred")
    os.makedirs(pred_dir)
    cv2.imwrite(os.path.join(pred_dir, "frame0000_view0000.png"),
                np.zeros((32, 32, 3), np.uint8))
    monkeypatch.setattr(j_engine, "make_dataset", lambda *_a: StubNHR())
    jc = j_load_config(NHR_CFG, [])
    with pytest.raises(KeyError):
        j_engine.run_evaluate_external(jc, pred_dir=pred_dir)
    with pytest.raises(TypeError):
        j_engine.run_network(jc, n_iters=1)
    monkeypatch.setattr(t_engine, "make_dataset", no_work)
    monkeypatch.setattr(t_engine, "Engine", no_work)
    for run_type in ("evaluate_nv", "network"):
        with pytest.raises(NotImplementedError, match=run_type):
            cli("--type", run_type, "--cfg_file", NHR_CFG)


# ----------------------------------------------------- dataset, network
def test_dataset_counts_its_items(capsys):
    assert cli("--type", "dataset", "--cfg_file", CFG, *SMALL) == 20
    assert "iterated 20 items in" in capsys.readouterr().out


def test_network_times_frames_and_writes_a_trace(tmp_path, capsys):
    """Two test items rendered from the checkpoint; the mean is of the
    second, which the torch.profiler trace covers."""
    trace = tmp_path / "trace"
    mean = cli("--type", "network", "--cfg_file", CFG, *SMALL,
               "test.num_sampler_ind", "2", "profile_dir", str(trace))
    out = capsys.readouterr().out
    assert mean > 0 and "mean forward:" in out and "over 2 frames" in out
    (path,) = trace.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# ---------------------------------------------------------------- LPIPS
def _pth_pair(tmp_path, arch, seed=0):
    """A torchvision-layout backbone state_dict and an LPIPS lin one,
    seeded (some lin weights negative, which the converters clip)."""
    g = torch.Generator().manual_seed(seed)
    bb, in_ch, ci = {}, 3, 0
    convs = [op for op in t_lpips.SPECS[arch] if op[0] == "conv"]
    for (_, out_ch, k, _, _), mi in zip(convs, t_lpips.BACKBONE_CONV_IDX[arch]):
        bb[f"features.{mi}.weight"] = torch.randn(out_ch, in_ch, k, k,
                                                  generator=g)
        bb[f"features.{mi}.bias"] = torch.randn(out_ch, generator=g)
        in_ch = out_ch
    bb["classifier.1.weight"] = torch.randn(4, 4, generator=g)
    widths = {"alex": (64, 192, 384, 256, 256),
              "vgg": (64, 128, 256, 512, 512)}[arch]
    lin = {f"lin{i}.model.1.weight": torch.randn(1, c, 1, 1, generator=g)
           for i, c in enumerate(widths)}
    paths = str(tmp_path / f"{arch}_bb.pth"), str(tmp_path / f"{arch}_lin.pth")
    torch.save(bb, paths[0])
    torch.save(lin, paths[1])
    return paths


@pytest.mark.parametrize("arch", ["alex", "vgg"])
def test_lpips_converter_writes_jax_npz(arch, tmp_path):
    backbone, lin = _pth_pair(tmp_path, arch)
    ref = str(tmp_path / "jax.npz")
    np.savez(ref, **j_convert.convert(arch, backbone, lin))
    out = str(tmp_path / "port.npz")
    t_lpips.main(["convert", "--arch", arch, "--backbone", backbone,
                  "--lin", lin, "--out", out])
    with np.load(ref) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["alex", "vgg"])
def test_lpips_distance_matches_jax(arch):
    params = t_lpips.random_params(arch, seed=3)
    j_params = j_lpips.random_params(arch, seed=3)
    for k, v in j_params.items():
        if k != "arch":
            np.testing.assert_array_equal(params[k].numpy(), np.asarray(v))
    rng = np.random.RandomState(4)
    a, b = (rng.rand(2, 64, 64, 3).astype(np.float32) for _ in range(2))
    b = np.clip(a + 0.1 * b - 0.05, 0, 1).astype(np.float32)
    got = t_lpips.lpips_distance(params, torch.as_tensor(a), torch.as_tensor(b))
    j_params.pop("arch")
    want = np.asarray(jax.jit(lambda p, x, y: j_lpips.lpips_distance(
        p, x, y, arch))(j_params, a, b))
    assert got.shape == (2,) and np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LPIPS_TOL)


def test_lpips_run_type_writes_jax_lpips_npy(tmp_path):
    """`--type lpips` on three comparison pairs (cv2-written 64x64
    PNGs), against JAX's `score_comparison_dir` on the same files and
    weights; without `lpips_weights` it raises before any work."""
    opts = SMALL + ["result_dir", str(tmp_path / "res")]
    result_dir = load_config(CFG, opts).result_dir
    comp = os.path.join(result_dir, "comparison")
    os.makedirs(comp)
    rng = np.random.RandomState(6)
    for f in range(3):
        base = os.path.join(comp, f"frame{f:04d}_view0003")
        gt = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        cv2.imwrite(base + "_gt.png", gt)
        cv2.imwrite(base + ".png", np.clip(
            gt.astype(int) + rng.randint(-40, 40, gt.shape), 0, 255
        ).astype(np.uint8))
    cv2.imwrite(os.path.join(comp, "frame0009_view0003.png"), gt)  # no _gt
    params = t_lpips.random_params("alex", seed=0)
    weights = str(tmp_path / "alex.npz")
    np.savez(weights, arch="alex", **{k: v.numpy() for k, v in params.items()
                                      if k != "arch"})
    want = j_lpips.score_comparison_dir(result_dir, weights)
    got = cli("--type", "lpips", "--cfg_file", CFG, *opts,
              "lpips_weights", weights)
    saved = np.load(os.path.join(result_dir, "lpips.npy"),
                    allow_pickle=True).item()
    assert set(saved) == set(want) == {"names", "lpips", "mean"}
    assert saved["names"] == want["names"] == got["names"] == [
        f"frame{f:04d}_view0003" for f in range(3)]
    np.testing.assert_allclose(saved["lpips"], want["lpips"], rtol=0,
                               atol=LPIPS_TOL)
    assert abs(saved["mean"] - want["mean"]) <= LPIPS_TOL


def test_lpips_without_weights_raises_before_any_work(monkeypatch):
    for name in ("score_comparison_dir", "make_dataset", "select_device"):
        monkeypatch.setattr(t_engine, name, no_work)
    with pytest.raises(SystemExit, match="lpips needs converted weights"):
        cli("--type", "lpips", "--cfg_file", CFG)


# ---------------------------------------------------------- light_stage
def _write_ply(path, pts, binary):
    header = ("ply\nformat {} 1.0\nelement vertex {}\nproperty float x\n"
              "property float y\nproperty float z\nproperty uchar red\n"
              "element face 0\nproperty list uchar int vertex_indices\n"
              "end_header\n").format(
        "binary_little_endian" if binary else "ascii", len(pts))
    with open(path, "wb") as f:
        f.write(header.encode())
        for i, p in enumerate(pts):
            if binary:
                f.write(struct.pack("<3fB", *p, i % 256))
            else:
                x, y, z = (float(v) for v in p)
                f.write(f"{x!r} {y!r} {z!r} {i % 256}\n".encode())


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_light_stage_writes_jax_voxels(binary, tmp_path):
    """Two frames of two subjects: each .npz equal to the JAX tool's
    native path (`voxelize_occupancy` through ctypes) byte for byte."""
    from animatable_nerf_tpu.native import voxelize_occupancy_native

    assert voxelize_occupancy_native(np.zeros((1, 3), np.float32),
                                     np.array([[0, 0, 0], [1, 1, 1]]),
                                     (2, 2, 2)) is not None
    rng = np.random.RandomState(7)
    for root in (tmp_path / "jax", tmp_path / "port"):
        for human in ("a", "b"):
            (root / "point_cloud" / human).mkdir(parents=True)
    for human in ("a", "b"):
        for i in (0, 1):
            pts = (rng.randn(3000, 3) * [0.3, 0.8, 0.2] + [1.0, -2.0, 0.5]
                   ).astype(np.float32)
            for root in (tmp_path / "jax", tmp_path / "port"):
                _write_ply(str(root / "point_cloud" / human / f"{i}.ply"),
                           pts, binary)
    j_p2o.ply_to_occupancy(str(tmp_path / "jax"))
    written = cli("--type", "light_stage", "--cfg_file", CFG,
                  "train_dataset.data_root", str(tmp_path / "port"))
    assert len(written) == 4
    for human in ("a", "b"):
        for i in (0, 1):
            name = Path("voxel", human, f"{i}.npz")
            with np.load(tmp_path / "jax" / name) as want, \
                    np.load(tmp_path / "port" / name) as got:
                assert sorted(got.files) == ["bounds", "compressed_occupancies"]
                for k in want.files:
                    assert got[k].dtype == want[k].dtype
                    assert got[k].tobytes() == want[k].tobytes(), (name, k)
                assert np.unpackbits(got["compressed_occupancies"]).sum() > 1000


# ------------------------------------------------------------ profiling
def test_step_timer_and_throughput_meter():
    """On the CPU `StepTimer` reads the host clock; `ThroughputMeter`
    gives items a second over its window."""
    import time

    from animatable_nerf_tpu_torch.utils.profiling import (
        StepTimer, ThroughputMeter)

    with StepTimer("cpu") as t:
        time.sleep(0.02)
        t.sync()
    assert 15 <= t.ms < 1000
    meter = ThroughputMeter(window=2)
    for n, sec in ((100, 1.0), (30, 0.5), (10, 0.5), (5, 0.0)):
        meter.update(n, sec)
    assert meter.per_sec == 40.0


# ---------------------------------------------------------------- CLI
def test_cli_takes_all_nine_jax_types():
    assert sorted(t_run.RUN_TYPES) == sorted((
        "dataset", "network", "evaluate", "visualize", "animation", "raster",
        "light_stage", "evaluate_nv", "lpips"))
    assert not hasattr(t_run, "UNPORTED_TYPES")
    with pytest.raises(SystemExit, match="unknown --type"):
        cli("--type", "bench", "--cfg_file", CFG)


def test_device_work_needs_a_gpu_and_host_types_do_not(tmp_path, monkeypatch):
    """Without a GPU and without --device cpu, `network` and `lpips`
    raise; `dataset`, `evaluate_nv` and `light_stage` run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, arch="alex")
    for args in (("--type", "network"),
                 ("--type", "lpips", "lpips_weights", weights)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_run.main([*args[:2], "--cfg_file", CFG, *SMALL, *args[2:]])
    assert t_run.main(["--type", "dataset", "--cfg_file", CFG, *SMALL]) == 20
    pred = tmp_path / "res"
    opts = SMALL + ["result_dir", str(pred)]
    _write_predictions(os.path.join(load_config(CFG, opts).result_dir,
                                    "comparison"), (1,))
    assert t_run.main(["--type", "evaluate_nv", "--cfg_file", CFG,
                       *opts])["psnr"] > 0
    (tmp_path / "ls" / "point_cloud" / "a").mkdir(parents=True)
    _write_ply(str(tmp_path / "ls" / "point_cloud" / "a" / "0.ply"),
               np.random.RandomState(0).rand(50, 3).astype(np.float32), True)
    assert len(t_run.main(["--type", "light_stage", "--cfg_file", CFG,
                           "train_dataset.data_root",
                           str(tmp_path / "ls")])) == 1
