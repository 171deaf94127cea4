"""The port's host pipeline on the CPU: the read-ahead loader
(data/loader.py) and the evaluate's metrics worker and `eval_timing`
(engine.py `run_evaluate`, `_evaluate_items`), held to the JAX package
(animatable_nerf_tpu/data/loader.py, engine.py:97-109, :749-907).

The loader runs on the tracked synthetic roots (the human subject on
AniNeRF's dataset, the capsule on the KNN families'), 4 frames of 2
training views at 128x128. Its workers read the part of an item that draws no random
numbers (`read`), and the caller draws each item's rays in item order
(`draw`), so the port's items at 1, 4 and 8 threads, with one item made
slow so that the workers finish out of order, are bit-equal to its
in-order items. JAX's workers draw in whatever order they reach the
random state, so JAX is held at one thread: every key bit-equal but the
bone transforms A and big_A, 24 chained float32 4x4 products that the
port rounds otherwise by an ulp (FRAME_TOL, as tests/test_torch_host.py).

The evaluate runs the tracked AniNeRF checkpoint of configs/synthetic.yaml
at ratio 0.25 (32x32 views, 6 of them): the pipelined evaluate's
metrics.npy and comparison PNGs byte-equal to an in-order writer's, and
each view's PSNR within PSNR_TOL_DB and SSIM within SSIM_TOL of JAX's
`run_evaluate` on the same checkpoint (the evaluate tolerance of
tests/test_torch_slice.py).
"""

import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data.loader import Loader as JLoader

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.data.loader import (
    Loader,
    eval_indices,
    make_test_loader,
)
from animatable_nerf_tpu_torch.evaluators import image as t_image
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator

CFG = "configs/synthetic.yaml"
PDF_CFG = "configs/synthetic_sdf_pdf.yaml"
FRAME_TOL = 1e-6
_FLOAT_CHAIN = ("A", "big_A")
PSNR_TOL_DB = 0.01
SSIM_TOL = 1e-3
EVAL_OPTS = ["ratio", "0.25", "N_samples", "16", "eval_tile", "256",
             "test_view", "[2, 3]", "test.num_sampler_ind", "3"]
LOADER_OPTS = ["training_view", "[0, 1]", "test_view", "[3]",
               "num_train_frame", "4", "N_rand", "32",
               "test.frame_sampler_interval", "2"]
# JAX's measured keys of eval_timing_per_frame (engine.py:873-902), the
# relay projection left out
TIMING_KEYS = {
    "n_items", "steady_s_per_frame", "wall_s_total", "data_wait_s",
    "frame_h2d_s", "frame_h2d_mb", "frame_uploads_per_frame",
    "frame_cache_hits_per_frame", "pad_s", "rays_mb", "render_s",
    "render_dispatches", "fetch_s", "fetch_mb", "ssim_s", "png_s"}
RELAY_KEYS = {"relay_floor_s", "projected_chip_local_s_per_frame", "projection"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Module scope, so that it holds before the module fixtures: beside
    the suite's other workers torch's default threads crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_item(got, want, cross_package=False):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if cross_package and k in _FLOAT_CHAIN:
            np.testing.assert_allclose(g, w, rtol=FRAME_TOL, atol=FRAME_TOL,
                                       err_msg=k)
        elif g is not w and not np.array_equal(g, w):
            np.testing.assert_array_equal(g, w, err_msg=k)


def epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out += list(loader)
    return out


@pytest.fixture(scope="module", params=["tpose", "tpose_pdf"])
def train_sets(request):
    """A train split in both packages (AniNeRF's dataset, and the KNN
    families' on SDF-PDF's config), the port's items over two epochs in
    order (one `ds[idx]` after another) and JAX's through its loader at
    one thread, both drawn from RandomState(0) as under fix_random."""
    cfg_file = CFG if request.param == "tpose" else PDF_CFG
    t_ds = t_engine.make_dataset(load_config(cfg_file, LOADER_OPTS), "train")
    j_ds = j_engine.make_dataset(j_load_config(cfg_file, LOADER_OPTS), "train")
    assert len(t_ds) == len(j_ds) == 8
    t_ds._rng = np.random.RandomState(0)
    loader = Loader(t_ds, shuffle=True)
    in_order = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        in_order += [t_ds[i] for i in loader.indices()]
    j_ds._rng = np.random.RandomState(0)
    jax_items = epochs(JLoader(j_ds, shuffle=True, num_threads=1))
    return t_ds, in_order, jax_items


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_train_items_equal_at_any_thread_count(train_sets, threads,
                                               monkeypatch):
    """Two epochs at `threads` readers, the head item of each epoch made
    slow (the others finish first): every key bit-equal to the in-order
    items, and to JAX's loader at one thread."""
    t_ds, in_order, jax_items = train_sets
    heads = set()
    for epoch in range(2):
        loader = Loader(t_ds, shuffle=True)
        loader.set_epoch(epoch)
        heads.add(loader.indices()[0])
    read = t_ds.read

    def slow_read(index):
        if index in heads:
            time.sleep(0.05)
        return read(index)

    monkeypatch.setattr(t_ds, "read", slow_read)
    t_ds._rng = np.random.RandomState(0)
    got = epochs(Loader(t_ds, shuffle=True, num_threads=threads))
    assert len(got) == len(in_order) == len(jax_items) == 16
    for g, w, j in zip(got, in_order, jax_items):
        same_item(g, w)
        same_item(g, j, cross_package=True)


def hammer(fn, args_list):
    """Call fn(*args) for every args of args_list from more threads than
    there are cores, the interpreter switching threads every microsecond;
    returns [(args, result)] and re-raises any thread's exception."""
    import sys

    n_threads = min(64, 2 * (os.cpu_count() or 4) + 1)
    results, errors = [], []

    def work(k):
        try:
            for args in args_list[k::n_threads] + args_list[:k % 5]:
                results.append((args, fn(*args)))
        except Exception as e:  # raised below, on the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def test_frame_cache_holds_under_concurrent_readers(monkeypatch):
    """`TPoseDataset._frame_inputs` from many threads over 40 frames (its
    cache keeps 8): every call returns its own frame's arrays and the
    cache never exceeds 8 entries, nor raises on a concurrent eviction."""
    ds = t_engine.make_dataset(load_config(CFG, LOADER_OPTS), "train")
    ds._frame_cache.clear()
    shape = ds.max_pbw_shape

    def prepare_input(i):
        v = np.full((4, 3), i, np.float32)
        return (v, v, np.eye(4, dtype=np.float32)[None].repeat(24, 0),
                np.zeros((*shape, 24), np.float32), v[0], v[:1], np.eye(3))

    monkeypatch.setattr(ds, "prepare_input", prepare_input)
    sizes = []

    def frame(i):
        hit = ds._frame_inputs(i)
        sizes.append(len(ds._frame_cache))
        return hit

    out = hammer(frame, [(i,) for i in range(40)] * 6)
    assert len(out) >= 240 and max(sizes) <= 8
    for (i,), hit in out:
        assert (hit[0] == i).all()


def test_vis_mask_cache_holds_under_concurrent_readers():
    """`_train_view_masks` of a pose-sequence dataset from many threads at
    12 sizes (its cache keeps 4): each call gets the masks at its size."""
    cfg = load_config(CFG, ["test_dataset_module",
                            "lib.datasets.tpose_pose_sequence_dataset"])
    ds = t_engine.make_dataset(cfg, "test")
    sizes = [(8 + k, 12 + k) for k in range(12)]
    out = hammer(lambda h, w: ds._train_view_masks(0, h, w), sizes * 4)
    assert len(ds._vis_mask_cache) <= 4
    for (h, w), masks in out:
        assert masks.shape[1:] == (h, w)
        np.testing.assert_array_equal(masks, ds._train_view_masks(0, h, w))


def test_run_train_reads_with_half_the_workers(tmp_path, monkeypatch):
    """`run_train` builds its loader with train.num_workers // 2 threads
    (at least one) and a prefetch of 4, as JAX's engine.py:1184-1191."""
    made = []

    class Stop(Exception):
        pass

    def loader(*args, **kwargs):
        made.append(kwargs)
        raise Stop

    monkeypatch.setattr(t_engine, "Loader", loader)
    for workers, threads in ((16, 8), (2, 1), (1, 1)):
        cfg = load_config(CFG, LOADER_OPTS + [
            "train.num_workers", str(workers), "resume", "False",
            "trained_model_dir", str(tmp_path)])
        with pytest.raises(Stop):
            t_engine.run_train(cfg, "cpu")
        assert made[-1]["num_threads"] == threads
        assert made[-1]["prefetch"] == 4


def test_eval_loader_takes_the_eval_order():
    """make_test_loader: eval_indices' order (the frame sampler at
    interval 2: frames 0 and 2), each item equal to `ds[idx]`, and the
    same frames and views as JAX's make_test_loader."""
    opts = LOADER_OPTS
    cfg = load_config(CFG, opts)
    cfg.eval = True
    ds = t_engine.make_dataset(cfg, "test")
    order = eval_indices(cfg, ds)
    assert order == [0, 2]
    got = list(make_test_loader(cfg, ds))
    for item, idx in zip(got, order):
        same_item(item, ds[idx])
    jc = j_load_config(CFG, opts)
    jc.eval = True
    j_items = list(j_engine.make_test_loader(jc, j_engine.make_dataset(jc, "test")))
    assert ([(int(i["frame_index"]), int(i["cam_ind"])) for i in got]
            == [(int(i["frame_index"]), int(i["cam_ind"])) for i in j_items]
            == [(0, 3), (2, 3)])


class Items:
    """A dataset of ints; `read` of `fail_at` raises, `hold` (an Event)
    holds the read of item 0 until it is set; `started` counts reads."""

    def __init__(self, n, fail_at=None, hold=None, delay=0.0):
        self.n, self.fail_at, self.hold, self.delay = n, fail_at, hold, delay
        self.started = 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def read(self, index):
        with self.lock:
            self.started += 1
        if index == 0 and self.hold is not None:
            self.hold.wait(10)
        time.sleep(self.delay)
        if index == self.fail_at:
            raise ValueError(f"item {index} is broken")
        return index

    def draw(self, index, part):
        return part * 10


def readers_alive():
    return [t for t in threading.enumerate()
            if t.name.startswith("Loader-reader") and t.is_alive()]


def wait_for_no_readers(timeout=5.0):
    end = time.time() + timeout
    while readers_alive() and time.time() < end:
        time.sleep(0.02)
    return readers_alive()


def test_a_read_error_is_raised_at_its_item():
    """The items before the broken one come out; its error is raised on
    the caller's thread when its turn comes, and no reader lives on."""
    got = []
    with pytest.raises(ValueError, match="item 3 is broken"):
        for x in Loader(Items(12, fail_at=3, delay=0.01), shuffle=False,
                        num_threads=4):
            got.append(x)
    assert got == [0, 10, 20]
    assert not wait_for_no_readers()


def test_items_in_flight_are_bounded():
    """With the head item held, the readers start prefetch + num_threads
    reads and wait; the items still come out in order."""
    hold = threading.Event()
    ds = Items(40, hold=hold)
    loader = Loader(ds, shuffle=False, prefetch=2, num_threads=3)
    it = iter(loader)
    first = []
    t = threading.Thread(target=lambda: first.append(next(it)))
    t.start()
    time.sleep(0.5)
    assert ds.started == 5
    hold.set()
    t.join(5)
    assert first == [0] and list(it) == [10 * i for i in range(1, 40)]
    assert not wait_for_no_readers()


@pytest.mark.parametrize("how", ["break", "exception"])
def test_leaving_early_stops_the_readers(how):
    """A break after two items, or an exception in the caller's loop,
    leaves no reader thread alive."""
    loader = Loader(Items(200, delay=0.01), shuffle=False, num_threads=4)
    n = 0
    try:
        for _ in loader:
            n += 1
            if n == 2:
                if how == "break":
                    break
                raise KeyError("caller")
    except KeyError:
        assert how == "exception"
    assert n == 2
    assert not wait_for_no_readers()


def test_visualization_items_are_read_whole():
    """The pose-sequence dataset (a subclass of AniNeRF's) draws nothing:
    its workers read each item whole, and the loader gives `ds[idx]`."""
    from animatable_nerf_tpu_torch.data.novel_view import _VisMixin

    cfg = load_config(CFG, ["test_dataset_module",
                            "lib.datasets.tpose_pose_sequence_dataset"])
    ds = t_engine.make_dataset(cfg, "test")
    assert type(ds).read is _VisMixin.read and type(ds).draw is _VisMixin.draw
    got = list(Loader(ds, shuffle=False, num_threads=3))
    assert len(got) == len(ds) == 4
    for index, item in enumerate(got):
        same_item(item, ds[index])


# --------------------------------------------------------------- evaluate
@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The tracked checkpoint's evaluate at ratio 0.25 (8 views of 32x32):
    JAX's `run_evaluate`; the port's pipelined one, its metrics worker
    slowed on the first view so that the render runs ahead; and an
    in-order writer (each view rendered, then scored, in turn)."""
    base = tmp_path_factory.mktemp("evaluate")
    jc = j_load_config(CFG, EVAL_OPTS + ["result_dir", str(base / "jax")],
                       run_type="evaluate")
    j_engine.run_evaluate(jc)
    dirs = {"jax": jc.result_dir}
    cfg = load_config(CFG, EVAL_OPTS + ["result_dir", str(base / "port")],
                      run_type="evaluate")
    real = t_image.ImageEvaluator.evaluate
    calls = []

    def slow_first(self, *args, **kwargs):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            time.sleep(0.3)
        return real(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_image.ImageEvaluator, "evaluate", slow_first)
        res = t_engine.run_evaluate(cfg, "cpu")
    dirs["port"] = cfg.result_dir

    cfg = load_config(CFG, EVAL_OPTS + ["result_dir", str(base / "serial")],
                      run_type="evaluate")
    cfg.eval = True
    eng = t_engine.Engine(cfg, "cpu")
    eng.load_params()
    ds = t_engine.make_dataset(cfg, "test")
    serial = ImageEvaluator(cfg.result_dir)
    for idx in eval_indices(cfg, ds):
        item = ds[idx]
        out, _ = eng.render_item(item)
        serial.evaluate(out["rgb_map"], np.asarray(item["rgb"]),
                        np.asarray(item["mask_at_box"]), int(item["H"]),
                        int(item["W"]), frame_index=int(item["frame_index"]),
                        view_index=int(item["cam_ind"]))
    serial.summarize()
    dirs["serial"] = cfg.result_dir
    return {k: Path(v) for k, v in dirs.items()}, res, calls


def test_pipelined_evaluate_writes_what_the_in_order_writer_writes(evaluated):
    """metrics.npy and every comparison PNG byte-equal; the metrics ran
    on the one worker thread, off the caller's."""
    dirs, res, calls = evaluated
    port, serial = dirs["port"], dirs["serial"]
    assert ((port / "metrics.npy").read_bytes()
            == (serial / "metrics.npy").read_bytes())
    names = sorted(os.listdir(port / "comparison"))
    assert len(names) == 12
    assert names == sorted(os.listdir(serial / "comparison"))
    for name in names:
        assert ((port / "comparison" / name).read_bytes()
                == (serial / "comparison" / name).read_bytes()), name
    assert len(calls) == 6 and len(set(calls)) == 1
    assert calls[0] != threading.current_thread().name
    assert [(it["frame_index"], it["view_index"]) for it in res["items"]] == [
        (f, v) for f in range(3) for v in (2, 3)]


def test_pipelined_evaluate_matches_jax(evaluated):
    dirs, res, _ = evaluated
    ref = np.load(dirs["jax"] / "metrics.npy", allow_pickle=True).item()
    assert len(ref["psnr"]) == len(res["items"]) == 6
    for item, psnr, ssim in zip(res["items"], ref["psnr"], ref["ssim"]):
        assert abs(item["psnr"] - psnr) <= PSNR_TOL_DB
        assert abs(item["ssim"] - ssim) <= SSIM_TOL
    assert abs(res["psnr"] - float(np.mean(ref["psnr"]))) <= PSNR_TOL_DB


def test_eval_timing_prints_the_stage_decomposition(tmp_path, capsys):
    """`eval_timing True`: JAX's `eval pipeline` line and one
    `eval_timing_per_frame` line with the measured keys (no device_ms on
    the CPU) and without the relay projection; off, neither timing nor
    its line."""
    import json

    opts = EVAL_OPTS + ["result_dir", str(tmp_path), "test.num_sampler_ind", "1"]
    t_engine.run_evaluate(load_config(CFG, opts + ["eval_timing", "True"],
                                      run_type="evaluate"), "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("eval pipeline: 2 items") for line in lines) == 1
    timed = [json.loads(line) for line in lines
             if line.startswith('{"eval_timing_per_frame"')]
    assert len(timed) == 1
    got = timed[0]["eval_timing_per_frame"]
    assert set(got) == TIMING_KEYS and not set(got) & RELAY_KEYS
    assert got["n_items"] == 2 and got["render_dispatches"] == 1.0
    # frame 0, views 2 and 3: one upload, then one hit of the frame cache
    assert got["frame_uploads_per_frame"] == 0.5
    assert got["frame_cache_hits_per_frame"] == 0.5
    assert all(v >= 0 for v in got.values())
    assert got["render_s"] > 0 and got["ssim_s"] > 0 and got["png_s"] > 0
    t_engine.run_evaluate(load_config(CFG, opts, run_type="evaluate"), "cpu")
    assert "eval_timing_per_frame" not in capsys.readouterr().out
