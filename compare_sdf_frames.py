#!/usr/bin/env python3
"""Time the SDF-PDF pass 2 of the PyTorch/CUDA port in one checkout, on
one GPU, for comparing two commits on one card in one session.

    python3 compare_sdf_frames.py [ROOT]

ROOT (default: this script's directory) is a checkout of the repository,
or the part of one that the SDF-PDF path reads (`animatable_nerf_tpu_torch/`,
`configs/`, `data/synthetic/capsule/`,
`data/trained_model/deform/synthetic_sdf_pdf/`). Its package is built
into ROOT/build and measured with this script's own helpers from
chip_smoke.py, so that two commits are measured by the same code. Run
the two in the order A, B, B, A, each in its own process.

It measures, on the capsule's frame 0:
  * the K2 (`knn_blend`) and K5 (`knn_blend_blocked`) wrapper calls at
    131,072 queries drawn around the posed vertices (chip_smoke.py's
    draw), CUDA events around 10 calls, and K5's call split by
    torch.profiler;
  * the K3 (`min_dist`) and K4 (`kth_distance`) 96^3 grid builds and
    the whole `build_cell_knn` call (one K3 and one K4), each call on
    its own copy of the vertices, as each frame brings new ones;
  * one 1000x1002 frame of the flat and of the `knn_blocked` path: the
    host-clock wall of three renders after a warm-up, each without the
    frame's cached tensors, then one profiled render (device time, idle
    share, the port's kernels).
Prints the card line and one JSON line. Imports nothing of JAX.
"""

import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = 131072
TIMED_RENDERS = 3


def chip_smoke_helpers():
    """This script's chip_smoke.py, loaded by path (ROOT's may differ)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("compare_sdf_frames: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    cs = chip_smoke_helpers()
    sys.path.insert(0, root)
    os.chdir(root)
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset
    from animatable_nerf_tpu_torch.models import common
    from animatable_nerf_tpu_torch.ops import build, knn

    build.build_libraries(["skip_mlp", "knn"])
    cfg = load_config("configs/synthetic_sdf_pdf.yaml", [], run_type="evaluate")
    cfg.eval = True
    ds = make_dataset(cfg, "test")
    item = ds[0]
    pverts = torch.as_tensor(item["pvertices"], device="cuda")
    weights = torch.as_tensor(np.asarray(item["weights"], np.float32),
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    pick = torch.randint(0, pverts.shape[0], (ROWS,), device="cuda",
                         generator=gen)
    src = pverts[pick] + 0.03 * torch.randn(ROWS, 3, device="cuda",
                                            generator=gen)
    d5_packed, bounds = knn.build_d5_payload(pverts, res=cs.GRID_RES)
    d5ub = common.grid_d5_upper(src, {"d5_packed": d5_packed,
                                      "pdist_bounds": bounds})
    blocks = knn.build_knn_blocks(pverts, weights)

    def k5_call():
        return knn.knn_blend_blocked(src, d5ub, *blocks)

    result = {"root": root, "queries": ROWS,
              "k2_call_ms": cs.cuda_ms(lambda: knn.knn_blend(src, pverts,
                                                             weights)),
              "k5_call_ms": cs.cuda_ms(k5_call),
              "k5_split": cs.wrapper_split(k5_call, "knn_blocked_kernel")}
    nodes, _, _ = knn.pdist_grid_nodes(pverts, cs.GRID_RES)
    result["k3_grid_call_ms"] = cs.fresh_ms(lambda v: knn.min_dist(nodes, v),
                                            pverts)
    result["k4_grid_call_ms"] = cs.fresh_ms(
        lambda v: knn.kth_distance(nodes, v), pverts)
    result["build_cell_knn_ms"] = cs.fresh_ms(lambda v: knn.build_cell_knn(
        v, weights, res=cs.CELL_RES, cap=cs.CELL_CAPS[-1],
        slot_cap=cs.CELL_SLOTS), pverts)
    frame_item = cs.full_frame_item(ds, item)
    for name, opts in (("flat", []), ("blocked", ["knn_blocked", "True"])):
        cfg_path = load_config("configs/synthetic_sdf_pdf.yaml", opts,
                               run_type="evaluate")
        cfg_path.eval = True
        eng = Engine(cfg_path, "cuda")
        eng.load_params()
        eng.render_item(frame_item)  # warm-up
        walls = []
        for _ in range(TIMED_RENDERS):
            torch.cuda.synchronize()
            eng.clear_frame_cache()
            t0 = time.time()
            eng.render_item(frame_item)
            walls.append(time.time() - t0)
        eng.clear_frame_cache()
        prof = cs.device_breakdown(lambda: eng.render_item(frame_item))
        result[name] = {"s_per_frame": walls,
                        "s_per_frame_mean": sum(walls) / len(walls),
                        "profile": {key: prof.get(key) for key in (
                            "wall_ms", "device_ms", "idle_share",
                            "own_kernels_ms")}}
        del eng
    print(cs.card_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
