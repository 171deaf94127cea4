#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (animatable_nerf_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:
  1. the card (nvidia-smi) and the build of every kernel from csrc/;
  2. kernel K1 (ops/skip_mlp.py, csrc/skip_mlp.cu) against its plain
     PyTorch version on the card, at both production wirings and the
     row count of one eval tile's survivors, with times and bounds;
  3. the port's `run_evaluate` on configs/synthetic.yaml with the
     tracked checkpoint (4 views), each view held to the JAX package's
     PSNR within PSNR_TOL_DB, with K1's launches counted;
  4. a torch.profiler breakdown of one 128x128 eval frame, then one
     full-size 1000x1002 frame of the same subject, timed and profiled;
then the kernel table line, the card line and {"ok": true, ...} last.
Any failed phase raises and exits non-zero. Imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

# Per-view PSNR (frames 0-3, view 3) of the JAX package on
# configs/synthetic.yaml with data/trained_model/deform/synthetic/latest.flax,
# computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR = [7.655750694805134, 7.5696494082365495, 8.05470772363299,
            9.417616795213712]
PSNR_TOL_DB = 0.1
# K1 against its plain version: both FP32 (TF32 off), summed in another
# order over up to 447 terms per layer and 9 chained layers, so the
# outputs agree to ~1e-6 relative; 1e-4 of the output scale leaves room.
K1_REL_TOL = 1e-4
K1_ROWS = 131072  # survivors of one 8192-ray tile at a 25% keep
# published H100 SXM peaks (at the 700 W limit): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FULL_H, FULL_W = 1002, 1000  # H36M S9's frame (configs/aninerf_s9p.yaml)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, iters=10):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, top=8):
    """Device time of one fn() run by kernel, from torch.profiler: the
    wall time, the summed kernel time (one stream, so kernels do not
    overlap), the idle share and the `top` kernels by time. Times in
    ms; the kernel numbers are None where the profiler recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        # device-side events only: an operator's own entry repeats the
        # time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "kernels": None}
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels": [{"name": k[:80], "ms": v, "share": v / busy_ms}
                        for k, v in ranked]}


def k1_wirings():
    """(name, din, layer shapes, skips, act_last) of the two trunks."""
    def shapes(din, n_hidden, dout_last):
        dims = []
        d_in = din
        for i in range(n_hidden):
            dims.append((d_in, 256))
            d_in = 256 + (din if i == 4 else 0)
        if dout_last:
            dims.append((d_in, dout_last))
        return dims

    return [
        ("bw_field", 191, shapes(191, 8, 24), (4,), False),
        ("tpose_trunk", 63, shapes(63, 8, 0), (4,), True),
    ]


def phase_k1(skip_mlp, skip_mlp_plain):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, din, dims, skips, act_last in k1_wirings():
        x = torch.rand(K1_ROWS, din, device="cuda", generator=gen) * 2 - 1
        layers = [
            (torch.randn(i, o, device="cuda", generator=gen) / math.sqrt(i),
             torch.randn(o, device="cuda", generator=gen) * 0.1)
            for i, o in dims
        ]
        kwargs = dict(skips=skips, act="relu", act_last=act_last)

        def library():
            h = x
            for j, (w, b) in enumerate(layers):
                h = torch.addmm(b, h, w)
                if j < len(layers) - 1 or act_last:
                    h = torch.relu_(h)
                    if j in skips and j < len(layers) - 1:
                        h = torch.cat([x, h], dim=-1)
            return h

        got = skip_mlp(x, layers, **kwargs)
        torch.cuda.synchronize()
        ref = skip_mlp_plain(x, layers, **kwargs)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(math.isfinite(err) and err <= K1_REL_TOL * max(scale, 1.0),
              f"K1 {name}: max abs err {err} vs output scale {scale}")
        # plain, kernel, kernel, plain: compare within one card and call
        plain_a = cuda_ms(lambda: skip_mlp_plain(x, layers, **kwargs))
        kern_a = cuda_ms(lambda: skip_mlp(x, layers, **kwargs))
        kern_b = cuda_ms(lambda: skip_mlp(x, layers, **kwargs))
        plain_b = cuda_ms(lambda: skip_mlp_plain(x, layers, **kwargs))
        lib_ms = cuda_ms(library)
        flops = 2 * K1_ROWS * sum(i * o for i, o in dims)
        nbytes = 4 * (K1_ROWS * (din + dims[-1][1])
                      + sum(i * o + o for i, o in dims))
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({
            "wiring": name, "rows": K1_ROWS, "din": din,
            "dout": dims[-1][1], "layers": len(dims),
            "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
            "tol_abs": K1_REL_TOL * max(scale, 1.0),
            "kernel_ms": (kern_a + kern_b) / 2, "kernel_ms_runs": [kern_a, kern_b],
            "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
            "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "kernel_tflops": flops / ((kern_a + kern_b) / 2 * 1e-3) / 1e12,
        })
    emit({"phase": "k1_vs_plain", "tolerance": (
        f"max abs err <= {K1_REL_TOL} x max(1, max |plain|): FP32 vs FP32 "
        "(TF32 off), different summation order"), "wirings": rows})
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.core.rays import get_near_far_np, get_rays_np
    from animatable_nerf_tpu_torch.device import select_device
    from animatable_nerf_tpu_torch.engine import (
        Engine, make_dataset, run_evaluate,
    )
    from animatable_nerf_tpu_torch.ops import skip_mlp as k1

    select_device("cuda")
    card = card_line()

    # ---- phase 1: card + build
    t0 = time.time()
    k1.build_library()
    build_s = time.time() - t0
    log = (k1.BUILD_DIR / "skip_mlp.build.log").read_text()
    emit({"phase": "build", "card": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": [l.strip() for l in log.splitlines()
                    if "registers" in l or "spill" in l]})

    # ---- phase 2: K1 vs plain
    k1_rows = phase_k1(k1.skip_mlp, k1.skip_mlp_plain)

    # ---- phase 3: evaluate (the main path)
    cfg = load_config("configs/synthetic.yaml", [], run_type="evaluate")
    k1.skip_mlp.launches = 0
    t0 = time.time()
    res = run_evaluate(cfg, "cuda")
    eval_s = time.time() - t0
    eval_launches = k1.skip_mlp.launches
    check(eval_launches > 0, "evaluate did not launch K1")
    items = res["items"]
    check(len(items) == len(JAX_PSNR), f"expected {len(JAX_PSNR)} items")
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, JAX_PSNR)]
    emit({"phase": "evaluate", "items": items, "psnr_mean": res["psnr"],
          "ssim_mean": res["ssim"], "jax_psnr": JAX_PSNR,
          "delta_psnr_db": dpsnr, "tol_db": PSNR_TOL_DB,
          "k1_launches": eval_launches, "wall_s": eval_s,
          "s_per_frame": [it["seconds"] for it in items]})
    check(all(abs(d) <= PSNR_TOL_DB for d in dpsnr),
          f"PSNR differs from JAX by {dpsnr} dB")

    # ---- phase 4: device profile of one eval frame, then one full-size
    # frame (frame 0, view 3, K scaled) timed and profiled
    ds = make_dataset(cfg, "test")
    eng = Engine(cfg, "cuda")
    eng.load_params()
    item = dict(ds[0])
    eng.render_item(item)  # warm-up
    emit({"phase": "eval_frame_profile", "rays": len(item["ray_o"]),
          **device_breakdown(lambda: eng.render_item(item))})
    cam = int(item["cam_ind"])
    K = np.array(ds.cams["K"][cam], np.float64)
    K[:2] *= FULL_W / 128.0
    R = np.array(ds.cams["R"][cam])
    T = np.array(ds.cams["T"][cam]) / 1000.0
    ro, rd = get_rays_np(FULL_H, FULL_W, K, R, T)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far, mab = get_near_far_np(item["wbounds"], ro, rd)
    item.update(ray_o=ro[mab], ray_d=rd[mab], near=near, far=far)
    eng.render_item(item)  # first render: allocator warm-up
    torch.cuda.synchronize()
    k1.skip_mlp.launches = 0
    t0 = time.time()
    out, n_rays = eng.render_item(item)
    frame_s = time.time() - t0
    frame_launches = k1.skip_mlp.launches
    finite = all(bool(np.isfinite(v).all()) for v in out.values())
    acc_max = float(out["acc_map"].max())
    emit({"phase": "full_frame", "H": FULL_H, "W": FULL_W, "rays": n_rays,
          **eng.stats, "s_per_frame": frame_s,
          "rays_per_s": n_rays / frame_s, "k1_launches": frame_launches,
          "finite": finite, "acc_max": acc_max,
          "acc_mean": float(out["acc_map"].mean())})
    check(finite and acc_max > 0, "full-size frame is not finite or empty")
    emit({"phase": "full_frame_profile",
          **device_breakdown(lambda: eng.render_item(item))})

    # ---- kernel table
    emit({"kernels": [{
        "name": "skip_mlp",
        "route": "cuda",
        "source": "animatable_nerf_tpu_torch/csrc/skip_mlp.cu",
        "replaces": "animatable_nerf_tpu/ops/mlp_pallas.py:108",
        "launches": eval_launches,
        "launches_full_frame": frame_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        # one eval tile's pair of calls (bw field + NeRF trunk) at K1_ROWS
        "ms": sum(r["kernel_ms"] for r in k1_rows),
        "kernel_ms": sum(r["kernel_ms"] for r in k1_rows),
        "plain_ms": sum(r["plain_ms"] for r in k1_rows),
        "bound_ms": sum(r["bound_ms"] for r in k1_rows),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in k1_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in k1_rows),
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
