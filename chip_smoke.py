#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (animatable_nerf_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:
  1. the card (nvidia-smi) and the build of every kernel from csrc/
     (one nvcc per source, all at once);
  2. kernel K1 (ops/skip_mlp.py, csrc/skip_mlp.cu) against its plain
     PyTorch version on the card, at the three production wirings and
     the row count of one eval tile's survivors, with times and bounds;
  3. kernels K2 and K3 (ops/knn.py, csrc/knn.cu) against their plain
     versions: K2 at 131,072 queries over 6890 vertices with duplicate
     vertices, K3 at the 96^3 distance-grid build of one capsule frame;
  4. the port's `run_evaluate` on configs/synthetic.yaml (AniNeRF) with
     the tracked checkpoint (4 views), each view held to the JAX
     package's PSNR within PSNR_TOL_DB, with K1's launches counted;
  5. a torch.profiler breakdown of one 128x128 AniNeRF eval frame, then
     one full-size 1000x1002 frame of the same subject, timed and
     profiled;
  6. the same for SDF-PDF (configs/synthetic_sdf_pdf.yaml, the capsule
     subject): `run_evaluate` held to the JAX PSNR with K1, K2 and K3
     each launched, then one 1000x1002 frame timed and profiled;
then the kernel table line, the card line and {"ok": true, ...} last.
Kernel launch counts are set to 0 just before each path and read just
after it. Any failed phase raises and exits non-zero. Imports nothing of
JAX.
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
# The same for SDF-PDF on configs/synthetic_sdf_pdf.yaml with
# data/trained_model/deform/synthetic_sdf_pdf/latest.flax (frames 0-3,
# view 3), computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_sdf_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_SDF = [19.918607338172638, 22.15452214101879, 23.829273881602546,
                25.011918868247466]
PSNR_TOL_DB = 0.1
# K1 against its plain version: both FP32 (TF32 off), summed in another
# order over up to 447 terms per layer and 9 chained layers, so the
# outputs agree to ~1e-6 relative; 1e-4 of the output scale leaves room.
K1_REL_TOL = 1e-4
K1_ROWS = 131072  # survivors of one 8192-ray tile at a 25% keep
# K2 and K3 round every operation as their plain versions do (no FMA,
# the same order), so they agree to the bit
KNN_TOL = 0.0
K2_ROWS = 131072  # queries, as many as K1_ROWS
K2_DUPS = 64  # vertices that are exact copies of others
GRID_RES = 96  # the engine's knn_grid_res
# operations per (query, vertex) pair: 3 subtractions, 3 multiplications,
# 2 additions and a compare or min
OPS_PER_PAIR = 9
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


# the port's own kernels, by the names the profiler gives them
OWN_KERNELS = ("skip_mlp_kernel", "knn_blend_kernel", "min_dist_kernel")


def device_breakdown(fn, top=8):
    """Device time of one fn() run by kernel, from torch.profiler: the
    wall time, the summed kernel time (one stream, so kernels do not
    overlap), the idle share, the `top` kernels by time and the time of
    each of the port's own kernels. Times in ms; the kernel numbers are
    None where the profiler recorded no device time."""
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
    own = {name: sum(v for k, v in by_kernel.items() if name in k)
           for name in OWN_KERNELS}
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels": [{"name": k[:80], "ms": v, "share": v / busy_ms}
                        for k, v in ranked],
            "own_kernels_ms": own}


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the FP32
    peak and the bytes over the HBM rate."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def timed_pair(kernel, plain, library, plain_iters=3):
    """Times in ms on one card and call: plain, kernel, kernel, plain,
    then the library chain."""
    plain_a = cuda_ms(plain, warmup=1, iters=plain_iters)
    kern_a = cuda_ms(kernel)
    kern_b = cuda_ms(kernel)
    plain_b = cuda_ms(plain, warmup=1, iters=plain_iters)
    return {"kernel_ms": (kern_a + kern_b) / 2, "kernel_ms_runs": [kern_a, kern_b],
            "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
            "library_ms": cuda_ms(library, warmup=1, iters=plain_iters)}


def k1_wirings():
    """(name, din, layer shapes, skips, act_last) of the three trunks."""
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
        ("resd_field", 135, shapes(135, 8, 3), (4,), False),
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
        times = timed_pair(lambda: skip_mlp(x, layers, **kwargs),
                           lambda: skip_mlp_plain(x, layers, **kwargs),
                           library, plain_iters=10)
        flops = 2 * K1_ROWS * sum(i * o for i, o in dims)
        nbytes = 4 * (K1_ROWS * (din + dims[-1][1])
                      + sum(i * o + o for i, o in dims))
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append({
            "wiring": name, "rows": K1_ROWS, "din": din,
            "dout": dims[-1][1], "layers": len(dims),
            "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
            "tol_abs": K1_REL_TOL * max(scale, 1.0), **times,
            "flops": flops, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_tflops": flops / (times["kernel_ms"] * 1e-3) / 1e12,
        })
    emit({"phase": "k1_vs_plain", "tolerance": (
        f"max abs err <= {K1_REL_TOL} x max(1, max |plain|): FP32 vs FP32 "
        "(TF32 off), different summation order"), "wirings": rows})
    return rows


def cdist_knn(src, ref, values, k=5, eps=1e-8, chunk=16384):
    """The library chain K2 is timed against: torch.cdist, torch.topk
    and a gather, chunked over the queries."""
    import torch

    vals, wds = [], []
    for s in range(0, src.shape[0], chunk):
        d, idx = torch.topk(torch.cdist(src[s:s + chunk], ref), k, dim=1,
                            largest=False)
        w = 1.0 / (d + eps)
        vals.append((values[idx] * w[..., None]).sum(1) / w.sum(1, keepdim=True))
        wds.append((d * w).sum(1, keepdim=True) / w.sum(1, keepdim=True))
    return torch.cat(vals), torch.cat(wds)


def cdist_min(src, ref, chunk=16384):
    """The library chain K3 is timed against: torch.cdist(...).amin(1),
    chunked over the queries."""
    import torch

    return torch.cat([torch.cdist(src[s:s + chunk], ref).amin(1)
                      for s in range(0, src.shape[0], chunk)])


def phase_knn(knn, pvertices):
    """K2 and K3 against their plain versions on the card, with times,
    bounds and the library chains' times."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    m, c = pvertices.shape[0], 24
    # K2: a seeded cloud of SMPL's size with K2_DUPS exact duplicates,
    # queries around its vertices, the first ones exactly on duplicated
    # vertices, so the lowest-index tie-break decides them
    ref = torch.rand(m, 3, device="cuda", generator=gen) * torch.tensor(
        [0.8, 1.8, 0.5], device="cuda") - torch.tensor([0.4, 1.0, 0.25], device="cuda")
    ref[-K2_DUPS:] = ref[:K2_DUPS]
    pick = torch.randint(0, m, (K2_ROWS,), device="cuda", generator=gen)
    src = ref[pick] + 0.03 * torch.randn(K2_ROWS, 3, device="cuda", generator=gen)
    src[:K2_DUPS] = ref[:K2_DUPS]
    logits = torch.randn(m, c, device="cuda", generator=gen)
    values = torch.softmax(logits, dim=-1)
    got_v, got_d = knn.knn_blend(src, ref, values)
    torch.cuda.synchronize()
    ref_v, ref_d = knn.knn_blend_plain(src, ref, values)
    err2 = max((got_v - ref_v).abs().max().item(), (got_d - ref_d).abs().max().item())
    # a row whose neighbours differ has another blend, so rows that
    # differ in any bit bound the rows with other neighbours
    rows_differ = int(((got_v != ref_v).any(1) | (got_d != ref_d).any(1)).sum())
    times2 = timed_pair(lambda: knn.knn_blend(src, ref, values),
                        lambda: knn.knn_blend_plain(src, ref, values),
                        lambda: cdist_knn(src, ref, values))
    pairs2 = K2_ROWS * m
    b2, by2 = bound(OPS_PER_PAIR * pairs2 + K2_ROWS * 5 * (2 * c + 4),
                    4 * (K2_ROWS * 3 + m * (3 + c) + K2_ROWS * (c + 1)))
    k2 = {"name": "knn_blend", "queries": K2_ROWS, "vertices": m, "channels": c,
          "duplicate_vertices": K2_DUPS, "max_abs_err": err2,
          "rows_differing": rows_differ, **times2, "bound_ms": b2,
          "bound_by": by2, "library": "torch.cdist + torch.topk + gather, "
          "chunks of 16384 queries"}
    check(err2 <= KNN_TOL and rows_differ == 0,
          f"K2 differs from its plain version: {err2}, {rows_differ} rows")

    # K3: the 96^3 distance-grid build of one capsule frame
    nodes, _, _ = knn.pdist_grid_nodes(pvertices, GRID_RES)
    got = knn.min_dist(nodes, pvertices)
    torch.cuda.synchronize()
    err3 = (got - knn.min_dist_plain(nodes, pvertices)).abs().max().item()
    times3 = timed_pair(lambda: knn.min_dist(nodes, pvertices),
                        lambda: knn.min_dist_plain(nodes, pvertices),
                        lambda: cdist_min(nodes, pvertices))
    n3 = nodes.shape[0]
    b3, by3 = bound(OPS_PER_PAIR * n3 * m, 4 * (n3 * 3 + m * 3 + n3))
    k3 = {"name": "min_dist", "queries": n3, "vertices": m, "max_abs_err": err3,
          **times3, "bound_ms": b3, "bound_by": by3,
          "library": "torch.cdist(...).amin(1), chunks of 16384 queries"}
    check(err3 <= KNN_TOL, f"K3 differs from its plain version: {err3}")
    emit({"phase": "knn_vs_plain", "tolerance": (
        "max abs err == 0 and no differing row: the kernels round every "
        "operation as the plain versions do"), "kernels": [k2, k3]})
    return k2, k3


def launch_counts(k1, knn):
    return {"skip_mlp": k1.skip_mlp.launches,
            "knn_blend": knn.knn_blend.launches,
            "min_dist": knn.min_dist.launches}


def reset_counts(k1, knn):
    k1.skip_mlp.launches = 0
    knn.knn_blend.launches = 0
    knn.min_dist.launches = 0


def phase_evaluate(name, cfg, jax_psnr, k1, knn):
    """run_evaluate of `cfg` on the card, each view held to the JAX
    package's PSNR; returns the kernels' launches in this run."""
    from animatable_nerf_tpu_torch.engine import run_evaluate

    reset_counts(k1, knn)
    t0 = time.time()
    res = run_evaluate(cfg, "cuda")
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    items = res["items"]
    check(len(items) == len(jax_psnr), f"{name}: expected {len(jax_psnr)} items")
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, jax_psnr)]
    emit({"phase": name, "items": items, "psnr_mean": res["psnr"],
          "ssim_mean": res["ssim"], "jax_psnr": jax_psnr,
          "delta_psnr_db": dpsnr, "tol_db": PSNR_TOL_DB,
          "launches": launches, "wall_s": wall,
          "s_per_frame": [it["seconds"] for it in items]})
    check(all(abs(d) <= PSNR_TOL_DB for d in dpsnr),
          f"{name}: PSNR differs from JAX by {dpsnr} dB")
    return launches


def full_frame_item(ds, item):
    """The item's view at 1000x1002 (K scaled), with its rays and box
    near/far."""
    from animatable_nerf_tpu_torch.core.rays import get_near_far_np, get_rays_np

    item = dict(item)
    cam = int(item["cam_ind"])
    K = np.array(ds.cams["K"][cam], np.float64)
    K[:2] *= FULL_W / 128.0
    R = np.array(ds.cams["R"][cam])
    T = np.array(ds.cams["T"][cam]) / 1000.0
    ro, rd = get_rays_np(FULL_H, FULL_W, K, R, T)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far, mab = get_near_far_np(item["wbounds"], ro, rd)
    item.update(ray_o=ro[mab], ray_d=rd[mab], near=near, far=far)
    return item


def phase_full_frame(name, eng, item, k1, knn):
    """One full-size frame, timed after a warm-up render, then profiled;
    returns the kernels' launches in the timed render. Both the timed
    and the profiled render start without the frame's cached tensors,
    so they include the frame's upload and (SDF-PDF) its K3 grid."""
    import torch

    eng.render_item(item)  # first render: allocator warm-up
    torch.cuda.synchronize()
    eng.clear_frame_cache()
    reset_counts(k1, knn)
    t0 = time.time()
    out, n_rays = eng.render_item(item)
    frame_s = time.time() - t0
    launches = launch_counts(k1, knn)
    finite = all(bool(np.isfinite(v).all()) for v in out.values())
    acc_max = float(out["acc_map"].max())
    emit({"phase": name, "H": FULL_H, "W": FULL_W, "rays": n_rays,
          **eng.stats, "s_per_frame": frame_s,
          "rays_per_s": n_rays / frame_s, "launches": launches,
          "finite": finite, "acc_max": acc_max,
          "acc_mean": float(out["acc_map"].mean())})
    check(finite and acc_max > 0, f"{name}: frame is not finite or empty")
    eng.clear_frame_cache()
    emit({"phase": f"{name}_profile",
          **device_breakdown(lambda: eng.render_item(item))})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.device import select_device
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset
    from animatable_nerf_tpu_torch.ops import build, knn
    from animatable_nerf_tpu_torch.ops import skip_mlp as k1

    select_device("cuda")
    card = card_line()

    # ---- phase 1: card + build (one nvcc per source, all at once)
    sources = ["skip_mlp", "knn"]
    t0 = time.time()
    build.build_libraries(sources)
    build_s = time.time() - t0
    emit({"phase": "build", "card": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {name: [l.strip() for l in build.build_log(name).splitlines()
                           if "registers" in l or "spill" in l]
                    for name in sources}})

    # ---- phase 2: K1 vs plain
    k1_rows = phase_k1(k1.skip_mlp, k1.skip_mlp_plain)

    # ---- phase 3: K2 and K3 vs plain, on one capsule frame's vertices
    cfg_sdf = load_config("configs/synthetic_sdf_pdf.yaml", [], run_type="evaluate")
    cfg_sdf.eval = True
    ds_sdf = make_dataset(cfg_sdf, "test")
    item_sdf = ds_sdf[0]
    pverts = torch.as_tensor(item_sdf["pvertices"], device="cuda")
    k2_row, k3_row = phase_knn(knn, pverts)

    # ---- phase 4: AniNeRF evaluate (the first slice's path)
    cfg = load_config("configs/synthetic.yaml", [], run_type="evaluate")
    eval_launches = phase_evaluate("evaluate", cfg, JAX_PSNR, k1, knn)
    check(eval_launches["skip_mlp"] > 0, "evaluate did not launch K1")

    # ---- phase 5: device profile of one AniNeRF eval frame, then one
    # full-size frame (frame 0, view 3, K scaled) timed and profiled
    ds = make_dataset(cfg, "test")
    eng = Engine(cfg, "cuda")
    eng.load_params()
    item = dict(ds[0])
    eng.render_item(item)  # warm-up
    emit({"phase": "eval_frame_profile", "rays": len(item["ray_o"]),
          **device_breakdown(lambda: eng.render_item(item))})
    frame_launches = phase_full_frame("full_frame", eng, full_frame_item(ds, item),
                                      k1, knn)

    # ---- phase 6: SDF-PDF evaluate (this slice's path) and full frame
    sdf_launches = phase_evaluate("evaluate_sdf_pdf", cfg_sdf, JAX_PSNR_SDF, k1, knn)
    for kernel, n in sdf_launches.items():
        check(n > 0, f"evaluate_sdf_pdf did not launch {kernel}")
    eng_sdf = Engine(cfg_sdf, "cuda")
    eng_sdf.load_params()
    sdf_frame_launches = phase_full_frame(
        "full_frame_sdf_pdf", eng_sdf, full_frame_item(ds_sdf, item_sdf), k1, knn)

    # ---- kernel table
    def k1_sum(key):
        return sum(r[key] for r in k1_rows)

    def knn_entry(row, name, source_line, kernel):
        return {
            "name": name, "route": "cuda",
            "source": "animatable_nerf_tpu_torch/csrc/knn.cu",
            "replaces": f"animatable_nerf_tpu/ops/knn_pallas.py:{source_line}",
            "launches": sdf_launches[kernel],
            "launches_full_frame": sdf_frame_launches[kernel],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": row["library"],
        }

    emit({"kernels": [
        {
            "name": "skip_mlp",
            "route": "cuda",
            "source": "animatable_nerf_tpu_torch/csrc/skip_mlp.cu",
            "replaces": "animatable_nerf_tpu/ops/mlp_pallas.py:108",
            # both evaluate paths (AniNeRF, SDF-PDF)
            "launches": eval_launches["skip_mlp"] + sdf_launches["skip_mlp"],
            "launches_by_path": {"evaluate": eval_launches["skip_mlp"],
                                 "evaluate_sdf_pdf": sdf_launches["skip_mlp"]},
            "launches_full_frame": {
                "full_frame": frame_launches["skip_mlp"],
                "full_frame_sdf_pdf": sdf_frame_launches["skip_mlp"]},
            "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
            # one call of each wiring (bw field, NeRF trunk, resd field)
            # at K1_ROWS rows
            "ms": k1_sum("kernel_ms"),
            "kernel_ms": k1_sum("kernel_ms"),
            "plain_ms": k1_sum("plain_ms"),
            "bound_ms": k1_sum("bound_ms"),
            "bound_by": "operations" if all(
                r["bound_by"] == "operations" for r in k1_rows) else "bytes",
            "library_ms": k1_sum("library_ms"),
        },
        knn_entry(k2_row, "knn_blend", 55, "knn_blend"),
        knn_entry(k3_row, "min_dist", 129, "min_dist"),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
