"""Where the time of K1's bf16 form goes, on the card.

Builds variants of animatable_nerf_tpu_torch/csrc/skip_mlp.cu into
build/k1_bf16_breakdown/ (the source in the checkout stays as it is),
each with one part of the bf16 kernel taken out or doubled, and times
every variant on the three AniNeRF wirings at 131,072 rows, in turns,
twice. Only the `base` variant computes the contract; the others are for
timing alone:

    base           the kernel as it is
    no_epilogue    the hidden layers' epilogue skipped (h is not written)
    no_products    no wgmma (the chunks still stream and are handed back)
    no_x           the tile's x rows are copied in but not unpacked
    twice          each chunk's wgmmas issued twice
    one_wg         only consumer warpgroup 0 multiplies
    one_wg_twice   only warpgroup 0 multiplies, twice a chunk

Needs an NVIDIA H100 and nvcc:

    python3 tools/k1_bf16_breakdown.py

It prints the card's name and power limit, then one JSON line a round
and one with each variant's total ms over the two rounds.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT_DIR = ROOT / "build" / "k1_bf16_breakdown"
ROWS = 131072

_PRODUCTS = """    chunk_products_bf16<NW>(acc, sw128_desc(ablk) + 4 * (c & 1),
                            sw64_desc(sm.ring + cs.stage * kStageBytesB),
                            c == 0);
"""
_EPILOGUE = """  asm volatile("" : "+r"(r), "+r"(g), "+r"(t));
  if (l < a.n_layers - 1) {
"""
_STAGING = """    for (int q = sid; q < rows * units; q += kStagersB) {
"""

VARIANTS = {
    "base": [],
    "no_epilogue": ["NO_EPILOGUE"],
    "no_products": ["NO_PRODUCTS"],
    "no_x": ["NO_X"],
    "twice": ["TWICE"],
    "one_wg": ["ONE_WG"],
    "one_wg_twice": ["ONE_WG", "TWICE"],
}


def variant_source() -> str:
    """The kernel's source with each part behind a macro."""
    src = (ROOT / "animatable_nerf_tpu_torch" / "csrc" / "skip_mlp.cu").read_text()
    for anchor in (_PRODUCTS, _EPILOGUE, _STAGING):
        if src.count(anchor) != 1:
            raise RuntimeError("skip_mlp.cu changed: a variant anchor is "
                               "missing, update this tool")
    products = (
        "#ifndef NO_PRODUCTS\n"
        "#ifdef ONE_WG\n    if (cs.wg == 0)\n#endif\n" + _PRODUCTS
        + "#ifdef TWICE\n#ifdef ONE_WG\n    if (cs.wg == 0)\n#endif\n"
        + _PRODUCTS.replace("c == 0);", "false);") + "#endif\n#endif\n")
    epilogue = _EPILOGUE.replace(
        "  if (l < a.n_layers - 1) {\n",
        "#ifdef NO_EPILOGUE\n  if (l < a.n_layers - 1) {\n"
        "    fence_async_smem();\n    warpgroup_sync(cs.wg);\n    return;\n"
        "  }\n#endif\n  if (l < a.n_layers - 1) {\n")
    staging = ("#ifdef NO_X\n"
               "    for (int q = sid; q < 0; q += kStagersB) {\n#else\n"
               + _STAGING + "#endif\n")
    return (src.replace(_PRODUCTS, products).replace(_EPILOGUE, epilogue)
            .replace(_STAGING, staging))


def build_variants():
    from animatable_nerf_tpu_torch.ops import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "skip_mlp_variants.cu"
    src.write_text(variant_source())
    procs = {
        name: subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *[f"-D{m}" for m in macros],
             "-o", str(OUT_DIR / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()
    }
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return {name: ctypes.CDLL(str(OUT_DIR / f"lib{name}.so")) for name in VARIANTS}


def launcher(lib, x, packed, skips, act_last, out):
    """One call of a variant's skip_mlp_bf16_forward on the current
    stream, as ops/skip_mlp.py launches it."""
    import torch

    n_layers = len(packed.weights)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in packed.weights])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in packed.biases])
    douts = (ctypes.c_int * n_layers)(*packed.douts)
    fn = lib.skip_mlp_bf16_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mask = sum(1 << i for i in skips)

    def run():
        rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], n_layers,
                w_ptrs, b_ptrs, douts, mask, 0, int(act_last),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed (CUDA error {rc})")
    return run


def main():
    import torch

    import chip_smoke as cs
    from animatable_nerf_tpu_torch.ops import skip_mlp as k1

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(cs.card_line(), flush=True)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, din, dims, skips, act_last in cs.k1_wirings():
        x = (torch.rand(ROWS, din, device="cuda", generator=gen) * 2
             - 1).to(torch.bfloat16)
        layers = [(torch.randn(i, o, device="cuda", generator=gen) / math.sqrt(i),
                   torch.randn(o, device="cuda", generator=gen) * 0.1)
                  for i, o in dims]
        packed = k1.pack_layers(layers, skips, dtype=torch.bfloat16)
        out = torch.empty(ROWS, dims[-1][1], device="cuda")
        ref = k1.skip_mlp_plain(x, layers, skips, "relu", act_last)
        cases.append((name, x, packed, skips, act_last, out, ref))
    totals = {v: [] for v in VARIANTS}
    for rnd in range(2):
        line = {"round": rnd}
        for variant, lib in libs.items():
            ms = {}
            for name, x, packed, skips, act_last, out, ref in cases:
                run = launcher(lib, x, packed, skips, act_last, out)
                ms[name] = cs.cuda_ms(run)
                if variant == "base":
                    err = (out - ref).abs().max().item()
                    if not err <= cs.K1_BF16_REL_TOL * max(1.0, ref.abs().max().item()):
                        raise RuntimeError(f"base {name}: max abs err {err}")
            totals[variant].append(sum(ms.values()))
            line[variant] = ms
        print(json.dumps(line), flush=True)
    print(json.dumps({"rows": ROWS, "total_ms": totals}), flush=True)


if __name__ == "__main__":
    main()
