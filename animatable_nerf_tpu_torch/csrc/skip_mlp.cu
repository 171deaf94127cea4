// Fused skip-MLP forward for NVIDIA Hopper (sm_90a), on the tensor
// cores at float32 accuracy (3xTF32), and its bf16 form (the second
// kernel below, for compute_dtype bfloat16).
//
// Replaces the TPU kernel animatable_nerf_tpu/ops/mlp_pallas.py
// `fused_skip_mlp` (body `_mlp_kernel`): a whole stack of dense layers
// runs per tile of points, with ReLU/softplus/none after every layer but
// the last (or after the last too with act_last), and the ORIGINAL input
// re-concatenated in front of the activations after each layer listed in
// `skips` (the next layer then reads [x, h]).
//
// What bounds it here: arithmetic. The AniNeRF trunks are 8x256 layers
// (about 0.55 M multiply-adds per point). The products run on the
// tensor cores in TF32 with three passes per product (lo*hi, hi*lo,
// then hi*hi, each operand split as hi = rna_tf32(v), lo = rna_tf32(v -
// hi), accumulated in float32), so the least time is 3 x FLOP over the
// 495 TFLOP/s TF32 rate. Device-memory traffic is only x in and the
// output out; the weights (about 2 MB per stack) come from L2 once per
// block, so a block owns 128 rows, which halves that traffic against 64.
//
// Design (one block of 384 threads per SM):
//   * two consumer warpgroups of 64 rows each run wgmma.mma_async
//     m64n64k8 TF32 with A (the activations) from registers, split on
//     the fly, and B (the weights) from shared memory;
//   * a producer warpgroup streams the weights: ops/skip_mlp.py
//     `pack_layers` cuts each layer into chunks of 16 input features x
//     all outputs, each contiguous and in K-major core-matrix order, so
//     one thread brings a chunk in with one cp.async.bulk as soon as a
//     stage of the 3-stage ring is free, and three warps split it in
//     shared memory (hi in place, lo beside it). mbarriers hand the
//     stages over (loaded, full, empty), so copies and splits overlap
//     the consumers' products and each weight byte read from L2 feeds
//     128 rows;
//   * the activations h of the 128 rows stay in shared memory in float32
//     (row stride 260 floats: the A-fragment loads hit 32 banks); each
//     warp reads and writes only its own 16 rows, so layers need no
//     block barrier. Layer 0 reads x, staged in h's place; the layer
//     after a skip reads its x segment from global memory (x does not
//     fit beside h and the ring);
//   * the number of 64-wide output tiles is a template argument of the
//     products: a wgmma under a runtime condition makes ptxas serialize
//     them all. The epilogue is one short loop per activation: unrolled
//     code for every case missed the instruction cache;
//   * widths are padded to 16 in the packing, so the padding is exact;
//     ragged rows load zeros and skip stores.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 256;   // widest layer input or output
constexpr int kChunkK = 16;      // input features per packed weight chunk
constexpr int kConsumers = 2;    // warpgroups of 64 rows
constexpr int kTileRows = 64 * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;
constexpr int kHStride = kMaxWidth + 4;  // floats per row of h in smem
constexpr int kChunkFloats = kMaxWidth * kChunkK;
constexpr int kNTile = 64;  // wgmma N
constexpr int kSplitters = 96;  // producer threads that split chunks
// the ring's stages (hi and lo), h, and the ring's mbarriers: 231,496
// bytes of the 232,448 a block may have
constexpr int kSmemBytes =
    (kStages * 2 * kChunkFloats + kTileRows * kHStride) * sizeof(float) +
    3 * kStages * sizeof(uint64_t);

struct MLPArgs {
  const float* w[kMaxLayers];  // packed, see pack_layers
  const float* b[kMaxLayers];  // (np,) zero-padded
  int dout[kMaxLayers];        // true output width
  int np[kMaxLayers];          // padded output width
  int n_layers;
  int din;
  int din_p;
  unsigned skips;  // bit l: re-concat x after layer l's activation
  int act;         // 0 relu, 1 softplus, 2 none
  int act_last;
};

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// The TF32 value the tensor cores read, rounded to nearest with ties
// away from zero: the cvt.rna.tf32.f32 rule, by bit arithmetic (ptxas
// emulates cvt.rna with the same add and mask plus an inf/NaN guard,
// which finite values do not need).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo with hi, lo TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared-memory descriptor of a K-major, unswizzled B tile: core
// matrices of 8 rows (N) x 16 bytes (4 K), 128 bytes each; the next one
// along K at +128 bytes (leading offset), along N at +512 (stride).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 8, TF32, registers) x B (8 x 64, smem)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

struct Ring {
  float* stage;       // kStages x (hi, lo) x kChunkFloats
  uint64_t* loaded;   // the bulk copy has landed
  uint64_t* full;     // hi and lo are ready for the consumers
  uint64_t* empty;    // the consumers are done with the stage
};

// Walks the chunks of every layer in the order the consumers use them
// (Args: MLPArgs or the bf16 form's MLPArgsB).
struct Cursor {
  int l, c, k_width;  // layer, chunk, padded input width of the layer
  template <class Args>
  __device__ bool next(const Args& a) {
    if (++c * kChunkK >= k_width) {
      k_width = a.np[l] + (((a.skips >> l) & 1u) ? a.din_p : 0);
      ++l;
      c = 0;
    }
    return l < a.n_layers;
  }
};

// The producer warpgroup. Its last warp's first thread issues the bulk
// copies, each as soon as the consumers free a stage; the other three
// warps split each landed chunk into hi (in place) and lo and hand it
// to the consumers, so neither job waits on the other.
__device__ __forceinline__ void produce(const MLPArgs& args, const Ring& ring,
                                        int ptid) {
  Cursor cur{0, 0, args.din_p};
  int stage = 0;
  uint32_t phase = 0;
  if (ptid >= kSplitters) {
    if (ptid != kSplitters) return;
    do {
      mbar_wait(&ring.empty[stage], phase ^ 1u);
      const int chunk_floats = args.np[cur.l] * kChunkK;
      mbar_expect_tx(&ring.loaded[stage], chunk_floats * 4);
      bulk_load(ring.stage + stage * 2 * kChunkFloats,
                args.w[cur.l] + static_cast<size_t>(cur.c) * chunk_floats,
                chunk_floats * 4, &ring.loaded[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    } while (cur.next(args));
    return;
  }
  do {
    const int chunk_floats = args.np[cur.l] * kChunkK;
    float* hi = ring.stage + stage * 2 * kChunkFloats;
    float* lo = hi + kChunkFloats;
    mbar_wait(&ring.loaded[stage], phase);
#pragma unroll 4
    for (int e = 4 * ptid; e < chunk_floats; e += 4 * kSplitters) {
      const float4 v = *reinterpret_cast<const float4*>(hi + e);
      uint32_t h[4], o[4];
      split_tf32(v.x, h[0], o[0]);
      split_tf32(v.y, h[1], o[1]);
      split_tf32(v.z, h[2], o[2]);
      split_tf32(v.w, h[3], o[3]);
      *reinterpret_cast<uint4*>(hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + e) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    // these generic-proxy writes are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&ring.full[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  } while (cur.next(args));
}

// One chunk's products for the first NT n-tiles of 64 outputs, in
// 3xTF32 order (lo*hi, hi*lo, then hi*hi), then wait for them.
template <int NT>
__device__ __forceinline__ void chunk_products(
    float (&acc)[kMaxWidth / kNTile][32], uint32_t (&ahi)[2][4],
    uint32_t (&alo)[2][4], const float* hi) {
  const float* lo = hi + kChunkFloats;
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_operands(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // B of n-tile j, step s: core matrices (8j.., 2s) of the chunk
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wgmma_n64(acc[j], alo[s], b_desc(hi + 1024 * j + 64 * s));
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wgmma_n64(acc[j], ahi[s], b_desc(lo + 1024 * j + 64 * s));
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wgmma_n64(acc[j], ahi[s], b_desc(hi + 1024 * j + 64 * s));
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_operands(acc[j]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    fence_operands(ahi[s]);
    fence_operands(alo[s]);
  }
}

// A consumer warpgroup: 64 rows, all layers.
__device__ __forceinline__ void consume(const float* __restrict__ x,
                                        float* __restrict__ out, int n,
                                        const MLPArgs& args, const Ring& ring,
                                        float* hs, long long tile0, int wg,
                                        int ctid) {
  const int warp = ctid / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int din = args.din;
  const int din_p = args.din_p;
  const int wrow = 64 * wg + 16 * warp;  // this warp's first row in the tile
  float* hw = hs + wrow * kHStride;      // ... its rows of h
  const long long grow = tile0 + wrow + g;  // global rows grow, grow + 8

  // layer 0 reads x, staged where h goes (padded columns zero)
  for (int e = lane; e < 16 * din_p; e += 32) {
    const int r = e / din_p;
    const int k = e - r * din_p;
    const long long row = tile0 + wrow + r;
    hw[r * kHStride + k] = (row < n && k < din) ? x[row * din + k] : 0.f;
  }
  __syncwarp();

  int stage = 0;
  uint32_t phase = 0;
  int h_width = din_p;  // padded width of the segment read from hs
  bool with_x = false;  // the layer reads x from global memory first
  for (int l = 0; l < args.n_layers; ++l) {
    const int np = args.np[l];
    const int nt = (np + kNTile - 1) / kNTile;
    float acc[kMaxWidth / kNTile][32];
#pragma unroll
    for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = kNTile * j + 8 * q + 2 * t;
        const float b0 = c < np ? __ldg(args.b[l] + c) : 0.f;
        const float b1 = c + 1 < np ? __ldg(args.b[l] + c + 1) : 0.f;
        acc[j][4 * q + 0] = b0;
        acc[j][4 * q + 1] = b1;
        acc[j][4 * q + 2] = b0;
        acc[j][4 * q + 3] = b1;
      }
    }

    const int nx = with_x ? din_p / kChunkK : 0;
    const int nc = nx + h_width / kChunkK;
    for (int c = 0; c < nc; ++c) {
      // this lane's A values, split: rows g, g + 8 of the warp, columns
      // t, t + 4 of each of the chunk's two k8 steps
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float v[4];
        if (c < nx) {
          const int k = c * kChunkK + 8 * s + t;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long row = grow + 8 * (q & 1);
            const int kq = k + 4 * (q >> 1);
            v[q] = (row < n && kq < din) ? __ldg(x + row * din + kq) : 0.f;
          }
        } else {
          const float* a = hw + g * kHStride + (c - nx) * kChunkK + 8 * s + t;
          v[0] = a[0];
          v[1] = a[8 * kHStride];
          v[2] = a[4];
          v[3] = a[8 * kHStride + 4];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(v[q], ahi[s][q], alo[s][q]);
      }

      mbar_wait(&ring.full[stage], phase);
      const float* hi = ring.stage + stage * 2 * kChunkFloats;
      switch (nt) {
        case 1: chunk_products<1>(acc, ahi, alo, hi); break;
        case 2: chunk_products<2>(acc, ahi, alo, hi); break;
        case 3: chunk_products<3>(acc, ahi, alo, hi); break;
        default: chunk_products<4>(acc, ahi, alo, hi); break;
      }
      mbar_arrive(&ring.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    __syncwarp();  // every lane of the warp has read its rows of hs
    const bool last = l == args.n_layers - 1;
    if (!last || args.act_last) {
      // one short loop per activation: the epilogue runs once per layer,
      // and unrolled code for every case would miss the instruction cache
      if (args.act == 0) {
#pragma unroll
        for (int j = 0; j < kMaxWidth / kNTile; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[j][e] = fmaxf(acc[j][e], 0.f);
      } else if (args.act == 1) {
#pragma unroll
        for (int j = 0; j < kMaxWidth / kNTile; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[j][e] = softplus(acc[j][e]);
      }
    }
    if (last) {
      const int dout = args.dout[l];
#pragma unroll
      for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = kNTile * j + 8 * q + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = grow + 8 * h;
            if (row < n && c < dout) out[row * dout + c] = acc[j][4 * q + 2 * h];
            if (row < n && c + 1 < dout)
              out[row * dout + c + 1] = acc[j][4 * q + 2 * h + 1];
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = kNTile * j + 8 * q + 2 * t;
          if (c < np) {
            *reinterpret_cast<float2*>(hw + g * kHStride + c) =
                make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
            *reinterpret_cast<float2*>(hw + (g + 8) * kHStride + c) =
                make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
          }
        }
      }
    }
    __syncwarp();  // ... and written them before the next layer reads
    h_width = np;
    with_x = (args.skips >> l) & 1u;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    skip_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, MLPArgs args) {
  extern __shared__ __align__(128) float smem[];
  Ring ring;
  ring.stage = smem;
  float* hs = smem + kStages * 2 * kChunkFloats;  // kTileRows x kHStride
  uint64_t* bars = reinterpret_cast<uint64_t*>(hs + kTileRows * kHStride);
  ring.loaded = bars;
  ring.full = bars + kStages;
  ring.empty = bars + 2 * kStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.loaded[s], 1);
      mbar_init(&ring.full[s], kSplitters);
      mbar_init(&ring.empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileRows;
  // registers: the launch gives 168 a thread (65,536 / 384); the producer
  // hands most of its share to the consumers' accumulators (2 x 128 x
  // 224 + 128 x 56 = 64,512)
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce(args, ring, tid - 128 * kConsumers);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consume(x, out, n, args, ring, hs, tile0, wg, tid % 128);
  }
}

// ---------------------------------------------------------------------
// The bf16 form (compute_dtype bfloat16): the same contract with bf16
// operands into wgmma m64nNk16 and a float32 accumulator, rounded as
// the JAX package's bf16 trunk rounds on XLA (fields/mlp.py `SkipMLP`
// with dtype bfloat16; ops/skip_mlp.py `skip_mlp_plain` names the
// places): the product of each layer to bf16, then the bias (a bf16
// value) added and the sum rounded to bf16 again, then the activation;
// the last layer without act_last keeps the sum of its rounded product
// and its bias in float32. x comes in bf16 and is what the skip concat
// re-reads.
//
// What bounds it: arithmetic again, now at the bf16 tensor-core rate
// (989 TFLOP/s, one pass instead of 3xTF32's three). The design is the
// float32 form's without the split: the producer warpgroup's one thread
// streams each packed bf16 weight chunk (16 input features x all
// outputs, K-major core matrices of 8 rows x 8 values) into a 4-stage
// ring with one bulk copy whose completion the consumers wait on; the
// two consumer warpgroups keep their 64 rows of h in shared memory as
// bf16 (row stride 264 values: the A-fragment loads and the epilogue's
// stores hit 32 banks) and take A from registers.

constexpr int kStagesB = 4;
constexpr int kHStrideB = kMaxWidth + 8;  // bf16 per row of h in smem
constexpr int kChunkElemsB = kMaxWidth * kChunkK;
constexpr int kSmemBytesB =
    kStagesB * kChunkElemsB * 2 + kTileRows * kHStrideB * 2 +
    2 * kStagesB * sizeof(uint64_t);

struct MLPArgsB {
  const __nv_bfloat16* w[kMaxLayers];  // packed, see pack_layers
  const float* b[kMaxLayers];          // (np,) bf16 values, zero-padded
  int dout[kMaxLayers];
  int np[kMaxLayers];
  int n_layers;
  int din;
  int din_p;
  unsigned skips;
  int act;
  int act_last;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Shared-memory descriptor of a K-major, unswizzled bf16 B tile: core
// matrices of 8 rows (N) x 16 bytes (8 K), 128 bytes each; the next one
// along K at +128 bytes (leading offset), along N at +256 (stride).
__device__ __forceinline__ uint64_t b_desc_bf16(const __nv_bfloat16* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) x B (16 x 64, smem)
__device__ __forceinline__ void wgmma_n64_bf16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The producer of the bf16 form: one thread issues every chunk's bulk
// copy as soon as the consumers free its stage.
__device__ __forceinline__ void produce_bf16(const MLPArgsB& args,
                                             __nv_bfloat16* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int ptid) {
  if (ptid != 0) return;
  Cursor cur{0, 0, args.din_p};
  int stage = 0;
  uint32_t phase = 0;
  do {
    mbar_wait(&empty[stage], phase ^ 1u);
    const int chunk_elems = args.np[cur.l] * kChunkK;
    mbar_expect_tx(&full[stage], chunk_elems * 2);
    bulk_load(ring + stage * kChunkElemsB,
              args.w[cur.l] + static_cast<size_t>(cur.c) * chunk_elems,
              chunk_elems * 2, &full[stage]);
    if (++stage == kStagesB) {
      stage = 0;
      phase ^= 1u;
    }
  } while (cur.next(args));
}

template <int NT>
__device__ __forceinline__ void chunk_products_bf16(
    float (&acc)[kMaxWidth / kNTile][32], uint32_t (&a)[4],
    const __nv_bfloat16* chunk) {
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_operands(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wgmma_n64_bf16(acc[j], a, b_desc_bf16(chunk + 1024 * j));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_operands(acc[j]);
  fence_operands(a);
}

__device__ __forceinline__ float activate(float v, int act) {
  return act == 0 ? fmaxf(v, 0.f) : act == 1 ? softplus(v) : v;
}

// A consumer warpgroup of the bf16 form: 64 rows, all layers.
__device__ __forceinline__ void consume_bf16(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ out, int n,
    const MLPArgsB& args, const __nv_bfloat16* ring, uint64_t* full,
    uint64_t* empty, __nv_bfloat16* hs, long long tile0, int wg, int ctid) {
  const int warp = ctid / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int din = args.din;
  const int din_p = args.din_p;
  const int wrow = 64 * wg + 16 * warp;
  __nv_bfloat16* hw = hs + wrow * kHStrideB;
  const long long grow = tile0 + wrow + g;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int e = lane; e < 16 * din_p; e += 32) {
    const int r = e / din_p;
    const int k = e - r * din_p;
    const long long row = tile0 + wrow + r;
    hw[r * kHStrideB + k] = (row < n && k < din) ? x[row * din + k] : zero;
  }
  __syncwarp();

  int stage = 0;
  uint32_t phase = 0;
  int h_width = din_p;
  bool with_x = false;
  for (int l = 0; l < args.n_layers; ++l) {
    const int np = args.np[l];
    const int nt = (np + kNTile - 1) / kNTile;
    float acc[kMaxWidth / kNTile][32];
#pragma unroll
    for (int j = 0; j < kMaxWidth / kNTile; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;

    const int nx = with_x ? din_p / kChunkK : 0;
    const int nc = nx + h_width / kChunkK;
    for (int c = 0; c < nc; ++c) {
      // this lane's A values: rows g, g + 8 of the warp, columns 2t,
      // 2t + 1 and 2t + 8, 2t + 9 of the chunk, two to a register
      uint32_t a[4];
      if (c < nx) {
        const int k = c * kChunkK + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long row = grow + 8 * (q & 1);
          const int kq = k + 8 * (q >> 1);
          const __nv_bfloat16 v0 =
              (row < n && kq < din) ? x[row * din + kq] : zero;
          const __nv_bfloat16 v1 =
              (row < n && kq + 1 < din) ? x[row * din + kq + 1] : zero;
          a[q] = pack_bf16x2(v0, v1);
        }
      } else {
        const __nv_bfloat16* p =
            hw + g * kHStrideB + (c - nx) * kChunkK + 2 * t;
        a[0] = *reinterpret_cast<const uint32_t*>(p);
        a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kHStrideB);
        a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kHStrideB + 8);
      }

      mbar_wait(&full[stage], phase);
      const __nv_bfloat16* chunk = ring + stage * kChunkElemsB;
      switch (nt) {
        case 1: chunk_products_bf16<1>(acc, a, chunk); break;
        case 2: chunk_products_bf16<2>(acc, a, chunk); break;
        case 3: chunk_products_bf16<3>(acc, a, chunk); break;
        default: chunk_products_bf16<4>(acc, a, chunk); break;
      }
      mbar_arrive(&empty[stage]);
      if (++stage == kStagesB) {
        stage = 0;
        phase ^= 1u;
      }
    }

    __syncwarp();  // every lane of the warp has read its rows of hs
    const bool last = l == args.n_layers - 1;
    const bool act = !last || args.act_last;
    // the rounded product plus the bias; rounded and activated again
    // but for the last layer without act_last
#pragma unroll
    for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = kNTile * j + 8 * q + 2 * t;
        const float b0 = c < np ? __ldg(args.b[l] + c) : 0.f;
        const float b1 = c + 1 < np ? __ldg(args.b[l] + c + 1) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = round_bf16(acc[j][4 * q + e]) + ((e & 1) ? b1 : b0);
          if (act) v = round_bf16(activate(round_bf16(v), args.act));
          acc[j][4 * q + e] = v;
        }
      }
    }
    if (last) {
      const int dout = args.dout[l];
#pragma unroll
      for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = kNTile * j + 8 * q + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = grow + 8 * h;
            if (row < n && c < dout) out[row * dout + c] = acc[j][4 * q + 2 * h];
            if (row < n && c + 1 < dout)
              out[row * dout + c + 1] = acc[j][4 * q + 2 * h + 1];
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxWidth / kNTile; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = kNTile * j + 8 * q + 2 * t;
          if (c < np) {
            *reinterpret_cast<uint32_t*>(hw + g * kHStrideB + c) =
                pack_bf16x2(__float2bfloat16_rn(acc[j][4 * q]),
                            __float2bfloat16_rn(acc[j][4 * q + 1]));
            *reinterpret_cast<uint32_t*>(hw + (g + 8) * kHStrideB + c) =
                pack_bf16x2(__float2bfloat16_rn(acc[j][4 * q + 2]),
                            __float2bfloat16_rn(acc[j][4 * q + 3]));
          }
        }
      }
    }
    __syncwarp();  // ... and written them before the next layer reads
    h_width = np;
    with_x = (args.skips >> l) & 1u;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    skip_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         float* __restrict__ out, int n, MLPArgsB args) {
  extern __shared__ __align__(128) unsigned char smem_b[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_b);
  __nv_bfloat16* hs = ring + kStagesB * kChunkElemsB;  // kTileRows x kHStrideB
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + kTileRows * kHStrideB);
  uint64_t* empty = full + kStagesB;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileRows;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce_bf16(args, ring, full, empty, tid - 128 * kConsumers);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consume_bf16(x, out, n, args, ring, full, empty, hs, tile0, wg,
                 tid % 128);
  }
}

}  // namespace

extern "C" {

int skip_mlp_max_layers() { return kMaxLayers; }
int skip_mlp_max_width() { return kMaxWidth; }
int skip_mlp_chunk_k() { return kChunkK; }

// out (n, dout[n_layers - 1]) = MLP(x (n, din)); w[l] packed by
// pack_layers, b[l] its padded bias. Returns 0 or the CUDA error of the
// launch (cudaGetLastError).
int skip_mlp_forward(const float* x, float* out, int n, int din, int n_layers,
                     const void* const* w, const void* const* b,
                     const int* dout, unsigned skips, int act, int act_last,
                     void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || din < 1 || din > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  MLPArgs args;
  for (int l = 0; l < n_layers; ++l) {
    if (dout[l] < 1 || dout[l] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    args.w[l] = static_cast<const float*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.dout[l] = dout[l];
    args.np[l] = (dout[l] + kChunkK - 1) / kChunkK * kChunkK;
  }
  args.n_layers = n_layers;
  args.din = din;
  args.din_p = (din + kChunkK - 1) / kChunkK * kChunkK;
  args.skips = skips;
  args.act = act;
  args.act_last = act_last;
  cudaError_t err = cudaFuncSetAttribute(
      skip_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kTileRows - 1) / kTileRows;
  skip_mlp_kernel<<<blocks, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(x, out, n, args);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: x (n, din) bf16, w[l] packed bf16 by pack_layers, b[l]
// its padded bias as float32 holding bf16 values; out (n, dout) float32.
int skip_mlp_bf16_forward(const void* x, float* out, int n, int din,
                          int n_layers, const void* const* w,
                          const void* const* b, const int* dout,
                          unsigned skips, int act, int act_last,
                          void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || din < 1 || din > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  MLPArgsB args;
  for (int l = 0; l < n_layers; ++l) {
    if (dout[l] < 1 || dout[l] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    args.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.dout[l] = dout[l];
    args.np[l] = (dout[l] + kChunkK - 1) / kChunkK * kChunkK;
  }
  args.n_layers = n_layers;
  args.din = din;
  args.din_p = (din + kChunkK - 1) / kChunkK * kChunkK;
  args.skips = skips;
  args.act = act;
  args.act_last = act_last;
  cudaError_t err = cudaFuncSetAttribute(
      skip_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytesB);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kTileRows - 1) / kTileRows;
  skip_mlp_bf16_kernel<<<blocks, kThreads, kSmemBytesB,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), out, n, args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
