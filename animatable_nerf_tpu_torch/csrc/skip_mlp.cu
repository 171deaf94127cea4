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

// Walks the chunks of every layer in the order the consumers use them.
struct Cursor {
  int l, c, k_width;  // layer, chunk, padded input width of the layer
  __device__ bool next(const MLPArgs& a) {
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
// What bounds it: arithmetic at the bf16 tensor-core rate (989
// TFLOP/s; 0.419 ms for the three AniNeRF wirings at 131,072 rows).
// Every 128-row tile multiplies by the whole stack, so the packed
// weights (about 1 MB a wiring) stream from L2 into shared memory once
// a tile: about 1.1 GB a wiring a call. On the H100 that stream alone
// runs at 13-20 TB/s (`skip_mlp_bf16_feed_kernel`), three to five
// times what the kernel draws, so each tile reads its own chunks and
// no cluster shares them.
//
// Design (one persistent block of 384 threads per SM, walking tiles of
// 128 rows):
//   * the products read both operands from shared memory by
//     descriptor: A (the tile's h, or x) K-major with the 128-byte
//     swizzle in blocks of 64 input features, B (the weights) K-major
//     with the 64-byte swizzle in chunks of 32. One m64n256k16 covers a
//     hidden layer's whole width a k-step; layers up to 64 wide (the
//     heads) take m64n64k16;
//   * ops/skip_mlp.py `pack_layers` stores each layer's W^T in chunks
//     of 32 input features x all outputs, already swizzled, so one bulk
//     copy of up to 16 KB fills a stage. The ring has as many stages as
//     shared memory holds beside h and x's two buffers (4 for 192-wide
//     x, 8 for 64-wide);
//   * chunk c + 1's wgmmas are issued before chunk c's retire
//     (wgmma.wait_group 1), and a stage goes back to the producer when
//     its group retires;
//   * the epilogue writes h (bf16) in A's swizzled layout, in place,
//     each consumer warpgroup its own 64 rows, after its layer's last
//     group retires; a fence to the async proxy and a warpgroup barrier
//     come before the next layer reads it. A hidden layer's bias add,
//     rounding and relu are one fma.rn.relu.bf16x2 a pair of columns;
//   * x is staged once a tile: one bulk copy brings the tile's rows as
//     they lie in memory (a width that is no multiple of 8 leaves rows
//     not 16-byte aligned one by one) while the previous tile runs, and three
//     producer warps unpack them into the swizzled blocks, 16 bytes a
//     shared store, once the previous tile's last skip has retired; the
//     fourth producer warp streams the chunks, across tiles;
//   * widths are padded to 16 outputs and 64 inputs in the packing, so
//     the padding is exact; the epilogue writes zeros in h's padded
//     columns. The n-tile is a template argument: a wgmma under a
//     runtime condition makes ptxas serialize them all, and so does a
//     register allocation that runs short (C7511: six n-tilings did).
//
// What holds it at about half its bound (tools/k1_bf16_breakdown.py
// times the parts on the card): the products run at the tensor-core
// rate while they run, but the epilogues and the hand-offs between
// chunks and layers do not overlap them, and one warpgroup alone does
// not reach that rate, so staggering the two warpgroups gains nothing.

constexpr int kChunkKB = 32;  // input features per weight chunk: 64-byte rows
constexpr int kBlockKB = 64;  // input features per block of h or x: 128-byte rows
constexpr int kStageBytesB = kMaxWidth * kChunkKB * 2;  // 16 KB
constexpr int kBlockBytesB = kTileRows * kBlockKB * 2;  // 16 KB
constexpr int kHBytesB = kMaxWidth / kBlockKB * kBlockBytesB;  // 64 KB
constexpr int kAccB = kMaxWidth / 2;  // accumulator floats a thread (m64n256)
constexpr int kMaxStagesB = 10;
constexpr int kStagersB = 96;  // producer threads that stage x
constexpr int kSmemLimitB = 232448;

struct MLPArgsB {
  const __nv_bfloat16* w[kMaxLayers];  // packed, see pack_layers
  const float* b[kMaxLayers];          // (np,) bf16 values, zero-padded
  int dout[kMaxLayers];
  int np[kMaxLayers];     // output width padded to 16
  int nx[kMaxLayers];     // chunks of x the layer reads first
  int nc[kMaxLayers];     // chunks of the layer (two a 64-wide block)
  int n_layers;
  int din;
  int x_blocks;  // 64-wide blocks of x
  int x_last;    // the last layer that reads x
  int raw_bytes;  // x_raw: a tile's rows of x, and 16 bytes more
  int stages;
  int n_tiles;
  int act;
  int act_last;
};

// The shared-memory layout of one block, as 32-bit shared addresses
// (the consumers keep them beside 128 accumulators), from a 1024-byte
// aligned base: the swizzle's pattern repeats every 8 rows of 128 bytes
struct SmemB {
  uint32_t ring;     // stages x kStageBytesB
  uint32_t h;        // kHBytesB
  uint32_t x;        // x_blocks x kBlockBytesB
  uint32_t full;     // stages mbarriers: a stage's chunk has landed
  uint32_t empty;    // stages mbarriers: both consumer warpgroups are done
  uint32_t x_raw;    // the tile's x rows as they are in memory
  uint32_t x_ready;  // the tile's x is staged
  uint32_t x_free;   // the tile's last x-reading layer has retired
  uint32_t raw_full;  // the tile's x rows have landed in x_raw
};

__device__ __forceinline__ SmemB smem_layout_bf16(unsigned char* raw,
                                                  const MLPArgsB& a) {
  SmemB s;
  s.ring = (smem_addr(raw) + 1023) & ~1023u;
  s.h = s.ring + a.stages * kStageBytesB;
  s.x = s.h + kHBytesB;
  s.x_raw = s.x + a.x_blocks * kBlockBytesB;
  s.full = s.x_raw + a.raw_bytes;
  s.empty = s.full + 8 * a.stages;
  s.x_ready = s.empty + 8 * a.stages;
  s.x_free = s.x_ready + 8;
  s.raw_full = s.x_free + 8;
  return s;
}

// The mbarrier helpers above, on 32-bit shared addresses
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Descriptor of a K-major tile with the 128-byte swizzle (A: h or x):
// rows of 128 bytes (64 bf16 along K), the next 8 rows at +1024 bytes;
// the leading offset is unused with a swizzle. A k-step of 16 is +32
// bytes: +2.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The same with the 64-byte swizzle (B: a weight chunk): rows of 64
// bytes (32 bf16 along K), the next 8 rows at +512 bytes.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// Byte offset of (row r, column k) in a block of 64 columns with the
// 128-byte swizzle: 16-byte unit k / 8 of the row, XOR r % 8 (h and x).
__device__ __forceinline__ int sw128_offset(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
}

// two floats from global memory, in program order with the other
// volatile asm (__ldg may be hoisted out of an epilogue group)
__device__ __forceinline__ float2 ld_float2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// byte offset of x's (row r, column k) in the x blocks
__device__ __forceinline__ uint32_t x_offset(int r, int k) {
  return (k >> 6) * kBlockBytesB + sw128_offset(r, k & 63);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<unsigned short>(v))
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// lo, hi rounded to bf16 and back to float32
__device__ __forceinline__ float2 round_bf16x2(float lo, float hi) {
  const uint32_t p = pack_bf16x2(lo, hi);
  return make_float2(__uint_as_float(p << 16), __uint_as_float(p & 0xFFFF0000u));
}

// the larger of each bf16 half of a and b
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a + b of two bf16 pairs, rounded to bf16 once: for bf16 operands the
// same as their float32 sum rounded to bf16 (that sum is exact unless
// their exponents differ by more than 15, and then both give the larger)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return r;
}

// relu(a + b), rounded once: relu commutes with the rounding
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return r;
}

template <int O>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[kAccB], uint64_t da,
                                           uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int O>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[kAccB], uint64_t da,
                                           uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63]),
        "+f"(d[O + 64]), "+f"(d[O + 65]), "+f"(d[O + 66]), "+f"(d[O + 67]),
        "+f"(d[O + 68]), "+f"(d[O + 69]), "+f"(d[O + 70]), "+f"(d[O + 71]),
        "+f"(d[O + 72]), "+f"(d[O + 73]), "+f"(d[O + 74]), "+f"(d[O + 75]),
        "+f"(d[O + 76]), "+f"(d[O + 77]), "+f"(d[O + 78]), "+f"(d[O + 79]),
        "+f"(d[O + 80]), "+f"(d[O + 81]), "+f"(d[O + 82]), "+f"(d[O + 83]),
        "+f"(d[O + 84]), "+f"(d[O + 85]), "+f"(d[O + 86]), "+f"(d[O + 87]),
        "+f"(d[O + 88]), "+f"(d[O + 89]), "+f"(d[O + 90]), "+f"(d[O + 91]),
        "+f"(d[O + 92]), "+f"(d[O + 93]), "+f"(d[O + 94]), "+f"(d[O + 95]),
        "+f"(d[O + 96]), "+f"(d[O + 97]), "+f"(d[O + 98]), "+f"(d[O + 99]),
        "+f"(d[O + 100]), "+f"(d[O + 101]), "+f"(d[O + 102]),
        "+f"(d[O + 103]), "+f"(d[O + 104]), "+f"(d[O + 105]),
        "+f"(d[O + 106]), "+f"(d[O + 107]), "+f"(d[O + 108]),
        "+f"(d[O + 109]), "+f"(d[O + 110]), "+f"(d[O + 111]),
        "+f"(d[O + 112]), "+f"(d[O + 113]), "+f"(d[O + 114]),
        "+f"(d[O + 115]), "+f"(d[O + 116]), "+f"(d[O + 117]),
        "+f"(d[O + 118]), "+f"(d[O + 119]), "+f"(d[O + 120]),
        "+f"(d[O + 121]), "+f"(d[O + 122]), "+f"(d[O + 123]),
        "+f"(d[O + 124]), "+f"(d[O + 125]), "+f"(d[O + 126]), "+f"(d[O + 127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One chunk's four k-steps, d (64 x NW, f32) (+)= A (64 x 16, smem) x
// B (16 x NW, smem) each; the first k-step of a layer overwrites the
// accumulator (scale-d 0).
template <int NW>
__device__ __forceinline__ void chunk_products_bf16(float (&acc)[kAccB],
                                                    uint64_t da, uint64_t db,
                                                    bool first) {
#pragma unroll
  for (int s = 0; s < kChunkKB / 16; ++s) {
    const uint32_t scale = (first && s == 0) ? 0u : 1u;
    if constexpr (NW == 256) {
      wgmma_ss_n256<0>(acc, da + 2 * s, db + 2 * s, scale);
    } else {
      wgmma_ss_n64<0>(acc, da + 2 * s, db + 2 * s, scale);
    }
  }
}

// The bf16 values first .. first + 7 of the 16 in (lo, hi), as four
// words (first in 0 .. 7)
__device__ __forceinline__ void take_values(uint4 lo, uint4 hi, int first,
                                            uint32_t (&v)[4]) {
  const int p = first >> 1;
  const uint32_t w0 = p == 0 ? lo.x : p == 1 ? lo.y : p == 2 ? lo.z : lo.w;
  const uint32_t w1 = p == 0 ? lo.y : p == 1 ? lo.z : p == 2 ? lo.w : hi.x;
  const uint32_t w2 = p == 0 ? lo.z : p == 1 ? lo.w : p == 2 ? hi.x : hi.y;
  const uint32_t w3 = p == 0 ? lo.w : p == 1 ? hi.x : p == 2 ? hi.y : hi.z;
  const uint32_t w4 = p == 0 ? hi.x : p == 1 ? hi.y : p == 2 ? hi.z : hi.w;
  if (first & 1) {
    v[0] = __funnelshift_r(w0, w1, 16);
    v[1] = __funnelshift_r(w1, w2, 16);
    v[2] = __funnelshift_r(w2, w3, 16);
    v[3] = __funnelshift_r(w3, w4, 16);
  } else {
    v[0] = w0;
    v[1] = w1;
    v[2] = w2;
    v[3] = w3;
  }
}

// The producer warpgroup of the bf16 form. Its first thread streams
// every tile's chunks through the ring, each as soon as both consumer
// warpgroups free its stage; warps 1-3 stage each tile's x, swizzled,
// once the previous tile's last x-reading layer has retired.
__device__ __forceinline__ void produce_bf16(const __nv_bfloat16* __restrict__ x,
                                             int n, const MLPArgsB& a,
                                             const SmemB& sm, int ptid) {
  if (ptid == 0) {
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      for (int l = 0; l < a.n_layers; ++l) {
        const int bytes = a.np[l] * kChunkKB * 2;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(a.w[l]);
        for (int c = 0; c < a.nc[l]; ++c) {
          mbar_wait(sm.empty + 8 * stage, phase ^ 1u);
          mbar_expect_tx(sm.full + 8 * stage, bytes);
          bulk_load(sm.ring + stage * kStageBytesB,
                    src + static_cast<size_t>(c) * bytes, bytes,
                    sm.full + 8 * stage);
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }
  if (ptid < 128 - kStagersB) return;
  const int sid = ptid - (128 - kStagersB);
  const uint32_t xs = sm.x;
  // x's padded columns stay zero: the tiles write columns < din only
  const int pad = a.x_blocks * kBlockKB - a.din;
  for (int e = sid; e < kTileRows * pad; e += kStagersB) {
    const int r = e / pad;
    st_shared_u16(xs + x_offset(r, a.din + (e - r * pad)), 0);
  }
  // A tile's rows of x are one contiguous, 16-byte aligned run of bf16
  // (128 x din x 2 bytes): the first stager brings it into x_raw with
  // one bulk copy as soon as the previous tile's is unpacked, so it
  // lands while the consumers still run that tile. After the previous
  // tile's last x-reading layer retires, each stager builds 16-byte
  // units of the swizzled x from two aligned 16-byte reads of x_raw.
  // Rows past n keep an older tile's values, whose outputs are not
  // stored; the copy's last 16 bytes may run past n x din values, but
  // not past the aligned 16 bytes that hold the last one, which lie
  // inside x's allocation.
  const int units = (a.din + 7) / 8;  // units of a row that hold values
  auto fetch = [&](int tile) {
    const long long tile0 = static_cast<long long>(tile) * kTileRows;
    const long long rows = n - tile0 < kTileRows ? n - tile0 : kTileRows;
    const int bytes = static_cast<int>((rows * a.din * 2 + 15) / 16 * 16);
    mbar_expect_tx(sm.raw_full, bytes);
    bulk_load(sm.x_raw, x + tile0 * a.din, bytes, sm.raw_full);
  };
  if (sid == 0 && static_cast<int>(blockIdx.x) < a.n_tiles) fetch(blockIdx.x);
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++it) {
    const long long tile0 = static_cast<long long>(tile) * kTileRows;
    const int rows = n - tile0 < kTileRows ? static_cast<int>(n - tile0)
                                           : kTileRows;
    mbar_wait(sm.raw_full, it & 1);
    mbar_wait(sm.x_free, (it & 1) ^ 1u);
    for (int q = sid; q < rows * units; q += kStagersB) {
      const int r = q / units;
      const int u = q - r * units;
      const int byte = 2 * (r * a.din + 8 * u);  // in x_raw
      const uint4 lo = ld_shared_v4(sm.x_raw + (byte & ~15));
      const uint4 hi = ld_shared_v4(sm.x_raw + (byte & ~15) + 16);
      uint32_t v[4];
      take_values(lo, hi, (byte & 15) >> 1, v);
      const int valid = a.din - 8 * u;  // the last unit: zeros past din
      if (valid < 8) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (2 * i >= valid) v[i] = 0u;
          else if (2 * i + 1 >= valid) v[i] &= 0xFFFFu;
        }
      }
      st_shared_v4(xs + x_offset(r, 8 * u), v[0], v[1], v[2], v[3]);
    }
    // these generic-proxy writes are read by wgmma (the async proxy)
    fence_async_smem();
    mbar_arrive(sm.x_ready);
    // every stager has read x_raw: the next tile's rows may come in
    asm volatile("bar.sync 3, %0;\n" ::"n"(kStagersB) : "memory");
    if (sid == 0 && tile + static_cast<int>(gridDim.x) < a.n_tiles) {
      fence_async_smem();
      fetch(tile + gridDim.x);
    }
  }
}

struct ConsumerB {
  int wg, warp, lane, g, t;
  int stage;
  uint32_t phase;
};

// One layer of a consumer warpgroup: its chunks' products with one
// group in flight behind the newest, then the epilogue into h (or out).
// NW: the layer's n-tile, 256 or (for outputs up to 64 wide) 64; the
// columns past its padded width are computed from whatever the stage
// holds there and discarded.
template <int NW>
__device__ __forceinline__ void layer_bf16(float* __restrict__ out, int n,
                                        const MLPArgsB& a, const SmemB& sm,
                                        ConsumerB& cs, int l,
                                        long long tile0) {
  float acc[kAccB];
  const int nx = a.nx[l];
  const int nc = a.nc[l];
  const int rows = cs.wg * (kBlockBytesB / 2);  // this warpgroup's 64 rows
  int prev = 0;
  for (int c = 0; c < nc; ++c) {
    // chunk c: input features 32c .. 32c + 31 of the layer, the first
    // or second half of a 64-wide block of x or h (+64 bytes: +4)
    const int blk = c >> 1;
    const uint32_t ablk =
        (2 * blk < nx ? sm.x + blk * kBlockBytesB
                      : sm.h + (blk - nx / 2) * kBlockBytesB) +
        rows;
    mbar_wait(sm.full + 8 * cs.stage, cs.phase);
    fence_operands(acc);
    wgmma_fence();
    chunk_products_bf16<NW>(acc, sw128_desc(ablk) + 4 * (c & 1),
                            sw64_desc(sm.ring + cs.stage * kStageBytesB),
                            c == 0);
    wgmma_commit();
    if (c > 0) {
      // chunk c - 1's group has retired: its stage goes back
      wgmma_wait<1>();
      fence_operands(acc);
      if (cs.lane == 0) mbar_arrive(sm.empty + 8 * prev);
    }
    prev = cs.stage;
    if (++cs.stage == a.stages) {
      cs.stage = 0;
      cs.phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (cs.lane == 0) {
    mbar_arrive(sm.empty + 8 * prev);
    if (l == a.x_last) mbar_arrive(sm.x_free);
  }

  // the epilogue: the rounded product plus the bias, rounded and
  // activated. Its unrolled part is a few instructions a pair of
  // columns (relu folds into one bf16x2 max): unrolled softplus code
  // for every element would miss the instruction cache, so softplus
  // runs after it in a loop over the values written.
  const float* bias = a.b[l];
  const int np = a.np[l];
  // the lane's row and column, opaque to the compiler: what derives from
  // them is computed here each layer, not hoisted out of the loops and
  // held beside the accumulators
  int r = cs.wg * 64 + cs.warp * 16 + cs.g;  // rows r and r + 8
  int g = cs.g, t = cs.t;
  asm volatile("" : "+r"(r), "+r"(g), "+r"(t));
  if (l < a.n_layers - 1) {
    // into h, in place; zeros in the padded columns
    const uint32_t hrow = sm.h + r * 128 + 4 * t;
    if (a.act == 0 && np == NW) {
      // the hidden layers: relu, no padded columns; one bf16x2
      // instruction adds, rounds and activates a pair
#pragma unroll
      for (int j0 = 0; j0 < NW / 8; j0 += 8) {
        // 64 columns at a time: the barrier and the volatile loads keep
        // the compiler from hoisting every group's bias loads beside the
        // accumulators (they spill at 224 registers)
        asm volatile("" ::: "memory");
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j) {
          const float2 bf = ld_float2(bias + 8 * j + 2 * t);
          const uint32_t b = pack_bf16x2(bf.x, bf.y);  // bf16 values already
          const uint32_t dst = hrow + (j >> 3) * kBlockBytesB + (((j & 7) ^ g) << 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)  // row r + 8: 1024 bytes on
            st_shared_u32(dst + h * 1024,
                          add_relu_bf16x2(pack_bf16x2(acc[4 * j + 2 * h],
                                                      acc[4 * j + 2 * h + 1]),
                                          b));
        }
      }
    } else {
      const uint32_t floor = a.act == 0 ? 0u : 0xFF80FF80u;  // 0 or -inf
#pragma unroll
      for (int j0 = 0; j0 < NW / 8; j0 += 8) {
        asm volatile("" ::: "memory");
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 bf = c < np ? ld_float2(bias + c) : make_float2(0.f, 0.f);
          const uint32_t b = pack_bf16x2(bf.x, bf.y);
          const uint32_t dst = hrow + (j >> 3) * kBlockBytesB + (((j & 7) ^ g) << 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t p = pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            const uint32_t v = max_bf16x2(add_bf16x2(p, b), floor);
            st_shared_u32(dst + h * 1024, c < np ? v : 0u);
          }
        }
      }
    }
    if (a.act == 1) {
      for (int j = 0; j < NW / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c >= np) continue;
        const uint32_t dst = hrow + (j >> 3) * kBlockBytesB + (((j & 7) ^ g) << 4);
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = ld_shared_u32(dst + h * 1024);
          st_shared_u32(dst + h * 1024,
                        pack_bf16x2(softplus(__uint_as_float(v << 16)),
                                    softplus(__uint_as_float(v & 0xFFFF0000u))));
        }
      }
    }
    fence_async_smem();
    warpgroup_sync(cs.wg);
  } else {
    // into out: the float32 sum, or with act_last its rounded activation;
    // each row's pointer once, indexed by 32-bit columns (64-bit column
    // offsets would be hoisted out of the tile loop and held throughout)
    const int dout = a.dout[l];
    const bool even = (dout & 1) == 0;
    const bool in0 = tile0 + r < n, in1 = tile0 + r + 8 < n;
    float* const out0 = out + (in0 ? (tile0 + r) * dout : 0);
    float* const out1 = out + (in1 ? (tile0 + r + 8) * dout : 0);
#pragma unroll
    for (int j0 = 0; j0 < NW / 8; j0 += 8) {
      asm volatile("" ::: "memory");
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c >= dout) continue;
        const float2 b = ld_float2(bias + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? in1 : in0)) continue;
          const float2 p = round_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          float2 v = make_float2(p.x + b.x, p.y + b.y);
          if (a.act_last) {
            v = round_bf16x2(v.x, v.y);
            if (a.act == 0) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
          }
          float* o = (h ? out1 : out0) + c;
          if (even) {
            *reinterpret_cast<float2*>(o) = v;
          } else {
            o[0] = v.x;
            if (c + 1 < dout) o[1] = v.y;
          }
        }
      }
    }
    if (a.act_last && a.act == 1) {
      for (int j = 0; j < NW / 8; ++j) {
        const int c = 8 * j + 2 * t;
        for (int h = 0; h < 2; ++h) {
          float* o = (h ? out1 : out0) + c;
          for (int e = 0; e < 2; ++e)
            if ((h ? in1 : in0) && c + e < dout) o[e] = round_bf16(softplus(o[e]));
        }
      }
    }
  }
}

// A consumer warpgroup of the bf16 form: 64 rows of every tile.
__device__ __forceinline__ void consume_bf16(float* __restrict__ out, int n,
                                             const MLPArgsB& a,
                                             const SmemB& sm, int wg,
                                             int ctid) {
  ConsumerB cs;
  cs.wg = wg;
  cs.warp = ctid / 32;
  cs.lane = ctid % 32;
  cs.g = cs.lane / 4;
  cs.t = cs.lane % 4;
  cs.stage = 0;
  cs.phase = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++it) {
    const long long tile0 = static_cast<long long>(tile) * kTileRows;
    mbar_wait(sm.x_ready, it & 1);
    for (int l = 0; l < a.n_layers; ++l) {
      if (a.np[l] > 64) {
        layer_bf16<256>(out, n, a, sm, cs, l, tile0);
      } else {
        layer_bf16<64>(out, n, a, sm, cs, l, tile0);
      }
    }
  }
}

__device__ __forceinline__ void init_barriers_bf16(const SmemB& sm,
                                                   const MLPArgsB& a) {
  for (int s = 0; s < a.stages; ++s) {
    mbar_init(sm.full + 8 * s, 1);
    mbar_init(sm.empty + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
  }
  mbar_init(sm.x_ready, kStagersB);
  mbar_init(sm.x_free, 4 * kConsumers);
  mbar_init(sm.raw_full, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    skip_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         float* __restrict__ out, int n, MLPArgsB args) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const SmemB sm = smem_layout_bf16(smem_b, args);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) init_barriers_bf16(sm, args);
  __syncthreads();
  // registers: 168 a thread at launch (65,536 / 384); the producer
  // hands most of its share to the consumers' m64n256 accumulators
  // (2 x 128 x 224 + 128 x 56 = 64,512)
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce_bf16(x, n, args, sm, tid - 128 * kConsumers);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consume_bf16(out, n, args, sm, wg, tid % 128);
  }
}

// The weight stream alone, for measuring it: the bf16 kernel's producer
// and ring on the same grid, consumers that hand each stage back as it
// lands, no products and no x. Its time over the chunks' bytes is the
// rate at which L2 fills the ring.
__global__ void __launch_bounds__(kThreads, 1)
    skip_mlp_bf16_feed_kernel(MLPArgsB args) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const SmemB sm = smem_layout_bf16(smem_b, args);
  const int tid = threadIdx.x;
  if (tid == 0) init_barriers_bf16(sm, args);
  __syncthreads();
  if (tid / 128 == kConsumers) {
    if (tid == 128 * kConsumers)
      produce_bf16(nullptr, 0, args, sm, 0);
    return;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x) {
    for (int l = 0; l < args.n_layers; ++l) {
      for (int c = 0; c < args.nc[l]; ++c) {
        mbar_wait(sm.full + 8 * stage, phase);
        if (tid % 32 == 0) mbar_arrive(sm.empty + 8 * stage);
        if (++stage == args.stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int skip_mlp_max_layers() { return kMaxLayers; }
int skip_mlp_max_width() { return kMaxWidth; }
int skip_mlp_chunk_k() { return kChunkK; }
int skip_mlp_bf16_chunk_k() { return kChunkKB; }
int skip_mlp_bf16_block_k() { return kBlockKB; }

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

}  // extern "C"

namespace {

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The bf16 form's arguments from the layer widths (the layout
// pack_layers gives the weights), its stages and grid. Returns 0 or a
// CUDA error.
int bf16_args(int n, int din, int n_layers, const void* const* w,
              const void* const* b, const int* dout, unsigned skips, int act,
              int act_last, MLPArgsB& a, int& smem_bytes, int& blocks) {
  if (n_layers < 1 || n_layers > kMaxLayers || din < 1 || din > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_layers = n_layers;
  a.din = din;
  a.x_blocks = round_up(din, kBlockKB) / kBlockKB;
  a.act = act;
  a.act_last = act_last;
  a.x_last = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (dout[l] < 1 || dout[l] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    const int np = round_up(dout[l], kChunkK);
    a.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
    a.dout[l] = dout[l];
    a.np[l] = np;
    a.nx[l] = (l == 0 || ((skips >> (l - 1)) & 1u)) ? 2 * a.x_blocks : 0;
    a.nc[l] = a.nx[l] + (l == 0 ? 0 : round_up(a.np[l - 1], kBlockKB) / kChunkKB);
    if (a.nx[l]) a.x_last = l;
  }
  a.raw_bytes = round_up(kTileRows * din * 2, 16) + 16;
  const int fixed = 1024 + kHBytesB + a.x_blocks * kBlockBytesB + a.raw_bytes;
  a.stages = 0;
  while (a.stages < kMaxStagesB &&
         fixed + (a.stages + 1) * kStageBytesB +
                 (2 * (a.stages + 1) + 3) * 8 <= kSmemLimitB)
    ++a.stages;
  if (a.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  smem_bytes = fixed + a.stages * kStageBytesB + (2 * a.stages + 3) * 8;
  a.n_tiles = (n + kTileRows - 1) / kTileRows;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blocks = a.n_tiles < sms ? a.n_tiles : sms;
  return 0;
}

}  // namespace

extern "C" {

// The bf16 form: x (n, din) bf16, w[l] packed bf16 by pack_layers, b[l]
// its padded bias as float32 holding bf16 values; out (n, dout) float32.
int skip_mlp_bf16_forward(const void* x, float* out, int n, int din,
                          int n_layers, const void* const* w,
                          const void* const* b, const int* dout,
                          unsigned skips, int act, int act_last,
                          void* stream) {
  MLPArgsB args;
  int smem = 0, blocks = 0;
  int rc = bf16_args(n, din, n_layers, w, b, dout, skips, act, act_last, args,
                     smem, blocks);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      skip_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimitB);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  skip_mlp_bf16_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), out, n, args);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form's weight stream alone (skip_mlp_bf16_feed_kernel) for
// the same arguments; *bytes gets the bytes it brings from L2 into
// shared memory (every block's chunks).
int skip_mlp_bf16_feed(int n, int din, int n_layers, const void* const* w,
                       const void* const* b, const int* dout, unsigned skips,
                       long long* bytes, void* stream) {
  MLPArgsB args;
  int smem = 0, blocks = 0;
  int rc = bf16_args(n, din, n_layers, w, b, dout, skips, 0, 0, args, smem,
                     blocks);
  if (rc != 0) return rc;
  long long per_tile = 0;
  for (int l = 0; l < n_layers; ++l)
    per_tile += static_cast<long long>(args.nc[l]) * args.np[l] * kChunkKB * 2;
  *bytes = per_tile * args.n_tiles;
  cudaError_t err = cudaFuncSetAttribute(
      skip_mlp_bf16_feed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimitB);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  skip_mlp_bf16_feed_kernel<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
