// Fused skip-MLP forward for NVIDIA Hopper (sm_90a), FP32.
//
// Replaces the TPU kernel animatable_nerf_tpu/ops/mlp_pallas.py
// `fused_skip_mlp` (body `_mlp_kernel`): a whole stack of dense layers
// runs per tile of points, with ReLU/softplus/none after every layer but
// the last (or after the last too with act_last), and the ORIGINAL input
// re-concatenated in front of the activations after each layer listed in
// `skips` (the next layer then reads [x, h]).
//
// What bounds it here: arithmetic. The AniNeRF trunks are 8x256 layers
// (about 0.55 M multiply-adds per point), so a tile of 64 points does
// ~70 MFLOP against ~2.2 MB of weights that every tile shares from L2.
// Device-memory traffic is only x in and the output out, so the kernel
// is bound by FP32 FMA throughput, not by bytes.
//
// What the design does about it (FP32 CUDA-core FMAs; tensor cores, TMA
// and bf16 belong to later work):
//   * one block of 256 threads owns 64 rows; the tile's input x and its
//     activations h stay in shared memory across all layers, which is
//     what the TPU kernel keeps in VMEM instead of HBM;
//   * activations are stored k-major (feature-major, rows contiguous,
//     stride 68 floats), so each thread reads its 8 rows of one feature
//     as two float4 loads that the whole warp shares (broadcast);
//   * weights stream from L2 into shared memory in chunks of 32 input
//     rows through a two-stage cp.async pipeline: the next chunk is in
//     flight while the current one is multiplied, so the FMA loop reads
//     only shared memory and never waits on L2;
//   * each thread accumulates an 8-row x 8-column register tile; its
//     columns are two runs of 4 (4*lane and 128 + 4*lane), read as two
//     float4 loads that tile a warp's 512 contiguous bytes;
//   * the skip concat reads the x and h segments in place (the weight
//     rows of the x segment come first) and copies nothing; layer outputs
//     overwrite h between two barriers, so one h buffer suffices;
//   * shared memory is (din + 256) * 68 * 4 + 2 * 32 * 256 * 4 bytes,
//     183 KB for din = 191 (din <= 357 fits the 227 KB a block may
//     have): dynamic shared memory, one block per SM;
//   * no padding of din or N: ragged tiles read zeros and skip stores.
//
// Interface: a plain C function (bound with ctypes), weights as (in, out)
// row-major float32 like the JAX wrapper's `layers`, launched on the
// caller's stream; it returns cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTileRows = 64;      // points per block
constexpr int kRowsPerThread = 8;  // register tile rows
constexpr int kLanes = 32;         // threads across output columns
constexpr int kThreads = (kTileRows / kRowsPerThread) * kLanes;  // 256
constexpr int kMaxWidth = 256;     // widest layer output
constexpr int kColsPerThread = 8;  // two runs of 4 columns
constexpr int kStride = kTileRows + 4;  // floats per feature row in smem
constexpr int kChunk = 32;         // weight rows per pipeline stage
constexpr int kStages = 2;

struct MLPArgs {
  const float* w[kMaxLayers];  // (in, out) row-major
  const float* b[kMaxLayers];  // (out,)
  int dout[kMaxLayers];
  int n_layers;
  int din;
  unsigned skips;  // bit l: re-concat x after layer l's activation
  int act;         // 0 relu, 1 softplus, 2 none
  int act_last;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return fmaxf(v, 0.f);
  if (act == 1) return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_newest_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy weight rows [row0, row0 + kn) of w (rows of `dout` floats) into a
// stage buffer with row stride kMaxWidth.
__device__ __forceinline__ void load_chunk(float* dst, const float* w,
                                           int row0, int kn, int dout,
                                           bool vec4, int tid) {
  const float* src = w + static_cast<size_t>(row0) * dout;
  if (vec4) {
    const int q = dout / 4;
    for (int e = tid; e < kn * q; e += kThreads) {
      const int r = e / q;
      const int c = (e - r * q) * 4;
      cp_async16(dst + r * kMaxWidth + c, src + r * dout + c);
    }
  } else {
    for (int e = tid; e < kn * dout; e += kThreads) {
      const int r = e / dout;
      const int c = e - r * dout;
      cp_async4(dst + r * kMaxWidth + c, src + r * dout + c);
    }
  }
}

// acc[r][j] += sum_k a[k][row0 + r] * wk[k][col(j)], k < kn
__device__ __forceinline__ void fma_chunk(
    float (&acc)[kRowsPerThread][kColsPerThread], const float* a,
    const float* wk, int kn, int row0, int lane) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kStride + row0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + k * kStride + row0 + 4);
    const float4 b0 =
        *reinterpret_cast<const float4*>(wk + k * kMaxWidth + 4 * lane);
    const float4 b1 = *reinterpret_cast<const float4*>(
        wk + k * kMaxWidth + 128 + 4 * lane);
    const float av[kRowsPerThread] = {a0.x, a0.y, a0.z, a0.w,
                                      a1.x, a1.y, a1.z, a1.w};
    const float bv[kColsPerThread] = {b0.x, b0.y, b0.z, b0.w,
                                      b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

__device__ __forceinline__ int col_of(int lane, int j) {
  return (j < 4 ? 0 : 128 - 4) + 4 * lane + j;
}

__global__ void __launch_bounds__(kThreads, 1)
    skip_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, MLPArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int din = args.din;
  float* xs = smem;                       // din x kStride, k-major
  float* hs = xs + din * kStride;         // kMaxWidth x kStride, k-major
  float* ws = hs + kMaxWidth * kStride;   // kStages x kChunk x kMaxWidth
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int row0 = (tid / kLanes) * kRowsPerThread;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileRows;

  for (int i = tid; i < kTileRows * din; i += kThreads) {
    const int r = i / din;
    const int k = i - r * din;
    const long long row = tile0 + r;
    xs[k * kStride + r] = row < n ? x[row * din + k] : 0.f;
  }

  int h_width = 0;     // width of the h segment the current layer reads
  bool with_x = true;  // the current layer reads the x segment first
  for (int l = 0; l < args.n_layers; ++l) {
    const int dout = args.dout[l];
    const float* __restrict__ w = args.w[l];
    const bool vec4 =
        (dout % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    // chunks [0, nx) walk the x segment, [nx, nx + nh) the h segment
    const int nx = with_x ? (din + kChunk - 1) / kChunk : 0;
    const int nh = (h_width + kChunk - 1) / kChunk;
    const int h_row0 = with_x ? din : 0;  // first weight row of h
    auto chunk = [&](int c, const float*& a, int& wrow, int& kn) {
      if (c < nx) {
        const int k0 = c * kChunk;
        a = xs + k0 * kStride;
        wrow = k0;
        kn = min(kChunk, din - k0);
      } else {
        const int k0 = (c - nx) * kChunk;
        a = hs + k0 * kStride;
        wrow = h_row0 + k0;
        kn = min(kChunk, h_width - k0);
      }
    };

    const float* a;
    int wrow, kn;
    chunk(0, a, wrow, kn);
    load_chunk(ws, w, wrow, kn, dout, vec4, tid);
    cp_async_commit();

    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = col_of(lane, j);
      const float bj = c < dout ? __ldg(args.b[l] + c) : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r][j] = bj;
    }

    for (int c = 0; c < nx + nh; ++c) {
      if (c + 1 < nx + nh) {
        const float* a_next;
        int wrow_next, kn_next;
        chunk(c + 1, a_next, wrow_next, kn_next);
        load_chunk(ws + ((c + 1) % kStages) * kChunk * kMaxWidth, w,
                   wrow_next, kn_next, dout, vec4, tid);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait_newest_pending();  // chunk c has landed
      __syncthreads();  // ... for every thread, and xs/hs are written
      chunk(c, a, wrow, kn);
      fma_chunk(acc, a, ws + (c % kStages) * kChunk * kMaxWidth, kn, row0,
                lane);
      __syncthreads();  // stage c % kStages is free to be refilled
    }

    const bool last = l == args.n_layers - 1;
    if (!last || args.act_last) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[r][j] = activate(acc[r][j], args.act);
    }
    if (last) {
      const bool out4 =
          (dout % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long row = tile0 + row0 + r;
        if (row >= n) break;
        float* dst = out + row * dout;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c0 = col_of(lane, 4 * g);
          if (out4 && c0 < dout) {
            *reinterpret_cast<float4*>(dst + c0) =
                make_float4(acc[r][4 * g], acc[r][4 * g + 1],
                            acc[r][4 * g + 2], acc[r][4 * g + 3]);
          } else if (!out4) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c0 + i < dout) dst[c0 + i] = acc[r][4 * g + i];
          }
        }
      }
    } else {
      // every thread finished reading hs at the chunk loop's last barrier
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = col_of(lane, j);
        if (c < dout) {
          float* dst = hs + c * kStride + row0;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
      }
      h_width = dout;
      with_x = (args.skips >> l) & 1u;
      // the next layer's first barrier orders these writes before reads
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for an input width `din`.
int skip_mlp_smem_bytes(int din) {
  return ((din + kMaxWidth) * kStride + kStages * kChunk * kMaxWidth) *
         static_cast<int>(sizeof(float));
}

int skip_mlp_max_layers() { return kMaxLayers; }
int skip_mlp_max_width() { return kMaxWidth; }

// out (n, dout_last) = MLP(x (n, din)); w[l] (in_l, dout[l]), b[l] (dout[l]).
// Returns 0 or the CUDA error of the launch (cudaGetLastError).
int skip_mlp_forward(const float* x, float* out, int n, int din, int n_layers,
                     const void* const* w, const void* const* b,
                     const int* dout, unsigned skips, int act, int act_last,
                     void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || din < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MLPArgs args;
  for (int l = 0; l < n_layers; ++l) {
    if (dout[l] < 1 || dout[l] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    args.w[l] = static_cast<const float*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.dout[l] = dout[l];
  }
  args.n_layers = n_layers;
  args.din = din;
  args.skips = skips;
  args.act = act;
  args.act_last = act_last;
  const int smem = skip_mlp_smem_bytes(din);
  cudaError_t err = cudaFuncSetAttribute(
      skip_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kTileRows - 1) / kTileRows;
  skip_mlp_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(x, out, n, args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
