// Nearest-vertex kernels for NVIDIA Hopper (sm_90a), FP32: the KNN
// inverse-distance blend (K2) and the nearest-vertex distance (K3).
//
// K2 replaces the TPU kernel animatable_nerf_tpu/ops/knn_pallas.py:55
// `knn_blend_pallas` (body `_knn_select_body` :583): for every query point,
// the exact f32 squared distance to each of the M vertices by direct
// differences, the k nearest (the lowest vertex index wins a tie), and the
// inverse-distance blend, accumulated nearest first:
//   d_j = sqrt(d2_j),  w_j = 1 / (d_j + eps),
//   vals = (sum_j w_j * values[idx_j]) / sum_j w_j,
//   wdist = (sum_j w_j * d_j) / sum_j w_j.
// K3 replaces :129 `min_dist_pallas` (body `_min_dist_kernel` :113):
// sqrt of the smallest squared distance.
//
// What bounds them on this card: arithmetic. Each (query, vertex) pair
// costs 3 subtractions, 3 multiplications, 2 additions and a compare; the
// bytes are only the queries, the outputs and the vertices (83 KB at
// SMPL's 6890, which every block re-reads from L2). K3's grid build is
// 96^3 x 6890 = 6.1e9 pairs per frame.
//
// Design (simple first; culling and tensor-core distances are later work):
//   * one thread per query, 256 threads per block; the block walks the
//     vertex list in tiles of kTile vertices staged in shared memory as
//     float4, so each pair costs one broadcast 16-byte shared load;
//   * K3 keeps a running min of d2 in a register;
//   * K2 keeps the k best (d2, index) pairs sorted in registers. A vertex
//     enters only if its d2 is strictly below the k-th best, and it is
//     placed after every kept entry with an equal d2; vertices arrive in
//     ascending index order, so this is the Pallas body's rule of k
//     rounds of (min, lowest index, knock out). Then each thread gathers
//     its k rows of `values` from global memory (L2) and blends them in
//     the Pallas body's order;
//   * no padding of N or M: ragged tiles are bounded by their count.
//
// Rounding: every operation is an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so nothing is
// contracted into an FMA and the results round exactly as the plain
// PyTorch version's separate ops do: the same neighbours, the same bits.
// A query with a NaN coordinate gives NaN outputs, as in the Pallas body;
// the vertices must be finite.
//
// Interface: plain C functions (bound with ctypes), row-major float32
// tensors, launched on the caller's stream; each returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kTile = 1024;    // vertices per shared-memory tile (16 KB)
constexpr int kMaxK = 8;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 v) {
  const float dx = __fsub_rn(qx, v.x);
  const float dy = __fsub_rn(qy, v.y);
  const float dz = __fsub_rn(qz, v.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage vertices [base, base + count) into `tile`; returns count. Every
// thread of the block must call it between two barriers.
__device__ __forceinline__ int stage_tile(const float* __restrict__ ref,
                                          int m, int base, float4* tile) {
  const int count = min(kTile, m - base);
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float* r = ref + 3 * static_cast<size_t>(base + j);
    tile[j] = make_float4(r[0], r[1], r[2], 0.f);
  }
  return count;
}

__device__ __forceinline__ bool load_query(const float* __restrict__ src,
                                           int q, int n, float* qx,
                                           float* qy, float* qz) {
  if (q >= n) {
    *qx = *qy = *qz = 0.f;
    return false;
  }
  const float* s = src + 3 * static_cast<size_t>(q);
  *qx = s[0];
  *qy = s[1];
  *qz = s[2];
  return true;
}

__global__ void __launch_bounds__(kThreads)
    min_dist_kernel(const float* __restrict__ src,
                    const float* __restrict__ ref, int n, int m,
                    float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  const bool live = load_query(src, q, n, &qx, &qy, &qz);
  float best = INFINITY;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    const int count = stage_tile(ref, m, base, tile);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      best = fminf(best, sq_dist(qx, qy, qz, tile[j]));
    }
  }
  if (!live) return;
  const bool nan_query = isnan(qx) || isnan(qy) || isnan(qz);
  out[q] = nan_query ? NAN : __fsqrt_rn(best);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_blend_kernel(const float* __restrict__ src,
                     const float* __restrict__ ref,
                     const float* __restrict__ values, int n, int m, int c,
                     float eps, float* __restrict__ out_vals,
                     float* __restrict__ out_wd) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  const bool live = load_query(src, q, n, &qx, &qy, &qz);

  // the k best so far, ascending by (d2, index)
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    const int count = stage_tile(ref, m, base, tile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const float d2 = sq_dist(qx, qy, qz, tile[j]);
      if (d2 < bd[K - 1]) {
        // shift the entries with a larger d2 up by one, then place the
        // new vertex after every entry with a d2 <= its own
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s - 1] > d2) {
            bd[s] = bd[s - 1];
            bi[s] = bi[s - 1];
          } else if (bd[s] > d2) {
            bd[s] = d2;
            bi[s] = base + j;
          }
        }
        if (bd[0] > d2) {
          bd[0] = d2;
          bi[0] = base + j;
        }
      }
    }
  }
  if (!live) return;

  float* vals = out_vals + static_cast<size_t>(q) * c;
  if (isnan(qx) || isnan(qy) || isnan(qz)) {
    for (int ch = 0; ch < c; ++ch) vals[ch] = NAN;
    out_wd[q] = NAN;
    return;
  }
  float w[K];
  float acc_disp = 0.f;
  float acc_wd = 0.f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float d = __fsqrt_rn(bd[s]);
    w[s] = __fdiv_rn(1.f, __fadd_rn(d, eps));
    acc_disp = __fadd_rn(acc_disp, w[s]);
    acc_wd = __fadd_rn(acc_wd, __fmul_rn(w[s], d));
  }
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      acc = __fadd_rn(acc, __fmul_rn(w[s], values[static_cast<size_t>(bi[s]) * c + ch]));
    }
    vals[ch] = __fdiv_rn(acc, acc_disp);
  }
  out_wd[q] = __fdiv_rn(acc_wd, acc_disp);
}

template <int K>
int launch_blend(const float* src, const float* ref, const float* values,
                 int n, int m, int c, float eps, float* out_vals,
                 float* out_wd, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  knn_blend_kernel<K><<<blocks, kThreads, 0, stream>>>(
      src, ref, values, n, m, c, eps, out_vals, out_wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int knn_max_k() { return kMaxK; }

// src (n, 3), ref (m, 3) -> out (n,): distance to the nearest vertex.
int knn_min_dist(const float* src, const float* ref, int n, int m,
                 float* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  min_dist_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, ref, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

// src (n, 3), ref (m, 3), values (m, c) -> out_vals (n, c), out_wd (n,):
// the IDW blend of the k nearest vertices' values and distances.
int knn_blend(const float* src, const float* ref, const float* values, int n,
              int m, int c, int k, float eps, float* out_vals, float* out_wd,
              void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_blend<1>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 2: return launch_blend<2>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 3: return launch_blend<3>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 4: return launch_blend<4>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 5: return launch_blend<5>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 6: return launch_blend<6>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 7: return launch_blend<7>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    case 8: return launch_blend<8>(src, ref, values, n, m, c, eps, out_vals, out_wd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
