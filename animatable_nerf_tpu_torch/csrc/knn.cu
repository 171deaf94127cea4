// Nearest-vertex kernels for NVIDIA Hopper (sm_90a), FP32: the KNN
// inverse-distance blend (K2), the nearest-vertex distance (K3), the k-th
// nearest distance (K4), and K2's blend over culled vertex blocks (K5) and
// over per-cell candidate lists (K6).
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
// K4 replaces :240 `kth_distance` (body `_kth_dist_kernel` :221): sqrt of
// the k-th smallest squared distance, duplicates counted separately.
// K5 replaces :460 `knn_blend_blocked` (body `_knn_blocked_kernel` :354):
// K2 over the Morton-sorted vertices, sweeping only the blocks whose box
// lies within the query tile's certified k-NN radius.
// K6 replaces :760 `knn_blend_celled` (body `_knn_celled_kernel` :748):
// K2 over the candidate list of the cell each query falls in.
//
// What bounds them on this card: arithmetic. Each (query, vertex) pair
// costs 3 subtractions, 3 multiplications, 2 additions and a compare; the
// bytes are only the queries, the outputs and the vertices (83 KB at
// SMPL's 6890, which every block re-reads from L2). K3's and K4's grid
// builds are 96^3 x 6890 = 6.1e9 pairs per frame. K5 and K6 cut the pairs
// (blocks outside the radius, vertices outside the cell's list), not their
// cost.
//
// Design (simple first; tensor-core distances are later work):
//   * one thread per query; a block walks its vertices in tiles of up to
//     kTile staged in shared memory as float4, so each pair costs one
//     broadcast 16-byte shared load;
//   * K3 keeps a running min of d2 in a register;
//   * K2, K4, K5 and K6 keep the k best (d2, index) pairs sorted in
//     registers (`topk_insert`). A vertex enters only if its d2 is
//     strictly below the k-th best, and it is placed after every kept
//     entry with an equal d2; vertices arrive in ascending index order, so
//     this is the Pallas body's rule of k rounds of (min, lowest index,
//     knock out). Then each thread gathers its k rows of `values` from
//     global memory (L2) and blends them in the Pallas body's order
//     (`blend_write`). K4 keeps the d2s alone and writes the k-th;
//   * K5: one block of 256 threads per tile of 256 Morton-sorted queries.
//     All threads test each vertex block's box against the tile's box and
//     radius (a uniform branch) and stage and sweep only the kept blocks,
//     in ascending order, indexing by sorted position;
//   * K6: one block of 64 threads per run of up to 64 queries of one cell
//     (the wrapper sorts the queries by slot); the block stages its slot's
//     (3, cap) list in shared memory and sweeps all of it, pads included,
//     indexing by list position (lists keep ascending global order);
//   * no padding of N or M in K2-K4: ragged tiles are bounded by counts.
//
// Rounding: every operation is an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so nothing is
// contracted into an FMA and the results round exactly as the plain
// PyTorch versions' separate ops do: the same neighbours, the same bits.
// A query with a NaN coordinate gives NaN outputs, as in the Pallas body;
// the vertices must be finite.
//
// Interface: plain C functions (bound with ctypes), row-major float32
// tensors, launched on the caller's stream; each returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kCellThreads = 64;  // K6's queries per block: one cell's run
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

// Stage `count` (<= kTile) vertices of a row-major (m, 3) array, from row
// `base`, into `tile`. Every thread of the block must call it between two
// barriers.
__device__ __forceinline__ void stage_rows(const float* __restrict__ ref,
                                           int base, int count,
                                           float4* tile) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float* r = ref + 3 * static_cast<size_t>(base + j);
    tile[j] = make_float4(r[0], r[1], r[2], 0.f);
  }
}

// The same for a (3, cap) list: its x, y and z rows, from entry `base`.
__device__ __forceinline__ void stage_list(const float* __restrict__ xyz,
                                           int cap, int base, int count,
                                           float4* tile) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int e = base + j;
    tile[j] = make_float4(xyz[e], xyz[cap + e], xyz[2 * cap + e], 0.f);
  }
}

// Vertices [base, min(base + kTile, m)) into `tile`; returns the count.
__device__ __forceinline__ int stage_tile(const float* __restrict__ ref,
                                          int m, int base, float4* tile) {
  const int count = min(kTile, m - base);
  stage_rows(ref, base, count, tile);
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

template <int K>
__device__ __forceinline__ void topk_init(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
}

// Offer vertex `idx` at squared distance d2 to the k best, kept ascending
// by (d2, arrival): shift the entries with a larger d2 up by one, then
// place the new vertex after every entry with a d2 <= its own.
template <int K>
__device__ __forceinline__ void topk_insert(float (&bd)[K], int (&bi)[K],
                                            float d2, int idx) {
  if (d2 < bd[K - 1]) {
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (bd[s - 1] > d2) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else if (bd[s] > d2) {
        bd[s] = d2;
        bi[s] = idx;
      }
    }
    if (bd[0] > d2) {
      bd[0] = d2;
      bi[0] = idx;
    }
  }
}

// The IDW blend of the k best, nearest first: vals (c,) and *wd.
template <int K>
__device__ __forceinline__ void blend_write(
    const float (&bd)[K], const int (&bi)[K],
    const float* __restrict__ values, int c, float eps, bool nan_query,
    float* __restrict__ vals, float* __restrict__ wd) {
  if (nan_query) {
    for (int ch = 0; ch < c; ++ch) vals[ch] = NAN;
    *wd = NAN;
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
  *wd = __fdiv_rn(acc_wd, acc_disp);
}

__device__ __forceinline__ bool is_nan3(float x, float y, float z) {
  return isnan(x) || isnan(y) || isnan(z);
}

// max(a, b) that is NaN when either is, as torch.maximum and jnp.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
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
  out[q] = is_nan3(qx, qy, qz) ? NAN : __fsqrt_rn(best);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    kth_dist_kernel(const float* __restrict__ src,
                    const float* __restrict__ ref, int n, int m,
                    float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  float qx, qy, qz;
  const bool live = load_query(src, q, n, &qx, &qy, &qz);
  float bd[K];
  int bi[K];  // unread: the compiler drops it
  topk_init(bd, bi);
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    const int count = stage_tile(ref, m, base, tile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      topk_insert(bd, bi, sq_dist(qx, qy, qz, tile[j]), base + j);
    }
  }
  if (!live) return;
  out[q] = is_nan3(qx, qy, qz) ? NAN : __fsqrt_rn(bd[K - 1]);
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
  float bd[K];
  int bi[K];
  topk_init(bd, bi);
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    const int count = stage_tile(ref, m, base, tile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      topk_insert(bd, bi, sq_dist(qx, qy, qz, tile[j]), base + j);
    }
  }
  if (!live) return;
  blend_write(bd, bi, values, c, eps, is_nan3(qx, qy, qz),
              out_vals + static_cast<size_t>(q) * c, out_wd + q);
}

// One block per tile of kThreads sorted queries (src holds n_tiles *
// kThreads rows). meta (n_tiles, 8): the tile's box lo3, hi3 and radius;
// bboxes (n_blocks, 8): each vertex block's box lo3, hi3 (finite).
template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_blocked_kernel(const float* __restrict__ src,
                       const float* __restrict__ meta,
                       const float* __restrict__ bboxes,
                       const float* __restrict__ verts,
                       const float* __restrict__ values, int n_blocks,
                       int block, int c, float eps,
                       float* __restrict__ out_vals,
                       float* __restrict__ out_wd) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float* s = src + 3 * static_cast<size_t>(q);
  const float qx = s[0], qy = s[1], qz = s[2];
  const float* mt = meta + 8 * static_cast<size_t>(blockIdx.x);
  const float r2 = __fmul_rn(mt[6], mt[6]);
  float bd[K];
  int bi[K];
  topk_init(bd, bi);
  for (int b = 0; b < n_blocks; ++b) {
    // the squared distance between the two boxes, as the plain version
    // and the Pallas body form it; the same for every thread
    const float* bb = bboxes + 8 * static_cast<size_t>(b);
    float d2b = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float g = nan_max(
          nan_max(__fsub_rn(bb[a], mt[3 + a]), __fsub_rn(mt[a], bb[3 + a])), 0.f);
      d2b = __fadd_rn(d2b, __fmul_rn(g, g));
    }
    if (!(d2b <= r2)) continue;
    __syncthreads();
    stage_rows(verts, b * block, block, tile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < block; ++j) {
      topk_insert(bd, bi, sq_dist(qx, qy, qz, tile[j]), b * block + j);
    }
  }
  blend_write(bd, bi, values, c, eps, is_nan3(qx, qy, qz),
              out_vals + static_cast<size_t>(q) * c, out_wd + q);
}

// One block per run of queries of one slot. tiles (n_tiles, 3): the slot,
// the run's first row in src and its row count (<= kCellThreads; a tile
// with no rows returns at once). cverts (S+1, 3, cap), cvals (S+1, cap, c).
template <int K>
__global__ void __launch_bounds__(kCellThreads)
    knn_celled_kernel(const float* __restrict__ src,
                      const int* __restrict__ tiles,
                      const float* __restrict__ cverts,
                      const float* __restrict__ cvals, int cap, int c,
                      float eps, float* __restrict__ out_vals,
                      float* __restrict__ out_wd) {
  __shared__ float4 tile[kTile];
  const int* t = tiles + 3 * static_cast<size_t>(blockIdx.x);
  const int slot = t[0], begin = t[1], count = t[2];
  if (count <= 0) return;  // the same for every thread of the block
  const int q = begin + threadIdx.x;
  float qx, qy, qz;
  const bool live = load_query(src, q, begin + count, &qx, &qy, &qz);
  const float* xyz = cverts + static_cast<size_t>(slot) * 3 * cap;
  float bd[K];
  int bi[K];
  topk_init(bd, bi);
  for (int base = 0; base < cap; base += kTile) {
    const int n_here = min(kTile, cap - base);
    __syncthreads();
    stage_list(xyz, cap, base, n_here, tile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n_here; ++j) {
      topk_insert(bd, bi, sq_dist(qx, qy, qz, tile[j]), base + j);
    }
  }
  if (!live) return;
  blend_write(bd, bi, cvals + static_cast<size_t>(slot) * cap * c, c, eps,
              is_nan3(qx, qy, qz), out_vals + static_cast<size_t>(q) * c,
              out_wd + q);
}

// launch(std::integral_constant<int, K>) for the runtime k in [1, kMaxK]
template <typename Launch>
int dispatch_k(int k, Launch&& launch) {
  switch (k) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 5: return launch(std::integral_constant<int, 5>{});
    case 6: return launch(std::integral_constant<int, 6>{});
    case 7: return launch(std::integral_constant<int, 7>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

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
  return last_error();
}

// src (n, 3), ref (m, 3) -> out (n,): distance to the k-th nearest vertex.
int knn_kth_dist(const float* src, const float* ref, int n, int m, int k,
                 float* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_k(k, [&](auto kc) {
    kth_dist_kernel<decltype(kc)::value><<<blocks, kThreads, 0, s>>>(
        src, ref, n, m, out);
    return last_error();
  });
}

// src (n, 3), ref (m, 3), values (m, c) -> out_vals (n, c), out_wd (n,):
// the IDW blend of the k nearest vertices' values and distances.
int knn_blend(const float* src, const float* ref, const float* values, int n,
              int m, int c, int k, float eps, float* out_vals, float* out_wd,
              void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_k(k, [&](auto kc) {
    knn_blend_kernel<decltype(kc)::value><<<blocks, kThreads, 0, s>>>(
        src, ref, values, n, m, c, eps, out_vals, out_wd);
    return last_error();
  });
}

// src (n_tiles * tile, 3) sorted queries, meta (n_tiles, 8), bboxes
// (n_blocks, 8), verts (n_blocks * block, 3), values (n_blocks * block, c)
// -> out_vals (n_tiles * tile, c), out_wd (n_tiles * tile,), with tiles of
// kThreads queries; block is at most a shared-memory tile.
int knn_blocked(const float* src, const float* meta, const float* bboxes,
                const float* verts, const float* values, int n_tiles,
                int n_blocks, int block, int c, int k, float eps,
                float* out_vals, float* out_wd, void* stream) {
  if (block < 1 || block > kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_k(k, [&](auto kc) {
    knn_blocked_kernel<decltype(kc)::value><<<n_tiles, kThreads, 0, s>>>(
        src, meta, bboxes, verts, values, n_blocks, block, c, eps, out_vals,
        out_wd);
    return last_error();
  });
}

// src (n, 3) queries sorted by slot, tiles (n_tiles, 3) int32 [slot,
// first row, rows], cverts (S+1, 3, cap), cvals (S+1, cap, c) -> out_vals
// (n, c), out_wd (n,) in src's order; a tile holds up to kCellThreads rows.
int knn_celled(const float* src, const int* tiles, const float* cverts,
               const float* cvals, int n_tiles, int cap, int c, int k,
               float eps, float* out_vals, float* out_wd, void* stream) {
  if (cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_k(k, [&](auto kc) {
    knn_celled_kernel<decltype(kc)::value><<<n_tiles, kCellThreads, 0, s>>>(
        src, tiles, cverts, cvals, cap, c, eps, out_vals, out_wd);
    return last_error();
  });
}

}  // extern "C"
