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
// On request K2 also writes idx_j, the selection its gradient is taken
// over (ops/knn.py `KNNBlendFunction`, whose backward is plain PyTorch).
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
// What bounds them on this card: the issue rate of FP32 operations that
// are not FMAs. Each (query, vertex) pair costs 3 subtractions, 3
// multiplications, 2 additions and a compare, each rounded on its own
// (below), so they run at half of the 67 TFLOP/s that counts an FMA as
// two; the bytes are only the queries, the outputs and the vertices (110
// KB at SMPL's 6890 as float4). K3's and K4's grid builds are 96^3 x 6890
// = 6.1e9 pairs per frame. So the designs cut instructions per pair, and
// above all the pairs themselves.
//
// The exact reject. For non-negative floats rounded to nearest,
// fadd(a, b) >= a and >= b, so the kernels' d2 = (dx*dx + dy*dy) + dz*dz
// is >= each of its three squares, bit for bit. A vertex whose square on
// one axis (the same __fsub_rn and __fmul_rn as the full distance) is
// already >= the k-th best d2 cannot enter, since entry needs d2 strictly
// below it (or, in K2's and K5's lexicographic rule, equal with a lower
// index: there the test is > instead of >=). The same holds for a whole block
// of vertices, with the query's gap to the block's box on each axis in
// place of the difference: rounding is monotone, so no vertex of the box
// is nearer on that axis. Rounded addition is monotone in each term too,
// so the gaps' squares summed as d2 is summed, (gx*gx + gy*gy) + gz*gz,
// are also <= d2 for every vertex of the box (K3 and K4 use this sum; a
// box of queries in place of the query gives a bound for all of them).
// The rejects need no error margin and change no neighbour and no bit.
//
// Why not the tensor cores: their form |q|^2 - 2 q.v + |v|^2 cancels and
// flips neighbours (the JAX package rejected it, knn_pallas.py:590-597);
// the contraction is 3 deep and the work per pair is a compare and a
// select, not a product; and with the rejects most pairs never reach a
// distance at all. A tensor-core pre-filter would need a proven error
// bound and would still leave the exact distance to the CUDA cores.
//
// Design:
//   * K3, K4 (`grid_walk`): only values come out, so the order in which
//     vertices arrive is free. The vertices in Morton order, in runs of
//     kRun with a box each, built on the card once per vertex tensor
//     version and shared by K3 and K4 (`grid_keys_kernel`, an argsort,
//     `grid_runs_kernel`; ops/knn.py `grid_layout` is its plain
//     version), read from global memory (L1).
//     One warp per 32 consecutive queries (a line of grid nodes along z):
//     the warp forms its live queries' box and ranks the runs by the
//     squared gap from that box to each run's box, a lower bound for
//     every lane; it then takes the runs nearest first, each chosen by a
//     warp min over its lanes' smallest untaken keys (a lane owns runs
//     lane, lane + 32, ...: its keys in shared memory, its smallest in a
//     register). It skips a run that every lane's gap test rejects
//     against its own k-th best, gives each vertex of a run it sweeps the
//     one-axis reject on the run's longest axis before the full distance,
//     and stops once the next key is >= the largest k-th best over its
//     lanes: every later run is then rejected by every lane. A query
//     visits the few runs near it, not all M vertices. K3 is K4 at k = 1;
//     the k best values are kept sorted in registers (`topk_insert`);
//   * K6: one thread per query, with the k best (d2, index) pairs sorted
//     in registers (`topk_insert`): a vertex enters only if its d2 is
//     strictly below the k-th best, placed after every kept entry with an
//     equal d2; vertices arrive in ascending index order, so this is the
//     Pallas body's rule of k rounds of (min, lowest index, knock out).
//     One block of 64 threads per run of up to 64 queries of one cell
//     (the wrapper sorts the queries by slot); the block stages its
//     slot's (3, cap) list in tiles of up to kTile in shared memory as
//     float4 and sweeps all of it, pads included, indexing by list
//     position (lists keep ascending global order);
//   * K2: the vertices sorted along their longest axis A, packed once per
//     frame as float4 (x, y, z, original index) with A in a device int
//     (ops/knn.py `sweep_layout`), all resident in shared memory (110 KB
//     at 6890: two blocks an SM). Each thread binary-searches its query's
//     coordinate on A and walks outward both ways, kWalkRows vertices
//     each way a step, loaded together; a direction stops at the first vertex
//     whose A-square exceeds the k-th best, since every vertex beyond is
//     farther on A still. Vertices then arrive out of index order, so the
//     top-k compares (d2, original index) lexicographically
//     (`topk_insert_lex`): ties still go to the lowest index. A query
//     visits the band of the sorted axis within its k-th distance, a few
//     percent of the vertices, not all of them. The block size is chosen
//     per launch so that every block is resident at once, spread evenly
//     over the SMs, at the path's own query count; the warps' chunks of
//     32 consecutive queries are dealt to the blocks in turn, so that
//     the SMs' shares of the walk's uneven work are even;
//   * K5: one block per tile of kBlockedTile Morton-sorted queries. Warp
//     0 tests each vertex block's box against the tile's box and radius,
//     as the plain version does, and writes the kept blocks' ids to
//     shared memory (ballot and prefix count), once per tile. Each warp
//     then goes its own way, with no further barrier: it ranks the kept
//     blocks by the gap from its 32 queries' centroid to each block's
//     box and takes them nearest first, so its k-th bests tighten
//     early. Per block, and per run of kRun vertices in it (boxes
//     built once per frame by ops/knn.py `blocked_layout`), the warp skips
//     the run when the gap test rejects it for all 32 lanes; otherwise
//     each vertex gets the one-axis reject on the run's longest axis
//     before its full distance. The rows are read from global memory: a
//     warp's lanes read the same row, and the 110 KB stay in L1 (a
//     cp.async ring of staged blocks with a barrier per block, the first
//     design, was slower: PERF.md). Blocks arrive out of order, so the
//     top-k is lexicographic on (d2, sorted position): ties still go to
//     the lowest Morton position, as in the plain version;
//   * the blend (`blend_write`) gathers each query's k value rows as
//     float4 when C allows, in the Pallas body's order;
//   * no padding of N in K2-K4: ragged warps and blocks are bounded by
//     counts; K3's and K4's vertices are padded to whole runs at +inf.
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

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // K2's queries per block without residency
constexpr int kGridWarps = 8;  // K3's and K4's warps per block, 32 queries each
constexpr int kCellThreads = 64;  // K6's queries per block: one cell's run
constexpr int kTile = 1024;    // vertices per shared-memory tile (16 KB)
constexpr int kMaxK = 8;
constexpr int kSweepThreads = 512;     // K2's most queries per block
constexpr int kSweepMinThreads = 128;  // and its fewest
constexpr int kWalkRows = 2;  // rows each way a step of K2's walk
constexpr int kBlockedTile = 256;  // K5's queries per tile, one block each
constexpr int kRun = 32;  // vertices per box: in a K5 block; K3's and K4's runs
constexpr int kMortonBits = 8;  // per axis of K3's and K4's vertex order
constexpr int kKeyThreads = 1024;  // the one block that computes its keys
constexpr int kMaxCards = 64;  // device ordinals whose attributes are kept
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 v) {
  const float dx = __fsub_rn(qx, v.x);
  const float dy = __fsub_rn(qy, v.y);
  const float dz = __fsub_rn(qz, v.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int A>
__device__ __forceinline__ float axis_of(float x, float y, float z) {
  return A == 0 ? x : (A == 1 ? y : z);
}

template <int A>
__device__ __forceinline__ float axis_of(float4 v) {
  return axis_of<A>(v.x, v.y, v.z);
}

// sq_dist's d2 when the square on axis A, a2, is already formed (the
// same operations, so the same bits)
template <int A>
__device__ __forceinline__ float sq_dist_from(float qx, float qy, float qz,
                                              float4 v, float a2) {
  const float dx = __fsub_rn(qx, v.x);
  const float dy = __fsub_rn(qy, v.y);
  const float dz = __fsub_rn(qz, v.z);
  const float xx = A == 0 ? a2 : __fmul_rn(dx, dx);
  const float yy = A == 1 ? a2 : __fmul_rn(dy, dy);
  const float zz = A == 2 ? a2 : __fmul_rn(dz, dz);
  return __fadd_rn(__fadd_rn(xx, yy), zz);
}

// Add a warp's per-thread counts into counts[0], counts[1], ...; every
// lane of the warp must call it.
template <typename... Counts>
__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           Counts... per_lane) {
  const unsigned value[] = {per_lane...};
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof...(Counts)); ++i) {
    const unsigned sum = __reduce_add_sync(kFullMask, value[i]);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(counts + i, static_cast<unsigned long long>(sum));
    }
  }
}

// Stage `count` (<= kTile) entries of a (3, cap) list, its x, y and z
// rows from entry `base`, into `tile`. Every thread of the block must
// call it between two barriers.
__device__ __forceinline__ void stage_list(const float* __restrict__ xyz,
                                           int cap, int base, int count,
                                           float4* tile) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int e = base + j;
    tile[j] = make_float4(xyz[e], xyz[cap + e], xyz[2 * cap + e], 0.f);
  }
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

// (d, i) after (d2, idx) in the lexicographic order
__device__ __forceinline__ bool lex_after(float d, int i, float d2, int idx) {
  return d > d2 || (d == d2 && i > idx);
}

// topk_insert for vertices that arrive in any order: the k best kept
// ascending by (d2, index), so ties go to the lowest index whatever the
// order. Start from bd = +inf, bi = INT_MAX.
template <int K>
__device__ __forceinline__ void topk_insert_lex(float (&bd)[K], int (&bi)[K],
                                                float d2, int idx) {
  if (lex_after(bd[K - 1], bi[K - 1], d2, idx)) {
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (lex_after(bd[s - 1], bi[s - 1], d2, idx)) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else if (lex_after(bd[s], bi[s], d2, idx)) {
        bd[s] = d2;
        bi[s] = idx;
      }
    }
    if (lex_after(bd[0], bi[0], d2, idx)) {
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
  const bool vec = (c & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(values) |
                     reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  if (vec) {  // the same sums, four channels a load
    for (int ch = 0; ch < c; ch += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            values + static_cast<size_t>(bi[s]) * c + ch));
        acc.x = __fadd_rn(acc.x, __fmul_rn(w[s], v.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w[s], v.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(w[s], v.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(w[s], v.w));
      }
      *reinterpret_cast<float4*>(vals + ch) = make_float4(
          __fdiv_rn(acc.x, acc_disp), __fdiv_rn(acc.y, acc_disp),
          __fdiv_rn(acc.z, acc_disp), __fdiv_rn(acc.w, acc_disp));
    }
    *wd = __fdiv_rn(acc_wd, acc_disp);
    return;
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

// One vertex p of K2's walk for one query: false, and no insert, if its
// A-square exceeds the k-th best (the way ends there), else the full
// distance and the lexicographic insert by original index.
template <int K, int A, bool kStats>
__device__ __forceinline__ bool walk_step(
    float4 p, float qa, float qx, float qy, float qz, float (&bd)[K],
    int (&bi)[K], unsigned& tested, unsigned& full) {
  const float da = __fsub_rn(qa, axis_of<A>(p));
  const float a2 = __fmul_rn(da, da);
  if (kStats) ++tested;
  if (a2 > bd[K - 1]) return false;
  if (kStats) ++full;
  topk_insert_lex(bd, bi, sq_dist_from<A>(qx, qy, qz, p, a2),
                  __float_as_int(p.w));
  return true;
}

// K2's walk for one query over the m vertices `v` sorted along axis A
// (float4 x, y, z, original index bits): outward from the query's place
// on A, kWalkRows vertices each way a step (all loaded first, so that
// their loads overlap); a way ends at its first vertex whose A-square
// exceeds the k-th best. kStats counts the vertices reached (`tested`)
// and those that went on to the full distance (`full`).
template <int K, int A, bool kStats>
__device__ __forceinline__ void sweep_sorted(
    const float4* __restrict__ v, int m, float qx, float qy, float qz,
    float (&bd)[K], int (&bi)[K], unsigned& tested, unsigned& full) {
  const float qa = axis_of<A>(qx, qy, qz);
  int lo = 0, hi = m;  // the first vertex with v_A >= q_A
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (axis_of<A>(v[mid]) < qa) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int up = lo, dn = lo - 1;
  bool go_up = up < m, go_dn = dn >= 0;
  while (go_up || go_dn) {
    float4 u[kWalkRows], d[kWalkRows];
#pragma unroll
    for (int r = 0; r < kWalkRows; ++r) {
      u[r] = v[min(up + r, m - 1)];
      d[r] = v[max(dn - r, 0)];
    }
#pragma unroll
    for (int r = 0; r < kWalkRows; ++r) {
      if (go_up) {
        go_up = walk_step<K, A, kStats>(u[r], qa, qx, qy, qz, bd, bi, tested,
                                        full) && ++up < m;
      }
    }
#pragma unroll
    for (int r = 0; r < kWalkRows; ++r) {
      if (go_dn) {
        go_dn = walk_step<K, A, kStats>(d[r], qa, qx, qy, qz, bd, bi, tested,
                                        full) && --dn >= 0;
      }
    }
  }
}

template <int K, bool kStats>
__device__ __forceinline__ void sweep_sorted_axis(
    const float4* __restrict__ v, int m, int axis, float qx, float qy,
    float qz, float (&bd)[K], int (&bi)[K], unsigned& tested,
    unsigned& full) {
  switch (axis) {
    case 0:
      sweep_sorted<K, 0, kStats>(v, m, qx, qy, qz, bd, bi, tested, full);
      break;
    case 1:
      sweep_sorted<K, 1, kStats>(v, m, qx, qy, qz, bd, bi, tested, full);
      break;
    default:
      sweep_sorted<K, 2, kStats>(v, m, qx, qy, qz, bd, bi, tested, full);
  }
}

// verts (m, 4) and *axis_of_sort from ops/knn.py `sweep_layout`. With
// `resident` the block first copies all of verts into its dynamic shared
// memory (m * 16 bytes) and walks it there; otherwise it walks global
// memory.
template <int K, bool kStats>
__global__ void __launch_bounds__(kSweepThreads, 2)
    knn_blend_kernel(const float* __restrict__ src,
                     const float4* __restrict__ verts,
                     const int* __restrict__ axis_of_sort,
                     const float* __restrict__ values, int n, int m, int c,
                     float eps, bool resident, float* __restrict__ out_vals,
                     float* __restrict__ out_wd, int* __restrict__ out_idx,
                     unsigned long long* __restrict__ counts) {
  extern __shared__ float4 sorted_verts[];
  if (resident) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      sorted_verts[j] = verts[j];
    }
    __syncthreads();
  }
  // each warp takes 32 consecutive queries, a chunk, and the chunks are
  // dealt to the blocks in turn: every block, so every SM, draws its
  // chunks from the whole launch, and their work evens out in the
  // launch's one wave, while a warp's lanes keep neighbouring queries
  const int chunk = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int q = chunk * 32 + (threadIdx.x & 31);
  float qx, qy, qz;
  const bool live = load_query(src, q, n, &qx, &qy, &qz);
  const bool nan_query = is_nan3(qx, qy, qz);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }
  unsigned tested = 0, full = 0;
  if (live && !nan_query) {  // a NaN query's outputs are NaN: no walk
    const int axis = *axis_of_sort;
    if (resident) {
      sweep_sorted_axis<K, kStats>(sorted_verts, m, axis, qx, qy, qz, bd, bi,
                                   tested, full);
    } else {
      sweep_sorted_axis<K, kStats>(verts, m, axis, qx, qy, qz, bd, bi,
                                   tested, full);
    }
  }
  if (kStats) add_counts(counts, tested, full);
  if (!live) return;
  blend_write(bd, bi, values, c, eps, nan_query,
              out_vals + static_cast<size_t>(q) * c, out_wd + q);
  if (out_idx != nullptr) {  // the selection, nearest first; -1 for NaN
    int* o = out_idx + static_cast<size_t>(q) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) o[s] = nan_query ? -1 : bi[s];
  }
}

// The query's square gap to a box on each axis, their max: a lower bound,
// bit for bit, of the kernels' d2 to every vertex in the box (lo3, hi3).
__device__ __forceinline__ float box_gap2(float qx, float qy, float qz,
                                          const float* __restrict__ box) {
  const float q[3] = {qx, qy, qz};
  float g2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = q[a] < box[a] ? __fsub_rn(q[a], box[a])
                    : q[a] > box[3 + a] ? __fsub_rn(q[a], box[3 + a])
                                        : 0.f;
    g2 = fmaxf(g2, __fmul_rn(g, g));
  }
  return g2;
}

// One run of kRun rows (float4 x, y, z and the row's index as int bits)
// for one query: the A-square reject, then the full distance and the
// lexicographic insert. The rows are read from global memory: every lane
// of the warp reads the same row, and they stay in L1.
template <int K, int A, bool kStats>
__device__ __forceinline__ void sweep_run(
    const float4* __restrict__ rows, float qx, float qy, float qz,
    float (&bd)[K], int (&bi)[K], unsigned& tested, unsigned& full) {
  const float qa = axis_of<A>(qx, qy, qz);
#pragma unroll 4
  for (int j = 0; j < kRun; ++j) {
    const float4 p = __ldg(rows + j);
    const float da = __fsub_rn(qa, axis_of<A>(p));
    const float a2 = __fmul_rn(da, da);
    if (kStats) ++tested;
    if (!(a2 > bd[K - 1])) {
      if (kStats) ++full;
      topk_insert_lex(bd, bi, sq_dist_from<A>(qx, qy, qz, p, a2),
                      __float_as_int(p.w));
    }
  }
}

// The `count` rows from `first` (a multiple of kRun) in runs of kRun,
// each run with its box in `runs` (8 floats a run: lo3, hi3, its longest
// axis): a warp skips a run that the gap test rejects for every lane;
// `idle` lanes take no part. Every lane of the warp calls it.
template <int K, bool kStats>
__device__ __forceinline__ void sweep_runs(
    const float4* __restrict__ rows, const float* __restrict__ runs,
    int first, int count, bool idle, float qx, float qy, float qz,
    float (&bd)[K], int (&bi)[K], unsigned& tested, unsigned& full) {
  for (int at = first; at < first + count; at += kRun) {
    const float* box = runs + 8 * static_cast<size_t>(at / kRun);
    const bool idle_run = idle || box_gap2(qx, qy, qz, box) > bd[K - 1];
    if (__all_sync(kFullMask, idle_run) || idle_run) continue;
    switch (static_cast<int>(box[6])) {
      case 0:
        sweep_run<K, 0, kStats>(rows + at, qx, qy, qz, bd, bi, tested, full);
        break;
      case 1:
        sweep_run<K, 1, kStats>(rows + at, qx, qy, qz, bd, bi, tested, full);
        break;
      default:
        sweep_run<K, 2, kStats>(rows + at, qx, qy, qz, bd, bi, tested, full);
    }
  }
}

__device__ __forceinline__ float warp_mean(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v * (1.f / 32.f);
}

// One block per tile of kBlockedTile Morton-sorted queries (src holds
// n_tiles * kBlockedTile rows). meta (n_tiles, 8): the tile's box lo3,
// hi3 and radius; bboxes (n_blocks, 8): each vertex block's box lo3, hi3
// (finite), for the tile cull the plain version makes; verts (n_blocks *
// block, 4), sboxes (n_blocks, 8) and subs (n_blocks * block / kRun, 8)
// from ops/knn.py `blocked_layout`: the vertices as float4 with their
// sorted position, and the box of each block and of each run of kRun
// vertices over all their rows, pads included, lo3, hi3, the longest
// axis. Dynamic shared memory: n_blocks ints, then per warp n_blocks
// floats and n_blocks ints.
template <int K, bool kStats>
__global__ void __launch_bounds__(kBlockedTile)
    knn_blocked_kernel(const float* __restrict__ src,
                       const float* __restrict__ meta,
                       const float* __restrict__ bboxes,
                       const float4* __restrict__ verts,
                       const float* __restrict__ sboxes,
                       const float* __restrict__ subs,
                       const float* __restrict__ values, int n_blocks,
                       int block, int c, float eps,
                       float* __restrict__ out_vals,
                       float* __restrict__ out_wd,
                       unsigned long long* __restrict__ counts) {
  extern __shared__ int kept[];
  __shared__ int n_kept;
  const int tid = threadIdx.x;
  const int q = blockIdx.x * kBlockedTile + tid;
  const float* s = src + 3 * static_cast<size_t>(q);
  const float qx = s[0], qy = s[1], qz = s[2];
  const float* mt = meta + 8 * static_cast<size_t>(blockIdx.x);
  if (tid < 32) {
    // warp 0: the kept blocks, ascending. The squared distance between
    // the two boxes as the plain version and the Pallas body form it.
    const float r2 = __fmul_rn(mt[6], mt[6]);
    int count = 0;
    for (int base = 0; base < n_blocks; base += 32) {
      const int b = base + tid;
      bool keep = false;
      if (b < n_blocks) {
        const float* bb = bboxes + 8 * static_cast<size_t>(b);
        float d2b = 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float g = nan_max(nan_max(__fsub_rn(bb[a], mt[3 + a]),
                                          __fsub_rn(mt[a], bb[3 + a])),
                                  0.f);
          d2b = __fadd_rn(d2b, __fmul_rn(g, g));
        }
        keep = d2b <= r2;
      }
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      if (keep) kept[count + __popc(ballot & ((1u << tid) - 1u))] = b;
      count += __popc(ballot);
    }
    if (tid == 0) n_kept = count;
  }
  __syncthreads();
  const int nk = n_kept;
  // this warp's order of the kept blocks: by the gap from its queries'
  // centroid to each block's box, nearest first (ties by kept position),
  // so that its k-th best tightens early and the gap test skips more
  const int lane = tid & 31, warp = tid >> 5;
  float* key = reinterpret_cast<float*>(kept + n_blocks) + 2 * n_blocks * warp;
  int* order = reinterpret_cast<int*>(key + n_blocks);
  const float cx = warp_mean(qx), cy = warp_mean(qy), cz = warp_mean(qz);
  for (int e = lane; e < nk; e += 32) {
    const float g2 = box_gap2(cx, cy, cz, sboxes + 8 * static_cast<size_t>(kept[e]));
    key[e] = isnan(g2) ? 0.f : g2;  // a NaN query: kept order
  }
  __syncwarp();
  for (int e = lane; e < nk; e += 32) {
    const float ke = key[e];
    int rank = 0;
    for (int f = 0; f < nk; ++f) {
      const float kf = key[f];
      rank += kf < ke || (kf == ke && f < e);
    }
    order[rank] = kept[e];
  }
  __syncwarp();
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }
  unsigned tested = 0, full = 0;
  for (int i = 0; i < nk; ++i) {
    const int b = order[i];
    // no vertex of a box can enter when d2 >= the gap's square > bd
    const bool idle =
        box_gap2(qx, qy, qz, sboxes + 8 * static_cast<size_t>(b)) > bd[K - 1];
    if (__all_sync(kFullMask, idle)) continue;  // the warp skips the block
    sweep_runs<K, kStats>(verts, subs, b * block, block, idle, qx, qy, qz,
                          bd, bi, tested, full);
  }
  // a tile that kept no block: the plain version's k rounds all pick
  // column 0 of an all-+inf row
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (bi[s] == INT_MAX) bi[s] = 0;
  }
  if (kStats) add_counts(counts, tested, full);
  blend_write(bd, bi, values, c, eps, is_nan3(qx, qy, qz),
              out_vals + static_cast<size_t>(q) * c, out_wd + q);
}

// The signed difference from q to the nearer face of [lo, hi] on one
// axis, 0 inside: its square is <= the square of q - v, bit for bit, for
// every v in [lo, hi].
__device__ __forceinline__ float axis_gap(float q, float lo, float hi) {
  return q < lo ? __fsub_rn(q, lo) : (q > hi ? __fsub_rn(q, hi) : 0.f);
}

// The same from the interval [qlo, qhi] of a warp's queries: a lower
// bound, in magnitude, of axis_gap for every q in it.
__device__ __forceinline__ float span_gap(float qlo, float qhi, float lo,
                                          float hi) {
  return qhi < lo ? __fsub_rn(qhi, lo) : (qlo > hi ? __fsub_rn(qlo, hi) : 0.f);
}

// Three gaps squared and summed as sq_dist sums d2: a lower bound, bit for
// bit, of d2 to every vertex of the box (the exact reject above).
__device__ __forceinline__ float gap_sq(float gx, float gy, float gz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

template <bool kMin>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFullMask, v, o);
    v = kMin ? fminf(v, w) : fmaxf(v, w);
  }
  return v;
}

// One run of kRun rows of K3's and K4's walk for one query: when `need`,
// each row's A-square reject, then the full distance and the insert of
// its value. Every lane of the warp reads the same row, from L1.
template <int K, int A, bool kStats>
__device__ __forceinline__ void grid_run(const float4* __restrict__ rows,
                                         float qx, float qy, float qz,
                                         bool need, float (&bd)[K],
                                         int (&bi)[K], unsigned& full) {
  const float qa = axis_of<A>(qx, qy, qz);
#pragma unroll 4
  for (int j = 0; j < kRun; ++j) {
    const float4 p = __ldg(rows + j);
    const float da = __fsub_rn(qa, axis_of<A>(p));
    const float a2 = __fmul_rn(da, da);
    if (need && a2 < bd[K - 1]) {
      if (kStats) ++full;
      topk_insert(bd, bi, sq_dist_from<A>(qx, qy, qz, p, a2), 0);
    }
  }
}

// K3 (K = 1) and K4: the k-th smallest d2 of each of the n queries src
// (n, 3) over ops/knn.py `grid_layout`'s rows (n_runs * kRun, float4) and
// run boxes (n_runs, 8 floats: lo3, hi3, longest axis, 0), its square root
// to out (n,). One warp per 32 consecutive queries, kGridWarps warps a
// block; dynamic shared memory: n_runs floats per warp. kStats counts the
// (warp, run) pairs ranked and tested, those swept, and the (query,
// vertex) pairs whose one-axis reject ran and that took the full
// distance.
template <int K, bool kStats>
__device__ __forceinline__ void grid_walk(
    const float* __restrict__ src, const float4* __restrict__ rows,
    const float4* __restrict__ runs, int n, int n_runs,
    float* __restrict__ out, unsigned long long* __restrict__ counts) {
  extern __shared__ float run_keys[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* keys = run_keys + static_cast<size_t>(warp) * n_runs;
  const int q = (blockIdx.x * kGridWarps + warp) * 32 + lane;
  float qx, qy, qz;
  const bool in_range = load_query(src, q, n, &qx, &qy, &qz);
  const bool nan_query = is_nan3(qx, qy, qz);
  const bool live = in_range && !nan_query;
  // a lane with no walk (past n, or a NaN query) holds a negative bound,
  // which every gap and every square is >=
  float bd[K];
  int bi[K];  // unread: the compiler drops it
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = live ? INFINITY : -1.f;
    bi[s] = 0;
  }
  unsigned ranked = 0, swept = 0, tested = 0, full = 0;
  if (__any_sync(kFullMask, live)) {  // the same for every lane
    const float lx = warp_reduce<true>(live ? qx : INFINITY);
    const float ly = warp_reduce<true>(live ? qy : INFINITY);
    const float lz = warp_reduce<true>(live ? qz : INFINITY);
    const float hx = warp_reduce<false>(live ? qx : -INFINITY);
    const float hy = warp_reduce<false>(live ? qy : -INFINITY);
    const float hz = warp_reduce<false>(live ? qz : -INFINITY);
    // this lane's runs r = lane, lane + 32, ...: their keys (>= 0, so
    // their bits order as they do) and the smallest untaken one, lowest
    // run first among equals
    float lmin = INFINITY;
    int lrun = 0;
    for (int r = lane; r < n_runs; r += 32) {
      const float4 b0 = __ldg(runs + 2 * r), b1 = __ldg(runs + 2 * r + 1);
      const float key = gap_sq(span_gap(lx, hx, b0.x, b0.w),
                               span_gap(ly, hy, b0.y, b1.x),
                               span_gap(lz, hz, b0.z, b1.y));
      keys[r] = key;
      if (key < lmin) {
        lmin = key;
        lrun = r;
      }
    }
    unsigned top = __reduce_max_sync(
        kFullMask, live ? __float_as_uint(bd[K - 1]) : 0u);
    for (;;) {
      const unsigned next = __reduce_min_sync(kFullMask, __float_as_uint(lmin));
      if (next >= top) break;  // every run left is rejected by every lane
      const int owner =
          __ffs(__ballot_sync(kFullMask, __float_as_uint(lmin) == next)) - 1;
      const int r = __shfl_sync(kFullMask, lrun, owner);
      if (lane == owner) {  // its keys are its own: no other lane reads them
        keys[r] = INFINITY;
        lmin = INFINITY;
        for (int e = lane; e < n_runs; e += 32) {
          const float key = keys[e];
          if (key < lmin) {
            lmin = key;
            lrun = e;
          }
        }
      }
      if (kStats) ++ranked;
      const float4 b0 = __ldg(runs + 2 * r), b1 = __ldg(runs + 2 * r + 1);
      const bool need = gap_sq(axis_gap(qx, b0.x, b0.w),
                               axis_gap(qy, b0.y, b1.x),
                               axis_gap(qz, b0.z, b1.y)) < bd[K - 1];
      if (!__any_sync(kFullMask, need)) continue;  // the warp skips the run
      if (kStats) {
        ++swept;
        tested += need ? kRun : 0;
      }
      const float4* run_rows = rows + static_cast<size_t>(r) * kRun;
      switch (static_cast<int>(b1.z)) {
        case 0:
          grid_run<K, 0, kStats>(run_rows, qx, qy, qz, need, bd, bi, full);
          break;
        case 1:
          grid_run<K, 1, kStats>(run_rows, qx, qy, qz, need, bd, bi, full);
          break;
        default:
          grid_run<K, 2, kStats>(run_rows, qx, qy, qz, need, bd, bi, full);
      }
      top = __reduce_max_sync(kFullMask,
                              live ? __float_as_uint(bd[K - 1]) : 0u);
    }
  }
  if (kStats) {
    add_counts(counts, lane == 0 ? ranked : 0u, lane == 0 ? swept : 0u,
               tested, full);
  }
  if (!in_range) return;
  out[q] = nan_query ? NAN : __fsqrt_rn(bd[K - 1]);
}

// ops/knn.py `morton_key`'s spread of a 10-bit coordinate to every third
// bit.
__device__ __forceinline__ unsigned spread_bits(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// K3's and K4's layout, first launch (one block of kKeyThreads): the box
// of ref (m, 3), then each vertex's Morton key of kMortonBits an axis,
// formed as ops/knn.py `_morton_order` forms it (torch's scalar / tensor
// is a reciprocal times the scalar), so that its stable sort is the
// same order.
__global__ void __launch_bounds__(kKeyThreads)
    grid_keys_kernel(const float* __restrict__ ref, int m,
                     int* __restrict__ keys) {
  __shared__ float part[6][kKeyThreads / 32];
  __shared__ float box[6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < m; i += kKeyThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = ref[3 * static_cast<size_t>(i) + a];
      b[a] = fminf(b[a], v);
      b[3 + a] = fmaxf(b[3 + a], v);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    b[a] = a < 3 ? warp_reduce<true>(b[a]) : warp_reduce<false>(b[a]);
    if (lane == 0) part[a][warp] = b[a];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float v = part[a][lane];
      const float r = a < 3 ? warp_reduce<true>(v) : warp_reduce<false>(v);
      if (lane == 0) box[a] = r;
    }
  }
  __syncthreads();
  constexpr float kTop = static_cast<float>((1 << kMortonBits) - 1);
  float mn[3], scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = box[a];
    scale[a] = __fmul_rn(__frcp_rn(fmaxf(__fsub_rn(box[3 + a], mn[a]), 1e-9f)),
                         kTop);
  }
  for (int i = threadIdx.x; i < m; i += kKeyThreads) {
    unsigned key = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = __fmul_rn(
          __fsub_rn(ref[3 * static_cast<size_t>(i) + a], mn[a]), scale[a]);
      key |= spread_bits(static_cast<unsigned>(
                 __float2int_rz(fminf(fmaxf(t, 0.f), kTop))))
             << a;
    }
    keys[i] = static_cast<int>(key);
  }
}

// The layout's second launch, after the stable argsort of the keys
// (order (m,)): one warp per run of kRun rows, the rows ref[order] as
// float4 (x, y, z, 0), pads at +inf past m, and the run's box over its
// real rows with its longest axis, the first of equal extents (as
// torch.argmax): runs (n_runs, 8) [lo3, hi3, axis, 0].
__global__ void __launch_bounds__(256)
    grid_runs_kernel(const float* __restrict__ ref,
                     const long long* __restrict__ order, int m, int n_runs,
                     float4* __restrict__ rows, float* __restrict__ runs) {
  static_assert(kRun == 32, "a run is a warp's rows");
  const int run = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (run >= n_runs) return;  // the same for every lane of the warp
  const int i = run * kRun + (threadIdx.x & 31);
  const bool real = i < m;
  float p[3] = {INFINITY, INFINITY, INFINITY};
  if (real) {
    const float* r = ref + 3 * static_cast<size_t>(order[i]);
    p[0] = r[0];
    p[1] = r[1];
    p[2] = r[2];
  }
  rows[i] = make_float4(p[0], p[1], p[2], 0.f);
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_reduce<true>(p[a]);
    hi[a] = warp_reduce<false>(real ? p[a] : -INFINITY);
  }
  if ((threadIdx.x & 31) != 0) return;
  int axis = 0;
  float extent = __fsub_rn(hi[0], lo[0]);
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    const float e = __fsub_rn(hi[a], lo[a]);
    if (e > extent) {
      extent = e;
      axis = a;
    }
  }
  float* box = runs + 8 * static_cast<size_t>(run);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    box[a] = lo[a];
    box[3 + a] = hi[a];
  }
  box[6] = static_cast<float>(axis);
  box[7] = 0.f;
}

template <bool kStats>
__global__ void __launch_bounds__(kGridWarps * 32)
    min_dist_kernel(const float* __restrict__ src,
                    const float4* __restrict__ rows,
                    const float4* __restrict__ runs, int n, int n_runs,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ counts) {
  grid_walk<1, kStats>(src, rows, runs, n, n_runs, out, counts);
}

template <int K, bool kStats>
__global__ void __launch_bounds__(kGridWarps * 32)
    kth_dist_kernel(const float* __restrict__ src,
                    const float4* __restrict__ rows,
                    const float4* __restrict__ runs, int n, int n_runs,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ counts) {
  grid_walk<K, kStats>(src, rows, runs, n, n_runs, out, counts);
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

// launch(K, kStats) for a kernel with a counting build: the counting one
// (K = 5 only) when `counts` is given, else the runtime k's
template <typename Launch>
int dispatch_counts(int k, const unsigned long long* counts, Launch&& launch) {
  if (counts != nullptr) {
    if (k != 5) return static_cast<int>(cudaErrorInvalidValue);
    return launch(std::integral_constant<int, 5>{}, std::true_type{});
  }
  return dispatch_k(k, [&](auto kc) { return launch(kc, std::false_type{}); });
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// The current device and its SM count and opt-in shared memory per
// block. The attributes are read once per device: read on every call,
// they cost a K2 or K5 launch's worth of host time.
struct Card {
  int dev = 0;
  int sms = 0;
  int smem_optin = 0;
};

Card current_card() {
  static Card cards[kMaxCards];
  Card card;
  cudaGetDevice(&card.dev);
  if (card.dev < kMaxCards && cards[card.dev].sms > 0) return cards[card.dev];
  cudaDeviceGetAttribute(&card.sms, cudaDevAttrMultiProcessorCount, card.dev);
  cudaDeviceGetAttribute(&card.smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, card.dev);
  if (card.dev < kMaxCards) cards[card.dev] = card;
  return card;
}

constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

// K3's or K4's launch: kGridWarps warps a block, each with n_runs floats
// of shared memory for its keys (opted in above 48 KB, past 1536 runs).
template <typename Kernel>
int launch_grid_walk(Kernel kernel, const float* src, const float* rows,
                     const float* runs, int n, int n_runs, float* out,
                     unsigned long long* counts, void* stream) {
  if (n_runs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * kGridWarps * static_cast<size_t>(n_runs);
  if (smem > kDefaultSmem) {
    const Card card = current_card();
    if (smem > static_cast<size_t>(card.smem_optin)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int per_block = 32 * kGridWarps;
  kernel<<<(n + per_block - 1) / per_block, per_block, smem,
           static_cast<cudaStream_t>(stream)>>>(
      src, reinterpret_cast<const float4*>(rows),
      reinterpret_cast<const float4*>(runs), n, n_runs, out, counts);
  return last_error();
}

}  // namespace

extern "C" {

int knn_max_k() { return kMaxK; }

// ops/knn.py `grid_layout` of ref (m, 3) on the card: the Morton keys
// (m,) int32 of ref, for the caller's stable argsort.
int knn_grid_keys(const float* ref, int m, int* keys, void* stream) {
  if (m <= 0) return 0;
  grid_keys_kernel<<<1, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ref, m, keys);
  return last_error();
}

// Then, from that order (m,) int64: rows (n_runs * kRun, 4) and runs
// (n_runs, 8), n_runs = ceil(m / kRun).
int knn_grid_runs(const float* ref, const long long* order, int m,
                  float* rows, float* runs, void* stream) {
  if (m <= 0) return 0;
  const int n_runs = (m + kRun - 1) / kRun;
  grid_runs_kernel<<<(n_runs * 32 + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ref, order, m, n_runs, reinterpret_cast<float4*>(rows), runs);
  return last_error();
}

// src (n, 3) and the layout of ref (m, 3) from ops/knn.py `grid_layout`,
// rows (n_runs * kRun, 4) and runs (n_runs, 8) -> out (n,): distance to
// the nearest vertex. counts, if given, gains the walk's four counts
// (`grid_walk`).
int knn_min_dist(const float* src, const float* rows, const float* runs,
                 int n, int n_runs, float* out, unsigned long long* counts,
                 void* stream) {
  if (counts != nullptr) {
    return launch_grid_walk(min_dist_kernel<true>, src, rows, runs, n, n_runs,
                            out, counts, stream);
  }
  return launch_grid_walk(min_dist_kernel<false>, src, rows, runs, n, n_runs,
                          out, counts, stream);
}

// The same -> out (n,): distance to the k-th nearest vertex. counts, if
// given (k = 5 only), gains the walk's four counts.
int knn_kth_dist(const float* src, const float* rows, const float* runs,
                 int n, int n_runs, int k, float* out,
                 unsigned long long* counts, void* stream) {
  return dispatch_counts(k, counts, [&](auto kc, auto stats) {
    return launch_grid_walk(
        kth_dist_kernel<decltype(kc)::value, decltype(stats)::value>, src,
        rows, runs, n, n_runs, out, counts, stream);
  });
}

// src (n, 3), the layout of ref (m, 3) from ops/knn.py `sweep_layout`
// (verts (m, 4), axis (1,) int32), values (m, c) -> out_vals (n, c),
// out_wd (n,): the IDW blend of the k nearest vertices' values and
// distances; out_idx (n, k), if given, the k vertices' original
// indices, nearest first (ties to the lowest index; -1 for a NaN
// query). counts, if given (k = 5 only), gains the vertices reached and
// those that took the full distance.
int knn_blend(const float* src, const float* verts, const int* axis,
              const float* values, int n, int m, int c, int k, float eps,
              float* out_vals, float* out_wd, int* out_idx,
              unsigned long long* counts, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Card card = current_card();
  const size_t bytes = static_cast<size_t>(m) * sizeof(float4);
  const bool resident = bytes <= static_cast<size_t>(card.smem_optin);
  return dispatch_counts(k, counts, [&](auto kc, auto stats) {
    auto kernel = knn_blend_kernel<decltype(kc)::value, decltype(stats)::value>;
    int threads = kThreads;
    size_t smem = 0;
    if (resident) {
      // the fewest threads a block that let every block be resident at
      // once: the queries spread evenly over the SMs in one wave. The
      // attributes are set, and the blocks an SM holds read, once per
      // instantiation, device and m (a frame's calls share them).
      static int set_dev = -1, set_m = -1, per_sm = 1;
      smem = bytes;
      if (set_dev != card.dev || set_m != m) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
        int blocks_per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                      kSweepThreads, smem);
        per_sm = blocks_per_sm > 0 ? blocks_per_sm : 1;
        set_dev = card.dev;
        set_m = m;
      }
      const int slots = per_sm * card.sms;
      threads = ((n + slots - 1) / slots + 31) / 32 * 32;
      threads = threads < kSweepMinThreads ? kSweepMinThreads
                : threads > kSweepThreads  ? kSweepThreads
                                           : threads;
    }
    const int blocks = (n + threads - 1) / threads;
    kernel<<<blocks, threads, smem, s>>>(
        src, reinterpret_cast<const float4*>(verts), axis, values, n, m, c,
        eps, resident, out_vals, out_wd, out_idx, counts);
    return last_error();
  });
}

// src (n_tiles * kBlockedTile, 3) Morton-sorted queries, meta (n_tiles,
// 8), bboxes (n_blocks, 8), and from ops/knn.py `blocked_layout` verts
// (n_blocks * block, 4), sboxes (n_blocks, 8) and subs (n_blocks * block
// / kRun, 8); values (n_blocks * block, c) -> out_vals (n_tiles *
// kBlockedTile, c), out_wd (n_tiles * kBlockedTile,). block is a
// multiple of kRun up to kTile. counts, if given (k = 5 only), gains the
// pairs whose one-axis reject ran and those that took the full distance.
int knn_blocked(const float* src, const float* meta, const float* bboxes,
                const float* verts, const float* sboxes, const float* subs,
                const float* values, int n_tiles, int n_blocks, int block,
                int c, int k, float eps, float* out_vals, float* out_wd,
                unsigned long long* counts, void* stream) {
  if (block < kRun || block > kTile || block % kRun != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the kept list, then each warp's keys and order
  const size_t smem = static_cast<size_t>(n_blocks) * sizeof(int) *
                      (1 + 2 * (kBlockedTile / 32));
  const Card card = current_card();
  if (smem > static_cast<size_t>(card.smem_optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_counts(k, counts, [&](auto kc, auto stats) {
    auto kernel =
        knn_blocked_kernel<decltype(kc)::value, decltype(stats)::value>;
    if (smem > kDefaultSmem) {  // over 722 blocks: opt in, once a device
      static int set_dev = -1;
      if (set_dev != card.dev) {
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             card.smem_optin);
        set_dev = card.dev;
      }
    }
    kernel<<<n_tiles, kBlockedTile, smem, s>>>(
        src, meta, bboxes, reinterpret_cast<const float4*>(verts), sboxes,
        subs, values, n_blocks, block, c, eps, out_vals, out_wd, counts);
    return last_error();
  });
}

// K5's query tile and run, for ops/knn.py's BLOCKED_TILE and RUN
int knn_blocked_tile() { return kBlockedTile; }
int knn_blocked_run() { return kRun; }

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
