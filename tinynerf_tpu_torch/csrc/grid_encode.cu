// The multiresolution hash-grid encoding on Hopper (sm_90a): the forward
// (gather and trilinear blend of every level) and the backward (every
// table's gradient), for models/grid_nerf.py's encode_levels and
// encode_levels_bwd. It replaces no TPU kernel: the JAX package runs the
// encoding in XLA by design (tinynerf_tpu/models/grid_nerf.py, no Pallas
// kernel). It was added because in eager torch the encoding took 13.1 of
// the 15.8 device ms of an Instant-NGP training step at its published
// sizes (16 levels, F = 2, T = 2^19, 2^18 points): the gather built int64
// ids, f32 weights and a (L, N, 8, F) corner tensor and kept the ids and
// weights for the backward, whose index_put_ sorted 33.5 M int64 ids on 64
// bits before it summed each entry's run of duplicates.
//
// What bounds it: bytes and L2 traffic. A pass must read the points (12 B
// each), every table entry (8 B at F = 2) and read or write the features
// (L * F * 4 B a point): about 85.5 MB, 25.5 us at 3.35 TB/s, at the
// published sizes; the tables (48.8 MB) sit in the 50 MB L2, so each
// corner is an L2 read. The design:
//
//   tinynerf_grid_encode_fwd   one launch (a launch per kMaxLevels levels
//       past that), a thread a (point, level), consecutive threads on
//       consecutive levels of a point, so that a warp writes whole output
//       rows; the tables are read in place from their L pointers, and each
//       level's ids, weights and features live in registers. (Lanes on 32
//       points of one level, warps on the levels, took 0.29 ms against this
//       layout's 0.16 on an H100 at the published sizes: PERF.md.) Nothing is
//       kept for the backward but the points themselves.
//   tinynerf_grid_encode_bwd   a fixed set of launches and no float
//       atomics: (a) grid_keys_kernel recomputes each corner's entry in the
//       tables laid end to end as a 32-bit key, with the term's flat index
//       (level * N + point) * 8 + corner as its value, writes one record a
//       (level, point) with its feature gradients and cell fractions (32
//       bytes at F = 2), and zeroes each entry's run bounds; (b) CUB's
//       stable radix sort over only the key bits the entry count needs (23
//       at the published sizes), the one library step; (c)
//       grid_bounds_kernel writes where each entry's run of equal keys
//       starts and ends; (d) grid_sum_kernel, a thread an entry, writes
//       every entry's gradient: 0 where no corner fell, else the run summed
//       in order, each term's weight recomputed from its record (one read a
//       term, from L2 while the sums walk the record's level, where the
//       points and the gradient would cost two or three scattered reads:
//       1.57 ms a backward against 1.69 re-deriving them on an H100: PERF.md); a
//       run longer than kShortRun is left to (e) grid_sum_long_kernel, a
//       warp a run, whose lanes load and multiply 128 terms at a time into
//       shared memory, where one lane a feature adds them: the sum stays
//       one sequence of additions. The run lengths, not a setting, pick the
//       split: about 430 terms an entry on the coarsest level, about 4 on
//       the finest. The sort moves most of the backward's bytes (three
//       passes over 268 MB of pairs). Measured times beside the bound:
//       PERF.md's kernel table, row G.
//
// Bit for bit the plain path (models/grid_nerf.py: the per-level gather and
// autograd's IndexBackward): every product and sum is written with
// __fmul_rn / __fadd_rn / __fsub_rn, so that nothing is contracted into an
// FMA; the weight is (fac_x * fac_y) * fac_z with fac = f or 1 - f and
// f = u * res - i0; the 8 corners are summed in the order torch.sum over
// the corner axis takes on the card (corner_sum); a run is summed from 0 in
// the stable sort's order, ascending (point, corner), as index_put_'s
// accumulate kernel does. Both orders were read on the card at F = 2, 3, 4
// and 8 (PERF.md); at F = 1 torch.sum reduces a contiguous axis and
// index_put_ takes its stride-1 kernel, both in other orders, so there the
// results agree to f32 rounding, not bit for bit.
//
// Any ladder GridNeRFConfig makes: any level count (the forward and the
// keys a launch per kMaxLevels levels), any features (F = 2, every
// configuration's width, compiled as such; any other read and summed a
// feature at a time), any table size and dense/hashed mix, as long as the
// tables laid end to end hold fewer than 2^31 entries (the keys are
// 32-bit) and a backward fewer than 2^31 corner terms.
//
// The Python wrapper is tinynerf_tpu_torch/kernels/grid_encode.py; it
// allocates every buffer (the launch allocates nothing), the backward's
// scratch as one buffer of tinynerf_grid_bwd_scratch_bytes, which the
// backward carves into its sections (Layout), and checks what the launches
// take, which are checked again here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kMaxLevels = 32;    // levels a launch takes (the dense bits)
constexpr int kShortRun = 32;      // longer runs go to grid_sum_long_kernel
constexpr int kThreads = 256;
constexpr int kKeyWarps = kThreads / 32;  // warps of a keys block (32 points)
constexpr int kLongChunk = 4;      // terms a lane of grid_sum_long_kernel holds
constexpr unsigned kFull = 0xffffffffu;
// The paper's spatial-hash primes (pi_1 = 1 keeps x-major locality).
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

// A group of at most kMaxLevels consecutive levels, passed by value.
struct Levels {
  const float* table[kMaxLevels];  // each level's (T_l, F) table (forward only)
  int res[kMaxLevels];
  int offset[kMaxLevels];          // each level's first entry in the tables laid end to end
  unsigned dense;                  // bit l: level first + l is dense
  unsigned hash_mask;              // table_size - 1
  int first, n_levels;             // the group's first level and its level count
  int all_levels, features, n_points, total;  // of the whole ladder
};

struct Cell {
  int x, y, z;        // the cell's low corner
  float fx, fy, fz;   // the point's fraction in it
};

// The cell and fraction of u on a level of resolution res, in float32 in
// the plain path's order: xs = u * res, i0 = min(floor(xs), res - 1) (u = 1
// lies in the last cell), f = xs - i0.
__device__ __forceinline__ void axis(float u, int res, int& i, float& f) {
  const float xs = __fmul_rn(u, (float)res);
  i = max(0, min((int)floorf(xs), res - 1));
  f = __fsub_rn(xs, (float)i);
}

__device__ __forceinline__ Cell cell_of(float ux, float uy, float uz, int res) {
  Cell c;
  axis(ux, res, c.x, c.fx);
  axis(uy, res, c.y, c.fy);
  axis(uz, res, c.z, c.fz);
  return c;
}

// The level-local id of corner k (bit 2 x, bit 1 y, bit 0 z): the dense
// index ((x * side) + y) * side + z, or the xor-prime hash in uint32 masked.
__device__ __forceinline__ uint32_t corner_id(const Cell& c, int k, int res, bool dense,
                                              uint32_t mask) {
  const uint32_t x = c.x + ((k >> 2) & 1), y = c.y + ((k >> 1) & 1), z = c.z + (k & 1);
  if (dense) {
    const uint32_t side = res + 1;
    return (x * side + y) * side + z;
  }
  return (x ^ (y * kPrimeY) ^ (z * kPrimeZ)) & mask;
}

// Corner k's trilinear weight, (fac_x * fac_y) * fac_z.
__device__ __forceinline__ float corner_weight(const Cell& c, int k) {
  const float ax = (k & 4) ? c.fx : __fsub_rn(1.0f, c.fx);
  const float ay = (k & 2) ? c.fy : __fsub_rn(1.0f, c.fy);
  const float az = (k & 1) ? c.fz : __fsub_rn(1.0f, c.fz);
  return __fmul_rn(__fmul_rn(ax, ay), az);
}

// The 8 corners' products summed in the order of torch.sum over the corner
// axis on the card: its reduction keeps 4 accumulators over the 8 terms
// (i and i + 4) and then combines them in order.
__device__ __forceinline__ float corner_sum(const float (&x)[8]) {
  const float a0 = __fadd_rn(x[0], x[4]), a1 = __fadd_rn(x[1], x[5]);
  const float a2 = __fadd_rn(x[2], x[6]), a3 = __fadd_rn(x[3], x[7]);
  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
}

// Forward: one thread a (point, level) of the group, consecutive threads on
// consecutive levels of a point, so that a warp writes whole rows of the
// output; the group's table pointers and resolutions sit in shared memory,
// since a warp's lanes read different levels. kF = 2 reads each corner's
// features with one float2 load; kF = 0 takes any width (p.features).
template <int kF>
__global__ void __launch_bounds__(kThreads)
    grid_encode_fwd_kernel(const Levels p, const float* __restrict__ u, float* __restrict__ out) {
  __shared__ const float* tables[kMaxLevels];
  __shared__ int resolutions[kMaxLevels];
  if (threadIdx.x < p.n_levels) {
    tables[threadIdx.x] = p.table[threadIdx.x];
    resolutions[threadIdx.x] = p.res[threadIdx.x];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.n_points * p.n_levels) return;
  const int n = (int)(i / p.n_levels), l = (int)(i - (long long)n * p.n_levels);
  const int res = resolutions[l];
  const bool dense = (p.dense >> l) & 1;
  const Cell c = cell_of(__ldg(u + 3 * (size_t)n), __ldg(u + 3 * (size_t)n + 1),
                         __ldg(u + 3 * (size_t)n + 2), res);
  const float* __restrict__ t = tables[l];
  const int F = kF > 0 ? kF : p.features;
  float* out_l = out + ((size_t)n * p.all_levels + p.first + l) * F;
  uint32_t id[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    id[k] = corner_id(c, k, res, dense, p.hash_mask);
    w[k] = corner_weight(c, k);
  }
  if constexpr (kF == 2) {
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(reinterpret_cast<const float2*>(t) + id[k]);
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __fmul_rn(w[k], v[k].x);
    out_l[0] = corner_sum(x);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __fmul_rn(w[k], v[k].y);
    out_l[1] = corner_sum(x);
  } else {
    for (int f = 0; f < F; ++f) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __fmul_rn(w[k], __ldg(t + (size_t)id[k] * F + f));
      out_l[f] = corner_sum(x);
    }
  }
}

// The floats of a term record: a (point, level)'s F feature gradients, then
// its fractions fx, fy, fz, padded to whole float4s.
__host__ __device__ constexpr int record_floats(int features) { return (features + 6) / 4 * 4; }

// (a) Keys: term t * 8 + k, t = level * n_points + point (level-major, so
// that every term of one key lies in ascending (point, corner) order, as the
// plain path sums it), gets the key of corner k's entry in the tables laid
// end to end and its own index as the value; record t holds what its 8
// terms need: the level's feature gradients of the point and the point's
// fractions in the level's cell, whole float4s. A block holds 32 points, one
// a lane, and kKeyWarps warps on the group's levels: the block's rows of
// grad (32 points x L x F floats) come through L1, and a warp writes 32
// consecutive terms' keys, values and records (0.28 ms against 0.31 for a
// thread a (level, point) in a flat grid, H100, published sizes: PERF.md).
// Level by level, the records of one level (8 MB at the published sizes)
// stay in L2 while the sums, which walk the entries level by level, read
// them. kF = 2 and kR = 8 its record's floats, or 0 and 0 for any
// width. The first group's launch also zeroes the run bounds of every
// entry and the long-run count.
template <int kF, int kR>
__global__ void __launch_bounds__(kThreads)
    grid_keys_kernel(const Levels p, const float* __restrict__ u, const float* __restrict__ grad,
                     uint32_t* __restrict__ keys, uint32_t* __restrict__ vals,
                     float* __restrict__ records, int2* __restrict__ bounds,
                     int* __restrict__ n_long) {
  const int N = p.n_points;
  const int F = kF > 0 ? kF : p.features, R = kR > 0 ? kR : record_floats(p.features);
  const long long stride = (long long)gridDim.x * blockDim.x * blockDim.y;
  const long long first =
      ((long long)blockIdx.x * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int n = blockIdx.x * 32 + threadIdx.x;
  for (int l = threadIdx.y; n < N && l < p.n_levels; l += blockDim.y) {
    const long long t = (long long)(p.first + l) * N + n;
    const int res = p.res[l];
    const bool dense = (p.dense >> l) & 1;
    const Cell c = cell_of(__ldg(u + 3 * (size_t)n), __ldg(u + 3 * (size_t)n + 1),
                           __ldg(u + 3 * (size_t)n + 2), res);
    uint32_t k8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) k8[k] = p.offset[l] + corner_id(c, k, res, dense, p.hash_mask);
    uint4* kp = reinterpret_cast<uint4*>(keys + 8 * t);
    kp[0] = make_uint4(k8[0], k8[1], k8[2], k8[3]);
    kp[1] = make_uint4(k8[4], k8[5], k8[6], k8[7]);
    const uint32_t v0 = 8u * (uint32_t)t;
    uint4* vp = reinterpret_cast<uint4*>(vals + 8 * t);
    vp[0] = make_uint4(v0, v0 + 1, v0 + 2, v0 + 3);
    vp[1] = make_uint4(v0 + 4, v0 + 5, v0 + 6, v0 + 7);
    const float* g = grad + ((size_t)n * p.all_levels + p.first + l) * F;  // (N, L, F)
    if constexpr (kR > 0) {
      float x[kR];
#pragma unroll
      for (int f = 0; f < kR; ++f) x[f] = f < kF ? __ldg(g + f) : 0.0f;
      x[kF] = c.fx;
      x[kF + 1] = c.fy;
      x[kF + 2] = c.fz;
      float4* rp = reinterpret_cast<float4*>(records) + t * (kR / 4);
#pragma unroll
      for (int q = 0; q < kR / 4; ++q)
        rp[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else {
      float* rec = records + t * R;
      for (int f = 0; f < F; ++f) rec[f] = __ldg(g + f);
      rec[F] = c.fx;
      rec[F + 1] = c.fy;
      rec[F + 2] = c.fz;
      for (int f = F + 3; f < R; ++f) rec[f] = 0.0f;
    }
  }
  if (p.first != 0) return;  // the first group's launch zeroes
  for (long long e = first; e < p.total; e += stride) bounds[e] = make_int2(0, 0);
  if (first == 0) *n_long = 0;
}

// (c) Run bounds: bounds[key] = (first, one past the last) sorted position
// of the key's run. A thread reads 4 keys; its neighbours' come by shuffle.
__global__ void __launch_bounds__(kThreads)
    grid_bounds_kernel(const uint32_t* __restrict__ keys, int m, int* __restrict__ bounds) {
  const int lane = threadIdx.x & 31;
  const int quads = (m + 3) / 4;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // every lane of a warp runs the same number of iterations (the shuffles)
  for (int q0 = first - lane; q0 < quads; q0 += stride) {
    const int q = q0 + lane;
    const int i = 4 * q;
    uint32_t k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = i + j < m ? __ldg(keys + i + j) : 0xffffffffu;
    uint32_t before = __shfl_up_sync(kFull, k[3], 1);
    uint32_t after = __shfl_down_sync(kFull, k[0], 1);
    if (lane == 0) before = i > 0 && i - 1 < m ? __ldg(keys + i - 1) : 0xffffffffu;
    if (lane == 31) after = i + 4 < m ? __ldg(keys + i + 4) : 0xffffffffu;
    if (i < m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j >= m) break;
        const uint32_t prev = j ? k[j - 1] : before, next = j < 3 ? k[j + 1] : after;
        if (i + j == 0 || prev != k[j]) bounds[2 * (size_t)k[j]] = i + j;
        if (i + j == m - 1 || next != k[j]) bounds[2 * (size_t)k[j] + 1] = i + j + 1;
      }
    }
  }
}

// Term v's features f0 ... f0 + kF - 1: record v / 8's feature gradients
// times corner v % 8's weight, (fac_x * fac_y) * fac_z from the record's
// fractions. kR the record's floats when the record is read whole (kF the
// features), 0 to read the kF features at f0 and the fractions alone.
template <int kF, int kR>
__device__ __forceinline__ void term(const float* __restrict__ records, int F, int f0, uint32_t v,
                                     float (&out)[kF]) {
  const int k = v & 7;
  Cell c;
  float g[kF];
  if constexpr (kR > 0) {
    const float4* r4 = reinterpret_cast<const float4*>(records) + (size_t)(v >> 3) * (kR / 4);
    float r[kR];
#pragma unroll
    for (int q = 0; q < kR / 4; ++q) {
      const float4 a = __ldg(r4 + q);
      r[4 * q] = a.x;
      r[4 * q + 1] = a.y;
      r[4 * q + 2] = a.z;
      r[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) g[f] = r[f];
    c.fx = r[kF];
    c.fy = r[kF + 1];
    c.fz = r[kF + 2];
  } else {
    const float* r = records + (size_t)(v >> 3) * record_floats(F);
#pragma unroll
    for (int f = 0; f < kF; ++f) g[f] = __ldg(r + f0 + f);
    c.fx = __ldg(r + F);
    c.fy = __ldg(r + F + 1);
    c.fz = __ldg(r + F + 2);
  }
  const float w = corner_weight(c, k);
#pragma unroll
  for (int f = 0; f < kF; ++f) out[f] = __fmul_rn(g[f], w);
}

// (d) Short runs: a thread an entry writes features f0 ... f0 + kF - 1 of
// its gradient (0 where no corner fell); the terms of a run are loaded 8
// at a time and added in order. A run longer than kShortRun is left to
// (e), and listed there when `list` is set (the first feature's launch;
// the others reuse the list).
template <int kF, int kR>
__global__ void __launch_bounds__(kThreads)
    grid_sum_kernel(int total, int features, int f0, int list, const uint32_t* __restrict__ vals,
                    const int2* __restrict__ bounds, const float* __restrict__ records,
                    float* __restrict__ table_grad, int* __restrict__ long_runs,
                    int* __restrict__ n_long) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int2 b = bounds[e];
    if (b.y - b.x > kShortRun) {
      if (list) long_runs[atomicAdd(n_long, 1)] = e;
      continue;
    }
    float acc[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) acc[f] = 0.0f;
    for (int j0 = b.x; j0 < b.y; j0 += 8) {
      float x[8][kF];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (j0 + q < b.y) term<kF, kR>(records, features, f0, __ldg(vals + j0 + q), x[q]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (j0 + q < b.y) {
#pragma unroll
          for (int f = 0; f < kF; ++f) acc[f] = __fadd_rn(acc[f], x[q][f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) table_grad[(size_t)e * features + f0 + f] = acc[f];
  }
}

// (e) Long runs: a warp a listed entry. Its lanes load and multiply
// 32 * kLongChunk terms at a time (lane i holds terms i, i + 32, ...) and
// leave the products in shared memory, where lane f adds feature f's in
// order; the next chunk's values are loaded before the additions.
template <int kF, int kR>
__global__ void __launch_bounds__(kThreads)
    grid_sum_long_kernel(int features, int f0, const uint32_t* __restrict__ vals,
                         const int2* __restrict__ bounds, const float* __restrict__ records,
                         float* __restrict__ table_grad, const int* __restrict__ long_runs,
                         const int* __restrict__ n_long) {
  constexpr int kChunk = 32 * kLongChunk;
  __shared__ float prod[kThreads / 32][kF][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  const int count = *n_long;
  float (&x)[kF][kChunk] = prod[warp];
  for (int r = blockIdx.x * (blockDim.x / 32) + warp; r < count; r += warps) {
    const int e = long_runs[r];
    const int2 b = bounds[e];
    float acc = 0.0f;  // lane f < kF: feature f's sum
    uint32_t v[kLongChunk];
#pragma unroll
    for (int q = 0; q < kLongChunk; ++q) {
      const int j = b.x + 32 * q + lane;
      v[q] = j < b.y ? __ldg(vals + j) : 0u;
    }
    for (int j0 = b.x; j0 < b.y; j0 += kChunk) {
      float y[kLongChunk][kF];
#pragma unroll
      for (int q = 0; q < kLongChunk; ++q) {
        if (j0 + 32 * q + lane < b.y) {
          term<kF, kR>(records, features, f0, v[q], y[q]);
        } else {
#pragma unroll
          for (int f = 0; f < kF; ++f) y[q][f] = 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kLongChunk; ++q) {
        const int j = j0 + kChunk + 32 * q + lane;
        v[q] = j < b.y ? __ldg(vals + j) : 0u;
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kLongChunk; ++q) {
#pragma unroll
        for (int f = 0; f < kF; ++f) x[f][32 * q + lane] = y[q][f];
      }
      __syncwarp();
      const int m = min(kChunk, b.y - j0);
      if (lane < kF) {
        const float* xs = x[lane];
        if (m == kChunk) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i) acc = __fadd_rn(acc, xs[i]);
        } else {
          for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, xs[i]);
        }
      }
    }
    if (lane < kF) table_grad[(size_t)e * features + f0 + lane] = acc;
  }
}

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > 1 << 20 ? 1 << 20 : b));
}

// Checks a ladder: each level's resolution, kind and size (a dense level
// holds (res + 1)^3 entries, a hashed one table_size), and fewer than 2^31
// entries in all. Writes the total; 0 or cudaErrorInvalidValue.
int check_ladder(const int* res, const int* dense, const int* sizes, int n_levels, int features,
                 int n_points, int table_size, int* total) {
  if (n_levels < 1 || features < 1 || n_points < 0 || table_size < 1)
    return (int)cudaErrorInvalidValue;
  long long sum = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (res[l] < 1) return (int)cudaErrorInvalidValue;
    const long long side = (long long)res[l] + 1;
    if (dense[l] ? side * side * side != sizes[l] : sizes[l] != table_size)
      return (int)cudaErrorInvalidValue;
    sum += sizes[l];
    if (sum >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  }
  *total = (int)sum;
  return 0;
}

// The group of levels first ... first + kMaxLevels - 1 (or to the last) of
// a ladder that check_ladder took; tables may be null (the backward).
Levels group(int first, const void* const* tables, const int* res, const int* dense,
             const int* sizes, int n_levels, int features, int n_points, int table_size,
             int total) {
  Levels p{};
  p.first = first;
  p.n_levels = n_levels - first < kMaxLevels ? n_levels - first : kMaxLevels;
  int offset = 0;
  for (int l = 0; l < first; ++l) offset += sizes[l];
  for (int l = 0; l < p.n_levels; ++l) {
    p.table[l] = tables ? static_cast<const float*>(tables[first + l]) : nullptr;
    p.res[l] = res[first + l];
    p.offset[l] = offset;
    if (dense[first + l]) p.dense |= 1u << l;
    offset += sizes[first + l];
  }
  p.hash_mask = (unsigned)(table_size - 1);
  p.all_levels = n_levels;
  p.features = features;
  p.n_points = n_points;
  p.total = total;
  return p;
}

int groups_of(int n_levels) { return (n_levels + kMaxLevels - 1) / kMaxLevels; }

using Sort = cub::DeviceRadixSort;

constexpr size_t kAlign = 256;  // bytes: each scratch section starts on a multiple

size_t aligned(size_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

// The backward's scratch, one buffer carved into sections, in this order:
// keys and vals 2 * m uint32 each (m = n_levels * n_points * 8: the sort's
// double buffers), records n_levels * n_points * record_floats(features)
// floats, bounds 2 * total int32, long_runs m / (kShortRun + 1) + 1 int32,
// n_long one int32, then CUB's own scratch for the sort of m pairs on
// key_bits bits. Returns false on shapes the backward does not take.
struct Layout {
  size_t keys, vals, records, bounds, long_runs, n_long, sort, sort_bytes, total;
};

bool layout(int n_levels, int features, int n_points, int total, int key_bits, Layout& out) {
  const long long m = 8ll * n_levels * n_points;
  if (n_levels < 1 || features < 1 || n_points < 0 || total < 1 ||
      m >= (1ll << 31) || key_bits < 1 || key_bits > 31 || (1ll << key_bits) < total)
    return false;
  size_t sort_bytes = 0;
  cub::DoubleBuffer<uint32_t> k(nullptr, nullptr), v(nullptr, nullptr);
  if (Sort::SortPairs(nullptr, sort_bytes, k, v, (int)m, 0, key_bits) != cudaSuccess) return false;
  const size_t sizes[7] = {8 * (size_t)m,
                           8 * (size_t)m,
                           4 * (size_t)n_levels * n_points * record_floats(features),
                           8 * (size_t)total,
                           4 * (size_t)(m / (kShortRun + 1) + 1),
                           4,
                           sort_bytes};
  size_t* at[7] = {&out.keys, &out.vals, &out.records, &out.bounds, &out.long_runs, &out.n_long,
                   &out.sort};
  size_t end = 0;
  for (int i = 0; i < 7; ++i) {
    *at[i] = end;
    end += aligned(sizes[i]);
  }
  out.sort_bytes = sort_bytes;
  out.total = end;
  return true;
}

// One backward's buffers (tinynerf_grid_encode_bwd's).
struct Backward {
  const float* u;
  const float* grad;
  float* table_grad;
  uint32_t* keys;
  uint32_t* vals;
  float* records;
  int2* bounds;
  int* long_runs;
  int* n_long;
  void* sort_scratch;
  size_t sort_bytes;
  int key_bits, sms;
};

// (d) and (e) for features f0 ... f0 + kF - 1 of the sorted values; list:
// (d) lists the long runs.
template <int kF, int kR>
int launch_sums(int total, int features, const Backward& a, const uint32_t* vals, int f0,
                int list, cudaStream_t s) {
  grid_sum_kernel<kF, kR><<<blocks_for(total, kThreads), kThreads, 0, s>>>(
      total, features, f0, list, vals, a.bounds, a.records, a.table_grad, a.long_runs, a.n_long);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grid_sum_long_kernel<kF, kR><<<8 * a.sms, kThreads, 0, s>>>(
      features, f0, vals, a.bounds, a.records, a.table_grad, a.long_runs, a.n_long);
  return (int)cudaGetLastError();
}

// (a) to (e) at F = 2 (kF = 2, kR = 8 its record's floats), or at any
// width with kF = kR = 0 (the sums then a feature at a time). args:
// group()'s arguments.
template <int kF, int kR>
int launch_backward(const int* res, const int* dense, const int* sizes, int n_levels,
                    int features, int n_points, int table_size, int total, Backward a,
                    cudaStream_t s) {
  const long long m = 8ll * n_levels * n_points;
  cudaError_t err;
  for (int first = 0; first < n_levels; first += kMaxLevels) {
    const Levels p = group(first, nullptr, res, dense, sizes, n_levels, features, n_points,
                           table_size, total);
    const unsigned blocks = n_points > 0 ? (unsigned)((n_points + 31) / 32) : 1u;  // no stride
    grid_keys_kernel<kF, kR><<<blocks, dim3(32, kKeyWarps), 0, s>>>(
        p, a.u, a.grad, a.keys, a.vals, a.records, a.bounds, a.n_long);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  cub::DoubleBuffer<uint32_t> dk(a.keys, a.keys + m), dv(a.vals, a.vals + m);
  err = Sort::SortPairs(a.sort_scratch, a.sort_bytes, dk, dv, (int)m, 0, a.key_bits, s);
  if (err != cudaSuccess) return (int)err;
  grid_bounds_kernel<<<blocks_for((m + 3) / 4, kThreads), kThreads, 0, s>>>(
      dk.Current(), (int)m, reinterpret_cast<int*>(a.bounds));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (kF > 0) {
    return launch_sums<kF, kR>(total, features, a, dv.Current(), 0, 1, s);
  } else {
    for (int f0 = 0; f0 < features; ++f0) {
      const int bad = launch_sums<1, 0>(total, features, a, dv.Current(), f0, f0 == 0, s);
      if (bad) return bad;
    }
    return 0;
  }
}

}  // namespace

extern "C" {

// Bytes of the backward's scratch (Layout) for these shapes; -1 on shapes it
// does not take. Launches nothing.
long long tinynerf_grid_bwd_scratch_bytes(int n_levels, int features, int n_points, int total,
                                          int key_bits, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  Layout l;
  return layout(n_levels, features, n_points, total, key_bits, l) ? (long long)l.total : -1;
}

// Launches of one forward (backward = 0) or one backward (1): the forward
// a launch per kMaxLevels levels; the backward the keys as many times, the
// sort (CUB's passes counted as one), the run bounds, then the short and
// the long runs' sums, once at F = 2 and once a feature at any other width.
int tinynerf_grid_launches(int n_levels, int features, int backward) {
  if (!backward) return groups_of(n_levels);
  return groups_of(n_levels) + 2 + 2 * (features == 2 ? 1 : features);
}

// The forward. u (n_points, 3) in [0, 1]; tables[l] the level's (sizes[l],
// features) float32 table (a host array of device pointers); res, dense and
// sizes per level (host arrays); out (n_points, n_levels * features).
// Returns the CUDA error code (0 = ok).
int tinynerf_grid_encode_fwd(const float* u, const void* const* tables, const int* res,
                             const int* dense, const int* sizes, int n_levels, int features,
                             int n_points, int table_size, float* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int total = 0;
  const int bad = check_ladder(res, dense, sizes, n_levels, features, n_points, table_size, &total);
  if (bad) return bad;
  if (n_points == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n_levels; first += kMaxLevels) {
    const Levels p = group(first, tables, res, dense, sizes, n_levels, features, n_points,
                           table_size, total);
    const long long work = (long long)n_points * p.n_levels;  // a thread each, no stride loop
    const unsigned grid = (unsigned)((work + kThreads - 1) / kThreads), block = kThreads;
    if (features == 2) {
      grid_encode_fwd_kernel<2><<<grid, block, 0, s>>>(p, u, out);
    } else {
      grid_encode_fwd_kernel<0><<<grid, block, 0, s>>>(p, u, out);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The backward. grad (n_points, n_levels * features); table_grad (total
// entries, features), every entry written. scratch: scratch_bytes at least
// tinynerf_grid_bwd_scratch_bytes of the same shapes, 256-byte aligned,
// carved here (Layout). key_bits must cover the total entry count. At a
// features width other than 2 the sums, (d) and (e), run a feature at a
// time. Returns the CUDA error code (0 = ok).
int tinynerf_grid_encode_bwd(const float* u, const float* grad, const int* res, const int* dense,
                             const int* sizes, int n_levels, int features, int n_points,
                             int table_size, float* table_grad, void* scratch,
                             long long scratch_bytes, int key_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int total = 0;
  const int bad = check_ladder(res, dense, sizes, n_levels, features, n_points, table_size, &total);
  if (bad) return bad;
  Layout l;
  if (!layout(n_levels, features, n_points, total, key_bits, l) ||
      scratch_bytes < (long long)l.total || reinterpret_cast<uintptr_t>(scratch) % kAlign)
    return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  Backward a{u,
             grad,
             table_grad,
             reinterpret_cast<uint32_t*>(base + l.keys),
             reinterpret_cast<uint32_t*>(base + l.vals),
             reinterpret_cast<float*>(base + l.records),
             reinterpret_cast<int2*>(base + l.bounds),
             reinterpret_cast<int*>(base + l.long_runs),
             reinterpret_cast<int*>(base + l.n_long),
             base + l.sort,
             l.sort_bytes,
             key_bits,
             0};
  if ((err = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (features == 2)
    return launch_backward<2, 8>(res, dense, sizes, n_levels, features, n_points, table_size,
                                 total, a, s);
  return launch_backward<0, 0>(res, dense, sizes, n_levels, features, n_points, table_size, total,
                               a, s);
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
