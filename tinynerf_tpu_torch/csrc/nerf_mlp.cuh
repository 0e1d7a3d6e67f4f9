// Device code shared by the full-NeRF kernels: the render kernel K3/K5
// (fused_nerf.cu) and the train kernel K4/K6 (fused_nerf_train.cu) run
// the same chunked MLP forward, so the two compute equal per-point values
// from equal inputs. The TinyNeRF kernels K1 and K2 take its constants
// and to_compute (through mma_bf16.cuh).
//
// A chunk is kTilePoints point rows of one shared buffer X with an odd
// row stride ld (the rows a warp reads at one column fall in distinct
// banks):
//   X[p][0, hidden)               hidden activations h (then rgb_in's out)
//   X[p][hidden, hidden + E)      encoding [x, sin 2^k x, cos 2^k x]
// so the skip concat [h, enc] is columns [0, hidden + E). After the
// trunk the (dead) encoding columns take the ray's direction encoding,
// and rgb_in's input [h, d_enc] is columns [0, hidden + Dd).
//
// Numerics: sin/cos are the accurate libdevice versions because their
// arguments reach 2^9 * x (never build with --use_fast_math). With bf16
// set, every MLP input is rounded to bf16 where it is written; products
// are exact in f32 and the sums accumulate in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTilePoints = 128;  // point rows of one forward chunk
constexpr int kCols = 8;          // columns of a thread's register block
constexpr float kDeltaInf = 1e10f;
constexpr float kTransEps = 1e-10f;

__device__ __forceinline__ float to_compute(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__host__ __device__ inline int enc_dim(int L) { return 3 + 6 * L; }
__host__ __device__ inline int dir_dim(int Ld, int use) { return use ? 3 + 6 * Ld : 0; }

// Row stride of X: hidden + the wider of the two encodings (at least
// rgb_hidden, rgb_in's output), made odd.
__host__ __device__ inline int row_stride(int hidden, int L, int Ld, int use, int rgb_hidden) {
  const int e = enc_dim(L), dd = dir_dim(Ld, use);
  const int ld = hidden + (e > dd ? e : dd);
  return (ld > rgb_hidden ? ld : rgb_hidden) | 1;
}

// Threads of a NeRF kernel's block: one per 8-row x 8-column register
// block of the widest (128, n) product, 2 * max(hidden, rgb_hidden).
// The CUDA-core products take any hidden and rgb_hidden that are
// multiples of 8 (the wrappers zero-pad other widths).
__host__ __device__ inline int block_threads(int hidden, int rgb_hidden) {
  return 2 * (hidden > rgb_hidden ? hidden : rgb_hidden);
}

constexpr int kMaxBlockThreads = 512;  // every NeRF kernel's launch bound

// Threads of a general kernel's block (K3-K7 past one round): the
// one-round count capped at kMaxBlockThreads; the products then take
// their items in rounds (dense_relu_rounds and its tensor-core twins).
__host__ __device__ inline int nerf_general_threads(int hidden, int rgb_hidden) {
  const int t = block_threads(hidden, rgb_hidden);
  return t < kMaxBlockThreads ? t : kMaxBlockThreads;
}

// The widest width a general kernel takes: a round holds at least one
// point group's max(hidden, rgb_hidden) / kCols items.
constexpr int kMaxGeneralWidth = kCols * kMaxBlockThreads;

// Points of a general kernel's segment buffers: tile_rays * seg rounded up
// to whole kTilePoints chunks (the last chunk's rows past the segment are
// computed from the origin and masked).
__host__ __device__ inline int chunk_points(int n) {
  return (n + kTilePoints - 1) / kTilePoints * kTilePoints;
}

// One block's slab of X on the general kernels' spill route (X in device
// memory): kTilePoints rows of ld floats, rounded up to 128 bytes.
__host__ __device__ inline long long spill_floats(int ld) {
  return ((long long)kTilePoints * ld + 31) / 32 * 32;
}

// X[p][0, n_out) = to_compute(relu(X[p][in_col, in_col + n_in) @ W + b))
// for the PT rows. W is (n_in, n_out) row-major, n_out a multiple of
// kCols. Item = (point group pg, column group): rows pg + n_pg*i, columns
// col0 + j; thread t takes item t, and the threads past the
// (PT / MT) * (n_out / kCols) items idle (blockDim.x must cover them).
// The point group is the fast thread index, so the block reads each
// weight row about once per chunk. Each thread holds its whole block in
// registers, so the output is written over the input after a barrier.
// kStore also writes the output rows to `store` (row stride n_out) in
// device memory.
template <int PT, int MT, bool kStore = false>
__device__ void dense_relu(float* X, int ld, int in_col, int n_in, int n_out,
                           const float* __restrict__ W, const float* __restrict__ b, bool bf16,
                           float* __restrict__ store = nullptr) {
  constexpr int n_pg = PT / MT;
  const int pg = threadIdx.x % n_pg;
  const int col0 = (threadIdx.x / n_pg) * kCols;
  const bool active = col0 < n_out;

  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const float* xin = X + pg * ld + in_col;
  const float* wrow = W + col0;
  if (active) {
#pragma unroll 2
    for (int k = 0; k < n_in; ++k, wrow += n_out) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wrow) + 1);
      const float w[kCols] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float x = xin[i * n_pg * ld + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every read of the input columns is done
  if (active) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float* row = X + (pg + n_pg * i) * ld + col0;
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        v[j] = to_compute(fmaxf(acc[i][j] + __ldg(b + col0 + j), 0.f), bf16);
        row[j] = v[j];
      }
      if (kStore) {
        float4* dst = reinterpret_cast<float4*>(store + (size_t)(pg + n_pg * i) * n_out + col0);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
  __syncthreads();
}

// dense_relu at any n_out (a multiple of kCols): the fewest rows a thread
// (MT) with which the block's threads cover the (PT, n_out) output once.
// With blockDim.x >= 2 * n_out (block_threads) and PT = 128, MT = 8
// always fits. rgb_in's forward takes it: its widths need not divide
// hidden's.
template <int PT, bool kStore = false>
__device__ void dense_relu_fit(float* X, int ld, int in_col, int n_in, int n_out,
                               const float* __restrict__ W, const float* __restrict__ b, bool bf16,
                               float* __restrict__ store = nullptr) {
  const int groups = n_out / kCols, nt = blockDim.x;
  if (PT * groups <= nt)
    dense_relu<PT, 1, kStore>(X, ld, in_col, n_in, n_out, W, b, bf16, store);
  else if (PT / 2 * groups <= nt)
    dense_relu<PT, 2, kStore>(X, ld, in_col, n_in, n_out, W, b, bf16, store);
  else if (PT / 4 * groups <= nt)
    dense_relu<PT, 4, kStore>(X, ld, in_col, n_in, n_out, W, b, bf16, store);
  else
    dense_relu<PT, 8, kStore>(X, ld, in_col, n_in, n_out, W, b, bf16, store);
}

// dense_relu for the general kernels (blocks of at most kMaxBlockThreads, fewer
// than the (PT / 8) * (n_out / kCols) items of one round): the items are
// taken in rounds of whole point groups, item = pg * n_og + og with the
// column group the fast index, so a round of blockDim.x / n_og point
// groups reads and then overwrites only its own rows (a barrier between
// its reads and its writes). Each output's sum is dense_relu's, term by
// term (k in order from 0, fmaf), so the values are bit-identical to it.
// kStore writes every row as dense_relu does. blockDim.x >= n_out / kCols.
template <bool kStore = false>
__device__ void dense_relu_rounds(float* X, int ld, int in_col, int n_in, int n_out,
                                  const float* __restrict__ W, const float* __restrict__ b,
                                  bool bf16, float* __restrict__ store = nullptr) {
  constexpr int MT = 8, n_pg = kTilePoints / MT;
  const int n_og = n_out / kCols, per = blockDim.x / n_og;
  const int col0 = (threadIdx.x % n_og) * kCols;
#pragma unroll 1
  for (int pg0 = 0; pg0 < n_pg; pg0 += per) {
    const int pg = pg0 + threadIdx.x / n_og;
    const bool active = (int)threadIdx.x < per * n_og && pg < n_pg;
    float acc[MT][kCols];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    if (active) {
      const float* xin = X + pg * ld + in_col;
      const float* wrow = W + col0;
#pragma unroll 2
      for (int k = 0; k < n_in; ++k, wrow += n_out) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wrow) + 1);
        const float w[kCols] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float x = xin[i * n_pg * ld + k];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of this round's rows is done
    if (active) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float* row = X + (pg + n_pg * i) * ld + col0;
        float v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          v[j] = to_compute(fmaxf(acc[i][j] + __ldg(b + col0 + j), 0.f), bf16);
          row[j] = v[j];
        }
        if (kStore) {
          float4* dst = reinterpret_cast<float4*>(store + (size_t)(pg + n_pg * i) * n_out + col0);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
    __syncthreads();
  }
}

// The tensor-core kernels' sigma head (K3/K5 and the training walk alike,
// so they compute equal densities): lane j of 4 neighbouring lanes sums
// row[k] * w[k] over k = j, j + 4, ... < n, and two shuffles give each of
// the four the whole sum. Whole warps call it; lanes with valid false add 0.
__device__ __forceinline__ float quad_dot(const float* row, const float* __restrict__ w, int n,
                                          int j, bool valid) {
  float acc = 0.f;
  if (valid)
    for (int k = j; k < n; k += 4) acc = fmaf(row[k], __ldg(w + k), acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

__device__ __forceinline__ float ray_norm(const float* d) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                         __fmul_rn(d[2], d[2])));
}

// Column j of the direction encoding of d / norm, in the model's order.
__device__ __forceinline__ float dir_enc_value(const float* d, float norm, int j) {
  if (j < 3) return d[j] / norm;
  const int q = j - 3, k = q / 6, c = q % 3;
  float sn, cs;
  sincosf(ldexpf(d[c] / norm, k), &sn, &cs);
  return (q % 6) < 3 ? sn : cs;
}

// The encoding's bands in the model's interleaved order for the PT rows
// of pts (PT, 3): column col + 3 + 6k + c is sin(2^k x_c), column
// col + 3 + 6k + 3 + c is cos(2^k x_c). No barrier.
template <int PT>
__device__ __forceinline__ void encode_bands(float* X, int ld, int col, const float* pts,
                                             int num_freqs, bool bf16) {
  for (int idx = threadIdx.x; idx < PT * 3 * num_freqs; idx += blockDim.x) {
    const int p = idx % PT, q = idx / PT;
    const int k = q / 3, c = q % 3;
    float sn, cs;
    sincosf(ldexpf(pts[p * 3 + c], k), &sn, &cs);
    float* row = X + p * ld + col + 3 + 6 * k + c;
    row[0] = to_compute(sn, bf16);
    row[3] = to_compute(cs, bf16);
  }
}

}  // namespace
