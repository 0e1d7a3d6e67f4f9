// Fused TinyNeRF render on Hopper (sm_90a): rays -> linspace depths ->
// points -> Fourier encoding -> MLP with skip -> alpha composite.
//
// Replaces the Pallas TPU kernel tinynerf_tpu/kernels/fused_render.py
// (fused_render_rays, body _fused_kernel). The Python wrapper is
// tinynerf_tpu_torch/kernels/fused_render.py.
//
// One block renders a tile of TR rays x S samples (P = TR*S points,
// 128 at the default S=64). The tile's encodings and every MLP
// activation live in dynamic shared memory, in one row per point:
//
//   X[p][0, hidden)                 hidden activations h
//   X[p][hidden, hidden + in_dim)   encoding [x, sin f0, cos f0, ...]
//
// so the skip concat [h, enc] is simply columns [0, hidden + in_dim)
// and no copy is made. The row stride hidden + in_dim is odd (in_dim =
// 3 + 6L), so the rows a warp reads at one column fall in distinct
// banks. Only the (R, 4) composite [r, g, b, acc] is written back to
// device memory.
//
// Products, by the template argument kMma, chosen by configuration in
// the wrapper (k1_uses_tensor_cores), never by a failure. A bf16 launch
// with hidden a multiple of 32 and a tile of at most 128 points sets it:
// the tile is padded to 128 rows and every trunk layer runs on the
// tensor cores (mma_bf16.cuh's mma_dense_relu: mma.sync m16n8k16, f32
// accumulation, hidden/16 warps of 64-row x 32-column tiles) from the
// host-packed B fragments w_mma (kernels/fused_render.py::
// pack_tiny_mma), at mma_fwd_off's offsets. f32 launches, and the bf16
// widths and tiles off that layout, run the CUDA cores' f32 FMAs below,
// the exactness reference: a thread owns an 8-point x 8-output register
// block, holds the whole sum in registers, and writes it back over its
// input only after a barrier; weights are read from global memory (they
// stay in L1/L2). The combined 4-column head runs on the CUDA cores on
// both routes. The shapes whose one-block-a-thread tile would pass 512
// threads or 227 KB (hidden 264, S=192 at hidden 256, S=512) run
// fused_render_general_kernel, chosen by the wrapper (k1_shape): the
// same products taken in rounds of at most 512 threads, and one ray's
// samples in segments that carry the transmittance and the sums, with
// every value the CUDA-core kernel's.
//
// Numerics: depths, points, deltas and the composite are f32, with
// rounded (uncontracted) products where the reference rounds; sin/cos
// are the accurate libdevice versions because arguments reach 2^9 * x
// (never build with --use_fast_math). With bf16 set, every MLP input
// (encoding and hidden activations) is rounded to bf16 where it is
// written; the wrapper rounds the weights. bf16 x bf16 products are
// exact in f32 and the sums accumulate in f32 (on the tensor cores in
// their k-step order).

#include <algorithm>

#include "mma_bf16.cuh"
#include "nerf_mlp.cuh"

namespace {

constexpr int kPointsPerThread = 8;   // MT: rows of a thread's block
constexpr int kOutputsPerThread = 8;  // NT: columns of a thread's block
constexpr int kMaxThreads = 512;

// X[:, 0:hidden) = relu(X[:, in_col:in_col+in_dim) @ W + b) on the CUDA
// cores. W is (in_dim, hidden) row-major. blockDim.x == n_pg * hidden / NT.
__device__ void render_dense_relu(float* X, int ld, int n_pg, int in_col, int in_dim,
                                  int hidden, const float* __restrict__ W,
                                  const float* __restrict__ b, bool bf16) {
  const int n_og = hidden / kOutputsPerThread;
  const int pg = threadIdx.x / n_og;
  const int og = threadIdx.x % n_og;
  const int col0 = og * kOutputsPerThread;

  float acc[kPointsPerThread][kOutputsPerThread];
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kOutputsPerThread; ++j) acc[i][j] = 0.f;

  const float* xin = X + in_col;
  const float* wcol = W + col0;
  for (int k = 0; k < in_dim; ++k) {
    const float4* wp = reinterpret_cast<const float4*>(wcol + (size_t)k * hidden);
    const float4 w0 = __ldg(wp);
    const float4 w1 = __ldg(wp + 1);
    const float w[kOutputsPerThread] = {w0.x, w0.y, w0.z, w0.w,
                                        w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < kPointsPerThread; ++i) {
      const float x = xin[(pg + n_pg * i) * ld + k];
#pragma unroll
      for (int j = 0; j < kOutputsPerThread; ++j)
        acc[i][j] = fmaf(x, w[j], acc[i][j]);
    }
  }
  __syncthreads();  // every read of the input columns is done
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i) {
    float* row = X + (pg + n_pg * i) * ld + col0;
#pragma unroll
    for (int j = 0; j < kOutputsPerThread; ++j) {
      float v = fmaxf(acc[i][j] + __ldg(b + col0 + j), 0.f);
      row[j] = to_compute(v, bf16);
    }
  }
  __syncthreads();
}

// render_dense_relu for any number of 8x8 blocks: the block's threads take
// them in rounds of blockDim.x items, item = pg * n_og + og (thread t of
// round r: item r * blockDim.x + t). blockDim.x is a multiple of n_og, so a
// round holds every column group of its point groups: it reads and
// writes only its own rows, and writes them over its input after the
// round's barrier. Each block's sum is render_dense_relu's, term by term.
__device__ void render_dense_relu_rounds(float* X, int ld, int n_pg, int in_col, int in_dim,
                                         int hidden, const float* __restrict__ W,
                                         const float* __restrict__ b, bool bf16) {
  const int n_og = hidden / kOutputsPerThread;
  const int n_items = n_pg * n_og;
#pragma unroll 1
  for (int item0 = 0; item0 < n_items; item0 += blockDim.x) {
    const int item = item0 + threadIdx.x;
    const bool active = item < n_items;
    const int pg = item / n_og;
    const int col0 = (item % n_og) * kOutputsPerThread;
    float acc[kPointsPerThread][kOutputsPerThread];
#pragma unroll
    for (int i = 0; i < kPointsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kOutputsPerThread; ++j) acc[i][j] = 0.f;
    if (active) {
      const float* xin = X + in_col;
      const float* wcol = W + col0;
      for (int k = 0; k < in_dim; ++k) {
        const float4* wp = reinterpret_cast<const float4*>(wcol + (size_t)k * hidden);
        const float4 w0 = __ldg(wp);
        const float4 w1 = __ldg(wp + 1);
        const float w[kOutputsPerThread] = {w0.x, w0.y, w0.z, w0.w,
                                            w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kPointsPerThread; ++i) {
          const float x = xin[(pg + n_pg * i) * ld + k];
#pragma unroll
          for (int j = 0; j < kOutputsPerThread; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of this round's input rows is done
    if (active) {
#pragma unroll
      for (int i = 0; i < kPointsPerThread; ++i) {
        float* row = X + (pg + n_pg * i) * ld + col0;
#pragma unroll
        for (int j = 0; j < kOutputsPerThread; ++j) {
          float v = fmaxf(acc[i][j] + __ldg(b + col0 + j), 0.f);
          row[j] = to_compute(v, bf16);
        }
      }
    }
    __syncthreads();
  }
}

// Point rows of a tile's buffer: the 8-row blocks' padding on the CUDA
// cores, the 128 rows of mma_dense_relu on the tensor cores.
__host__ __device__ inline int padded_points(int P, bool mma) {
  return mma ? kTilePoints : (P + kPointsPerThread - 1) / kPointsPerThread * kPointsPerThread;
}

// kMma: the trunk on the tensor cores from w_mma (4 bf16 values to a
// uint2); else on the CUDA cores (w_mma unused).
template <bool kMma>
__global__ void __launch_bounds__(kMaxThreads)
fused_render_kernel(const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ weights,
                    const uint2* __restrict__ w_mma,
                    float* __restrict__ out, int tile_rays, int n_samples,
                    int num_freqs, int hidden, int depth, int skip_at,
                    float near, float far, int bf16) {
  extern __shared__ float smem[];
  const int S = n_samples;
  const int P = tile_rays * S;
  const int n_pg = (P + kPointsPerThread - 1) / kPointsPerThread;
  const int p_pad = padded_points(P, kMma);
  const int in_dim = 3 + 6 * num_freqs;
  const int ld = hidden + in_dim;
  float* X = smem;                 // (p_pad, ld)
  float* pts = X + p_pad * ld;     // (P, 3)
  float* head = pts + P * 3;       // (P, 4): rgb logits, raw sigma
  const int ray0 = blockIdx.x * tile_rays;
  const bool use_bf16 = bf16 != 0;

  // Rows past the last point only pad the tile: keep them finite.
  for (int idx = P * ld + threadIdx.x; idx < p_pad * ld; idx += blockDim.x)
    X[idx] = 0.f;

  // Points: z = near*(1-t) + far*t, t = s/(S-1); pt = o + d*z.
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int r = p / S, s = p % S;
    const float t = (float)s / (float)(S - 1);
    const float z = __fadd_rn(__fmul_rn(near, 1.f - t), __fmul_rn(far, t));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int g = (ray0 + r) * 3 + c;
      const float v = __fadd_rn(rays_o[g], __fmul_rn(rays_d[g], z));
      pts[p * 3 + c] = v;
      X[p * ld + hidden + c] = to_compute(v, use_bf16);
    }
  }
  __syncthreads();

  // Encoding in the model's interleaved order: column 3 + 6k + c holds
  // sin(2^k x_c) and column 3 + 6k + 3 + c holds cos(2^k x_c).
  for (int idx = threadIdx.x; idx < P * 3 * num_freqs; idx += blockDim.x) {
    const int p = idx % P, q = idx / P;
    const int k = q / 3, c = q % 3;
    float sn, cs;
    sincosf(ldexpf(pts[p * 3 + c], k), &sn, &cs);
    float* row = X + p * ld + hidden + 3 + 6 * k + c;
    row[0] = to_compute(sn, use_bf16);
    row[3] = to_compute(cs, use_bf16);
  }
  __syncthreads();

  // Trunk: layer 0 reads the encoding, the layer after the skip reads
  // [h, enc], every other layer reads h.
  const float* wp = weights;
  for (int i = 0; i < depth; ++i) {
    const int in_col = (i == 0) ? hidden : 0;
    const int n_in = (i == 0) ? in_dim : (i == skip_at ? ld : hidden);
    if constexpr (kMma) {
      mma_dense_relu<4>(X, ld, in_col, n_in, hidden,
                        w_mma + mma_fwd_off(i, in_dim, hidden, skip_at) / 4, wp + n_in * hidden,
                        nullptr);
    } else {
      render_dense_relu(X, ld, n_pg, in_col, n_in, hidden, wp, wp + n_in * hidden, use_bf16);
    }
    wp += n_in * hidden + hidden;
  }

  // Combined head: W (hidden, 4) with columns r, g, b, sigma; bias (4).
  const float* bh = wp + hidden * 4;
  for (int idx = threadIdx.x; idx < P * 4; idx += blockDim.x) {
    const int p = idx >> 2, c = idx & 3;
    const float* row = X + p * ld;
    float acc = 0.f;
    for (int k = 0; k < hidden; ++k) acc = fmaf(row[k], __ldg(wp + k * 4 + c), acc);
    head[idx] = acc + __ldg(bh + c);
  }
  __syncthreads();

  // Composite: one thread walks one ray's samples front to back, the
  // order of the reference's cumulative product.
  const float base = (far - near) / (float)(S - 1);
  for (int r = threadIdx.x; r < tile_rays; r += blockDim.x) {
    const int g = (ray0 + r) * 3;
    const float dx = rays_d[g], dy = rays_d[g + 1], dz = rays_d[g + 2];
    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz)));
    float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* hd = head + (r * S + s) * 4;
      const float sigma = fmaxf(hd[3], 0.f);
      const float delta = __fmul_rn(s == S - 1 ? kDeltaInf : base, norm);
      const float one_m = expf(-__fmul_rn(sigma, delta)) + kTransEps;
      const float alpha = 1.f - (one_m - kTransEps);
      const float w = __fmul_rn(alpha, trans);
      cr = fmaf(w, 1.f / (1.f + expf(-hd[0])), cr);
      cg = fmaf(w, 1.f / (1.f + expf(-hd[1])), cg);
      cb = fmaf(w, 1.f / (1.f + expf(-hd[2])), cb);
      acc += w;
      trans = __fmul_rn(trans, one_m);
    }
    float4* o = reinterpret_cast<float4*>(out) + ray0 + r;
    *o = make_float4(cr, cg, cb, acc);
  }
}

// The general CUDA-core kernel, for the shapes whose one-round block
// would pass kMaxThreads threads or 227 KB of shared memory (hidden 264,
// S = 192 at hidden 256, S = 512): the products in rounds
// (render_dense_relu_rounds, blockDim.x <= kMaxThreads), and a tile's
// samples in segments of `seg` (seg < S only with one ray a tile): each
// segment's points, encoding, trunk and head in the buffer of `seg`
// points, then the composite carries each ray's transmittance and sums
// in `state` from segment to segment, in the reference's front-to-back
// order. Every value is fused_render_kernel<false>'s, term by term.
__global__ void __launch_bounds__(kMaxThreads)
fused_render_general_kernel(const float* __restrict__ rays_o,
                            const float* __restrict__ rays_d,
                            const float* __restrict__ weights,
                            float* __restrict__ out, int tile_rays, int n_samples, int seg,
                            int num_freqs, int hidden, int depth, int skip_at,
                            float near, float far, int bf16) {
  extern __shared__ float smem[];
  const int S = n_samples;
  const int in_dim = 3 + 6 * num_freqs;
  const int ld = hidden + in_dim;
  const int p_max = padded_points(tile_rays * seg, false);
  float* X = smem;                      // (p_max, ld)
  float* pts = X + p_max * ld;          // (P, 3)
  float* head = pts + tile_rays * seg * 3;  // (P, 4): rgb logits, raw sigma
  float* state = head + tile_rays * seg * 4;  // (tile_rays, 5): trans, r, g, b, acc
  const int ray0 = blockIdx.x * tile_rays;
  const bool use_bf16 = bf16 != 0;
  const float base = (far - near) / (float)(S - 1);

#pragma unroll 1
  for (int s0 = 0; s0 < S; s0 += seg) {
    const int ns = min(seg, S - s0);  // this segment's samples
    const int P = tile_rays * ns;
    const int n_pg = (P + kPointsPerThread - 1) / kPointsPerThread;
    const int p_pad = padded_points(P, false);

    for (int idx = P * ld + threadIdx.x; idx < p_pad * ld; idx += blockDim.x) X[idx] = 0.f;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int r = p / ns, s = s0 + p % ns;
      const float t = (float)s / (float)(S - 1);
      const float z = __fadd_rn(__fmul_rn(near, 1.f - t), __fmul_rn(far, t));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int g = (ray0 + r) * 3 + c;
        const float v = __fadd_rn(rays_o[g], __fmul_rn(rays_d[g], z));
        pts[p * 3 + c] = v;
        X[p * ld + hidden + c] = to_compute(v, use_bf16);
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < P * 3 * num_freqs; idx += blockDim.x) {
      const int p = idx % P, q = idx / P;
      const int k = q / 3, c = q % 3;
      float sn, cs;
      sincosf(ldexpf(pts[p * 3 + c], k), &sn, &cs);
      float* row = X + p * ld + hidden + 3 + 6 * k + c;
      row[0] = to_compute(sn, use_bf16);
      row[3] = to_compute(cs, use_bf16);
    }
    __syncthreads();

    const float* wp = weights;
    for (int i = 0; i < depth; ++i) {
      const int in_col = (i == 0) ? hidden : 0;
      const int n_in = (i == 0) ? in_dim : (i == skip_at ? ld : hidden);
      render_dense_relu_rounds(X, ld, n_pg, in_col, n_in, hidden, wp, wp + n_in * hidden,
                               use_bf16);
      wp += n_in * hidden + hidden;
    }

    const float* bh = wp + hidden * 4;
    for (int idx = threadIdx.x; idx < P * 4; idx += blockDim.x) {
      const int p = idx >> 2, c = idx & 3;
      const float* row = X + p * ld;
      float acc = 0.f;
      for (int k = 0; k < hidden; ++k) acc = fmaf(row[k], __ldg(wp + k * 4 + c), acc);
      head[idx] = acc + __ldg(bh + c);
    }
    __syncthreads();

    for (int r = threadIdx.x; r < tile_rays; r += blockDim.x) {
      const int g = (ray0 + r) * 3;
      const float dx = rays_d[g], dy = rays_d[g + 1], dz = rays_d[g + 2];
      const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                         __fmul_rn(dz, dz)));
      float* st = state + r * 5;
      const bool first = s0 == 0;
      float trans = first ? 1.f : st[0], cr = first ? 0.f : st[1], cg = first ? 0.f : st[2];
      float cb = first ? 0.f : st[3], acc = first ? 0.f : st[4];
      for (int j = 0; j < ns; ++j) {
        const int s = s0 + j;
        const float* hd = head + (r * ns + j) * 4;
        const float sigma = fmaxf(hd[3], 0.f);
        const float delta = __fmul_rn(s == S - 1 ? kDeltaInf : base, norm);
        const float one_m = expf(-__fmul_rn(sigma, delta)) + kTransEps;
        const float alpha = 1.f - (one_m - kTransEps);
        const float w = __fmul_rn(alpha, trans);
        cr = fmaf(w, 1.f / (1.f + expf(-hd[0])), cr);
        cg = fmaf(w, 1.f / (1.f + expf(-hd[1])), cg);
        cb = fmaf(w, 1.f / (1.f + expf(-hd[2])), cb);
        acc += w;
        trans = __fmul_rn(trans, one_m);
      }
      if (s0 + ns == S) {
        reinterpret_cast<float4*>(out)[ray0 + r] = make_float4(cr, cg, cb, acc);
      } else {
        st[0] = trans;
        st[1] = cr;
        st[2] = cg;
        st[3] = cb;
        st[4] = acc;
      }
    }
    __syncthreads();  // the next segment writes pts, X and head anew
  }
}

// The general kernel's block: whole rounds of n_og items, at most
// kMaxThreads threads, no more than the items of a segment.
int general_threads(int P, int hidden) {
  const int n_og = hidden / kOutputsPerThread;
  const int n_pg = (P + kPointsPerThread - 1) / kPointsPerThread;
  return std::min(n_pg, std::max(1, kMaxThreads / n_og)) * n_og;
}

// The tensor-core route's shapes: bf16, whole 32-column warp tiles, a
// tile of at most 128 points, 2 * hidden threads.
bool mma_route_ok(int tile_rays, int n_samples, int hidden, int bf16) {
  return bf16 && hidden > 0 && hidden % 32 == 0 && tile_rays * n_samples <= kTilePoints &&
         2 * hidden <= kMaxThreads;
}

template <bool kMma>
int launch_kernel(const float* rays_o, const float* rays_d, const float* weights,
                  const void* w_mma, float* out, int n_rays, int tile_rays, int n_samples,
                  int num_freqs, int hidden, int depth, int skip_at, float near, float far,
                  int bf16, int smem, int threads, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_render_kernel<kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_render_kernel<kMma><<<n_rays / tile_rays, threads, smem, (cudaStream_t)stream>>>(
      rays_o, rays_d, weights, static_cast<const uint2*>(w_mma), out, tile_rays, n_samples,
      num_freqs, hidden, depth, skip_at, near, far, bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for one tile, in bytes; mma: the
// tensor-core route's 128-row buffer.
int tinynerf_fused_render_smem_bytes(int tile_rays, int n_samples, int num_freqs, int hidden,
                                     int mma) {
  const int P = tile_rays * n_samples;
  const int ld = hidden + 3 + 6 * num_freqs;
  return (padded_points(P, mma != 0) * ld + P * 7) * (int)sizeof(float);
}

// ... and the general kernel's, for segments of `seg` samples: the
// buffer of one segment and each ray's carried state.
int tinynerf_fused_render_general_smem_bytes(int tile_rays, int seg, int num_freqs, int hidden) {
  return tinynerf_fused_render_smem_bytes(tile_rays, seg, num_freqs, hidden, 0) +
         tile_rays * 5 * (int)sizeof(float);
}

// Threads of one block: one per 8x8 block of the (points, hidden) tile
// on the CUDA cores, hidden/16 warps on the tensor cores; the general
// kernel's (general != 0, n_samples its segment) at most kMaxThreads.
int tinynerf_fused_render_threads(int tile_rays, int n_samples, int hidden, int mma,
                                  int general) {
  if (mma) return 2 * hidden;
  const int P = tile_rays * n_samples;
  if (general) return general_threads(P, hidden);
  return (P + kPointsPerThread - 1) / kPointsPerThread * (hidden / kOutputsPerThread);
}

// Launch on `stream`; n_rays must be a multiple of tile_rays. The route
// is the caller's: w_mma set (the packed forward fragments) runs the
// tensor-core kernel, and only a bf16 launch at the shapes mma_route_ok
// takes may set it; else general = 0 runs the CUDA-core kernel, whose
// block must fit kMaxThreads threads and 227 KB, and general = 1 the
// general CUDA-core kernel in segments of `seg` samples (seg == n_samples,
// or seg < n_samples with one ray a tile). hidden must be a multiple of
// 8. Anything else is cudaErrorInvalidValue, no launch. Returns the CUDA
// error code of the attribute call or of the launch (0 = ok).
int tinynerf_fused_render(const float* rays_o, const float* rays_d, const float* weights,
                          const void* w_mma, float* out, int n_rays, int tile_rays,
                          int n_samples, int seg, int general, int num_freqs, int hidden,
                          int depth, int skip_at, float near, float far, int bf16, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mma = w_mma != nullptr;
  if (hidden <= 0 || hidden % 8 != 0 || tile_rays < 1 || n_rays % tile_rays != 0 ||
      (mma && (general || !mma_route_ok(tile_rays, n_samples, hidden, bf16))) ||
      (general ? seg < 1 || seg > n_samples || (seg < n_samples && tile_rays != 1)
               : seg != n_samples))
    return (int)cudaErrorInvalidValue;
  constexpr int kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory per block
  const int smem = general
      ? tinynerf_fused_render_general_smem_bytes(tile_rays, seg, num_freqs, hidden)
      : tinynerf_fused_render_smem_bytes(tile_rays, n_samples, num_freqs, hidden, mma);
  const int threads = tinynerf_fused_render_threads(tile_rays, seg, hidden, mma, general);
  if (smem > kMaxSmem || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (general) {
    err = cudaFuncSetAttribute(fused_render_general_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_render_general_kernel<<<n_rays / tile_rays, threads, smem, (cudaStream_t)stream>>>(
        rays_o, rays_d, weights, out, tile_rays, n_samples, seg, num_freqs, hidden, depth,
        skip_at, near, far, bf16);
    return (int)cudaGetLastError();
  }
  auto launch = mma ? launch_kernel<true> : launch_kernel<false>;
  return launch(rays_o, rays_d, weights, w_mma, out, n_rays, tile_rays, n_samples, num_freqs,
                hidden, depth, skip_at, near, far, bf16, smem, threads, stream);
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
