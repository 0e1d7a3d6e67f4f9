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
// and no copy is made. Each dense layer is a register-tiled product on
// the CUDA cores: a thread owns an 8-point x 8-output block, holds the
// whole sum in registers, and writes it back over its input only after
// a barrier. The row stride hidden + in_dim is odd (in_dim = 3 + 6L),
// so the 8 point rows a warp reads at one k fall in distinct banks.
// Weights are read from global memory (they stay in L1/L2). Only the
// (R, 4) composite [r, g, b, acc] is written back to device memory.
//
// Numerics: depths, points, deltas and the composite are f32, with
// rounded (uncontracted) products where the reference rounds; sin/cos
// are the accurate libdevice versions because arguments reach 2^9 * x
// (never build with --use_fast_math). With bf16 set, every MLP input
// (encoding and hidden activations) is rounded to bf16 where it is
// written; the wrapper rounds the weights. bf16 x bf16 products are
// exact in f32 and the sums accumulate in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPointsPerThread = 8;   // MT: rows of a thread's block
constexpr int kOutputsPerThread = 8;  // NT: columns of a thread's block
constexpr int kMaxThreads = 512;
constexpr float kDeltaInf = 1e10f;
constexpr float kTransEps = 1e-10f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// X[:, 0:hidden) = relu(X[:, in_col:in_col+in_dim) @ W + b).
// W is (in_dim, hidden) row-major. blockDim.x == n_pg * hidden / NT.
__device__ void dense_relu(float* X, int ld, int n_pg, int in_col, int in_dim,
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
      row[j] = bf16 ? round_bf16(v) : v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
fused_render_kernel(const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ weights,
                    float* __restrict__ out, int tile_rays, int n_samples,
                    int num_freqs, int hidden, int depth, int skip_at,
                    float near, float far, int bf16) {
  extern __shared__ float smem[];
  const int S = n_samples;
  const int P = tile_rays * S;
  const int n_pg = (P + kPointsPerThread - 1) / kPointsPerThread;
  const int p_pad = n_pg * kPointsPerThread;
  const int in_dim = 3 + 6 * num_freqs;
  const int ld = hidden + in_dim;
  float* X = smem;                 // (p_pad, ld)
  float* pts = X + p_pad * ld;     // (P, 3)
  float* head = pts + P * 3;       // (P, 4): rgb logits, raw sigma
  const int ray0 = blockIdx.x * tile_rays;
  const bool use_bf16 = bf16 != 0;

  // Rows past the last point only pad the 8-row blocks: keep them finite.
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
      X[p * ld + hidden + c] = use_bf16 ? round_bf16(v) : v;
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
    row[0] = use_bf16 ? round_bf16(sn) : sn;
    row[3] = use_bf16 ? round_bf16(cs) : cs;
  }
  __syncthreads();

  // Trunk: layer 0 reads the encoding, the layer after the skip reads
  // [h, enc], every other layer reads h.
  const float* wp = weights;
  for (int i = 0; i < depth; ++i) {
    const int in_col = (i == 0) ? hidden : 0;
    const int n_in = (i == 0) ? in_dim : (i == skip_at ? ld : hidden);
    dense_relu(X, ld, n_pg, in_col, n_in, hidden, wp, wp + n_in * hidden, use_bf16);
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

}  // namespace

extern "C" {

// Shared memory the kernel needs for one tile, in bytes.
int tinynerf_fused_render_smem_bytes(int tile_rays, int n_samples,
                                     int num_freqs, int hidden) {
  const int P = tile_rays * n_samples;
  const int p_pad = (P + kPointsPerThread - 1) / kPointsPerThread * kPointsPerThread;
  const int ld = hidden + 3 + 6 * num_freqs;
  return (p_pad * ld + P * 7) * (int)sizeof(float);
}

// Threads of one block: one per 8x8 block of the (points, hidden) tile.
int tinynerf_fused_render_threads(int tile_rays, int n_samples, int hidden) {
  const int P = tile_rays * n_samples;
  return (P + kPointsPerThread - 1) / kPointsPerThread * (hidden / kOutputsPerThread);
}

int tinynerf_fused_render_max_threads() { return kMaxThreads; }

// Launch on `stream`; n_rays must be a multiple of tile_rays. Returns
// the CUDA error code of the attribute call or of the launch (0 = ok).
int tinynerf_fused_render(const float* rays_o, const float* rays_d,
                          const float* weights, float* out, int n_rays,
                          int tile_rays, int n_samples, int num_freqs,
                          int hidden, int depth, int skip_at, float near,
                          float far, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = tinynerf_fused_render_smem_bytes(tile_rays, n_samples, num_freqs, hidden);
  err = cudaFuncSetAttribute(fused_render_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = tinynerf_fused_render_threads(tile_rays, n_samples, hidden);
  const int blocks = n_rays / tile_rays;
  fused_render_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays_o, rays_d, weights, out, tile_rays, n_samples, num_freqs, hidden,
      depth, skip_at, near, far, bf16);
  return (int)cudaGetLastError();
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
