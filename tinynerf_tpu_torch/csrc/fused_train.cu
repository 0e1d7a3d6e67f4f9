// Fused TinyNeRF training step on Hopper (sm_90a): stratified jitter ->
// points -> Fourier encoding -> MLP with skip -> composite -> MSE ->
// backward to the PARAMETER gradients, in one launch per step (plus a
// small fixed-order reduction of the per-block partial sums).
//
// Replaces the Pallas TPU kernel tinynerf_tpu/kernels/fused_train.py
// (fused_loss_grads, body _fused_train_kernel, with the per-ray scans of
// tinynerf_tpu/kernels/scans.py). The Python wrapper is
// tinynerf_tpu_torch/kernels/fused_train.py.
//
// What bounds it on an H100: arithmetic. A point costs ~66k
// multiply-adds forward and about as many again for each of the two
// backward products (weight gradients, upstream gradients), against
// ~40 bytes of ray input per point; the unfused step instead moves every
// (points, 191) activation through device memory twice. The kernel keeps
// a tile's encoding, every layer's activations and the gradient of the
// current layer in shared memory.
//
// Products, by the template argument kMma, chosen by configuration in
// the wrapper (k2_uses_tensor_cores), never by a failure. A bf16 launch
// with hidden a multiple of 32 and tiles of exactly 64 points sets it and
// runs the three MLP products of every trunk layer on the tensor cores
// (mma_bf16.cuh: mma.sync m16n8k16, f32 accumulation) from the
// host-packed B fragments w_mma (kernels/fused_render.py::
// pack_tiny_weights: the forward W^T of every layer, then the upstream
// W[:, :hidden] of layers 1..depth-1): the forward as warp tiles of 32
// points x 32 columns (mma_rows) with the bias, ReLU and bf16 epilogue;
// the weight gradients by mma_weight_grad, the bias gradient as its row
// of ones; the upstream products as the forward's warp tiles, masked by
// act_{i-1} and rounded to bf16 where they are written. The skip layer
// reads one segment: with kMma, act_{skip_at-1}'s rows are [act | enc]
// (stride hidden + in_dim) and hold the tile's encoding, so its weight
// gradient emits its bias row once. f32 launches, and the bf16 widths
// and tiles off that layout, run the CUDA cores' f32 FMAs
// (point_product_item, weight_grad_item), the exactness reference. The
// head, the composite, the scans and the jitter are the same code on
// both routes.
//
// Grid: a persistent grid of about one block per SM and scene. Block
// (b, k) trains scene k (blockIdx.y, the scene axis): it walks scene k's
// ray tiles b, b + gridDim.x, ... and accumulates its gradient and loss
// into its own row of `partials` in device memory (first tile writes,
// later tiles add; 132 rows of 66,312 floats stay in the 50 MB L2; a
// row's stride is a multiple of 4 floats, so mma_weight_grad's float2
// accesses stay aligned, and the padding after the loss is skipped). A
// second kernel sums the rows in a fixed order and scatters them to the
// model's parameter order. No atomics: the same seed and inputs give
// bit-identical loss and gradients from launch to launch.
//
// Scenes (multi-scene training: K models trained in lockstep, one launch a
// step for all of them). Scene k's rays, targets and noise are the k-th
// (R, .) slabs, its seed seed[k], its weights the k-th slab of each packed
// buffer (strides checked by the C entry), its partial rows the k-th
// gridDim.x rows, its output the k-th n_grad + 1 floats. Ray indices stay
// scene-local (the jitter's Philox key is (seed[k], ray, sample)) and the
// blocks per scene do not depend on K, so scene k's loss and gradients
// are bit-identical to a one-scene launch with seed[k]. A stack runs
// fused_train_kernel<kMma, true, .>, which first moves the pointers to
// blockIdx.y's scene; a one-scene launch runs <kMma, false, .>, which has
// no scene offsets in it.
//
// Tile: TR rays x S samples, P = TR*S points (64 at S=64). Shared
// memory, row per point (strides odd, so the rows a warp reads at one
// column fall in distinct banks):
//   enc   (P, in_dim)               encoding [x, sin 2^k x, cos 2^k x]
//                                   (kMma with a skip: inside act_{skip_at-1})
//   act_i (P, hidden + 1), i < depth  post-ReLU output of trunk layer i
//   G     (P, hidden + 1)           gradient at the last layer's output
//   per-point and per-ray scalars
// Backward, layer i writes its upstream gradient (w.r.t. act_{i-1})
// into act_i's buffer, which is dead by then: no second buffer.
//
// Memory route, by configuration in the wrapper (k2_fits_shared_memory),
// independent of the products' route. A tile whose carve passes 227 KB
// (hidden 168 or 256, depth 6, S=96 or 128, the 8 x 256 trunk) runs
// fused_train_kernel<., ., true>: the activation stack act_0 .. act_{depth-1},
// G (with kMma and a skip, the encoding inside it) lives in the block's
// slab of a device workspace (gridDim.x x gridDim.y slabs of
// stack_floats), reached through the same generic pointers, so the
// arithmetic and its order are the shared route's: the two routes are
// bit-identical. Shared memory keeps the encoding otherwise and the
// scalars. The route is the kernel's third template argument, kSpill; the
// shared route's instantiations are the code they were before it.
//
// Numerics follow _fused_train_kernel term by term (depth grid
// near + s*h, deltas z_next - z with the 1e10 terminal times ||d||,
// g_one_m = suf/one_m - g_alpha, g_sigma = g_one_m*(-delta*(one_m-eps)),
// ReLU masks from the stored activations). With bf16 set, the encoding,
// the stored activations, the head gradient and each upstream gradient
// are rounded to bf16 and the wrapper rounds the weights; products
// accumulate in f32 and bias gradients are f32 sums of the rounded
// gradients. Depths and points use uncontracted (_rn) arithmetic and
// the accurate sincosf (never build with --use_fast_math).
//
// Jitter: sample_depth, Philox keyed by (seed, ray, sample); it, the
// weight-gradient blocks and the fixed-order reduction are in
// train_common.cuh, shared with the NeRF train kernel K4/K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "mma_bf16.cuh"
#include "nerf_mlp.cuh"
#include "train_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // point rows of a thread's block in point-major products
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB of dynamic shared memory per block

// Per-point scalars, structure of arrays: ps[q * p_pad + p].
enum : int {
  kZ, kDelta, kSigmaRaw, kOneM, kAlpha, kTrans, kRgb0, kRgb1, kRgb2,
  kGAlpha, kSuffix, kGHead0, kGHead1, kGHead2, kGHead3, kNumScalars
};
constexpr int kRayScalars = 5;  // g_comp r, g, b; g_acc; squared residual

// Offset of trunk layer i's W (in, hidden) then b (hidden) in the packed
// forward weights, which is also the layout of the gradient partials.
__host__ __device__ int layer_offset(int i, int in_dim, int hidden, int skip_at) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += (layer_in_dim(j, in_dim, hidden, skip_at) + 1) * hidden;
  return off;
}

enum Epilogue { kRelu, kMaskedGrad };

// One thread block of a point-major product, item = (point group, column
// group): acc[p][o] = sum over the columns k of a then b of in[p][k] *
// W[k][o] (W row-major, row stride n_out), for p = pg + n_pg*i and
// o = col0 + j. kRelu: out = to_compute(relu(acc + bias)). kMaskedGrad:
// out = to_compute(acc) * (mask[p][o] > 0). The point group is the fast
// index, so a warp spans few column groups and the block reads each
// weight row from L1/L2 about once per tile, not once per warp.
template <Epilogue E>
__device__ __forceinline__ void point_product_item(
    int item, Seg a, Seg b, const float* __restrict__ W, int n_out,
    const float* __restrict__ bias, const float* mask, int ld_mask, float* out,
    int ld_out, int p_pad, bool bf16) {
  const int n_pg = p_pad / kRows;
  const int pg = item % n_pg;
  const int col0 = (item / n_pg) * kCols;
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const float* wrow = W + col0;
#pragma unroll 1
  for (int seg = 0; seg < 2; ++seg) {
    const Seg s = seg == 0 ? a : b;
    const float* xin = s.ptr + pg * s.ld;
    const int step = n_pg * s.ld;
    // Unrolled so that the loads of several k are in flight together:
    // with one block of 8 warps per SM, a load per k would stall.
#pragma unroll 4
    for (int k = 0; k < s.n; ++k, wrow += n_out) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wrow) + 1);
      const float w[kCols] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float x = xin[i * step + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = pg + n_pg * i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int o = col0 + j;
      float v;
      if (E == kRelu) {
        v = to_compute(fmaxf(acc[i][j] + __ldg(bias + o), 0.f), bf16);
      } else {
        v = to_compute(acc[i][j], bf16) * (mask[p * ld_mask + o] > 0.f ? 1.f : 0.f);
      }
      out[p * ld_out + o] = v;
    }
  }
}

// The tensor-core products of a 64-point tile (kMma): acc = rows [0, 64)
// of A (its first a.n columns) times the packed B of `hidden` columns, as
// warp tiles of 32 points x 32 columns, hidden / 16 of them taken by the
// block's warps in turn; f(p, c, acc[p][c], acc[p][c + 1]) for each pair
// of neighbouring columns. No barrier.
template <class F>
__device__ __forceinline__ void tile_products(Seg a, const uint2* __restrict__ Bp, int hidden,
                                              F f) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll 1
  for (int tile = warp; tile < hidden / 16; tile += nw) {
    const int m0 = (tile % 2) * 16 * kUpMTiles, nt0 = (tile / 2) * kUpNTiles;
    float acc[kUpMTiles][kUpNTiles][4];
    mma_rows<kUpMTiles, kUpNTiles>(acc, a.ptr, a.ld, m0, a.n, Bp, hidden / 8, nt0);
    for_each_pair(acc, m0, 8 * nt0, f);
  }
}

struct Params {
  const float* rays_o;  // (R, 3)
  const float* rays_d;  // (R, 3)
  const float* target;  // (R, 3)
  const float* noise;   // (R, S) or null
  const int* seed;      // one int32 on the device
  const float* w_fwd;   // per layer W (in, hidden), b; head W (hidden, 4), b
  const float* w_bwd;   // layers 1..depth-1: W[:, :hidden] as (out, in); CUDA cores only
  const uint2* w_mma;   // kMma: the packed B fragments (pack_tiny_weights), 4 bf16 a uint2
  float* partials;      // (gridDim.x, row): n_grad gradient values, the loss, padding
  int n_rays, tile_rays, n_samples, num_freqs, hidden, depth, skip_at, row;
  float near, h_bin, inv_n;
  int randomized, white_bkgd, bf16;
};

// A scene's slab of w_fwd, w_bwd (floats) and w_mma (bf16 values). Its own
// kernel argument: three more fields in Params alone change the one-scene
// kernels' code (ptxas: 224 registers in f32, 196 in bf16, against 168 and
// 210).
struct SceneStrides {
  long long fwd, bwd, mma;
};

// The pointers of scene `sc` (blockIdx.y): every per-scene input, its seed,
// its weights and its own gridDim.x rows of partials. Scene 0 is the
// launch's own pointers.
__device__ __forceinline__ void to_scene(Params& p, const SceneStrides& st, int sc) {
  const size_t r3 = (size_t)sc * p.n_rays * 3;
  p.rays_o += r3;
  p.rays_d += r3;
  p.target += r3;
  if (p.noise != nullptr) p.noise += (size_t)sc * p.n_rays * p.n_samples;
  p.seed += sc;
  p.w_fwd += sc * st.fwd;
  if (p.w_bwd != nullptr) p.w_bwd += sc * st.bwd;
  if (p.w_mma != nullptr) p.w_mma += sc * st.mma / 4;
  p.partials += (size_t)sc * gridDim.x * p.row;
}

// Floats of the activation stack act_0 .. act_{depth-1}, G: with kMma and
// a skip, act_{skip_at-1}'s rows are [act | enc] (the encoding's buffer).
__host__ __device__ inline long long stack_floats(int p_pad, int in_dim, int hidden, int depth,
                                                  bool wide) {
  return (long long)(depth + 1) * p_pad * (hidden + 1) + (wide ? (long long)p_pad * (in_dim - 1) : 0);
}

// kScenes: scene blockIdx.y of a stack; without it the launch's own
// pointers, and the code is the one-scene kernel's with no scene offsets.
// kSpill: the activation stack lives in the block's slab of the device
// workspace `ws` (the spill route, for the tiles whose stack does not fit
// in shared memory; gridDim.x x gridDim.y slabs of stack_floats); shared
// memory keeps the encoding (unless it is inside the stack) and the
// scalars. Without it `ws` is unused and the carve is all shared memory.
template <bool kMma, bool kScenes, bool kSpill>
__global__ void __launch_bounds__(kThreads, 1) fused_train_kernel(Params prm,
                                                                   SceneStrides strides,
                                                                   float* ws) {
  if constexpr (kScenes) to_scene(prm, strides, blockIdx.y);
  extern __shared__ float smem[];
  const int S = prm.n_samples;
  const int TR = prm.tile_rays;
  const int P = TR * S;
  const int p_pad = (P + kRows - 1) / kRows * kRows;
  const int L = prm.num_freqs;
  const int in_dim = 3 + 6 * L;
  const int hidden = prm.hidden;
  const int depth = prm.depth;
  const int skip_at = prm.skip_at;
  const int ld_h = hidden + 1;
  const bool bf16 = prm.bf16 != 0;
  const bool randomized = prm.randomized != 0;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // kMma with a skip: act_{skip_at-1} (stride hidden + in_dim) holds the
  // encoding in its columns [hidden, hidden + in_dim), so the skip layer's
  // input [act, enc] is one row; the encoding has no buffer of its own.
  const bool wide = kMma && skip_at >= 1;
  float* enc = wide ? smem + (skip_at - 1) * p_pad * ld_h + hidden : smem;  // (p_pad, in_dim)
  const int ld_enc = wide ? hidden + in_dim : in_dim;
  float* act = wide ? smem : enc + p_pad * in_dim;  // depth x (p_pad, ld_h)
  if constexpr (kSpill) {
    float* slab = ws + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                           stack_floats(p_pad, in_dim, hidden, depth, wide);
    if (wide) enc = slab + (skip_at - 1) * p_pad * ld_h + hidden;
    act = slab;
  }
  auto LD = [&](int i) { return wide && i == skip_at - 1 ? hidden + in_dim : ld_h; };
  auto A = [&](int i) {
    return act + i * p_pad * ld_h + (wide && i >= skip_at ? p_pad * (in_dim - 1) : 0);
  };
  float* G = A(depth);                           // (p_pad, ld_h)
  // kNumScalars x p_pad; with kSpill after the shared encoding (if any)
  float* ps = kSpill ? (wide ? smem : smem + p_pad * in_dim) : G + p_pad * ld_h;
  float* rs = ps + kNumScalars * p_pad;          // TR x kRayScalars
  auto Q = [&](int q) { return ps + q * p_pad; };

  const int head_off = layer_offset(depth, in_dim, hidden, skip_at);
  const int n_grad = head_off + hidden * 4 + 4;
  float* part = prm.partials + (size_t)blockIdx.x * prm.row;
  // kMma: trunk layer 1's upstream fragments follow every forward's.
  const int mma_up = mma_fwd_off(depth, in_dim, hidden, skip_at);
  const float* wh = prm.w_fwd + head_off;  // (hidden, 4)
  const float* bh = wh + hidden * 4;
  const unsigned int seed = randomized ? (unsigned int)(*prm.seed) : 0u;
  const int n_pg = p_pad / kRows;
  const int n_og = hidden / kCols;

  // Padding rows only fill the last 4-row block (none with kMma, whose
  // tiles are 64 points): keep them finite.
  for (int idx = P * in_dim + tid; idx < p_pad * in_dim; idx += nthr) enc[idx] = 0.f;

  float block_loss = 0.f;  // thread 0 only
  const int n_tiles = prm.n_rays / TR;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int ray0 = tile * TR;

    // 1. depths
    for (int p = tid; p < P; p += nthr)
      Q(kZ)[p] = sample_depth(seed, ray0 + p / S, p % S, S, prm.near, prm.h_bin, randomized);
    __syncthreads();

    // 2. deltas, points, encoding
    for (int p = tid; p < P; p += nthr) {
      const int r = p / S, s = p % S;
      const float* d = prm.rays_d + (ray0 + r) * 3;
      const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                         __fmul_rn(d[2], d[2])));
      const float gap = s == S - 1 ? kDeltaInf : __fsub_rn(Q(kZ)[p + 1], Q(kZ)[p]);
      Q(kDelta)[p] = __fmul_rn(gap, norm);
    }
    for (int idx = tid; idx < P * 3 * (L + 1); idx += nthr) {
      const int p = idx % P, q = idx / P;  // q = 3*k' + c, k' = 0 for x, k' = k+1 for band k
      const int c = q % 3, kk = q / 3;
      const int g = (ray0 + p / S) * 3 + c;
      const float pt = __fadd_rn(prm.rays_o[g], __fmul_rn(prm.rays_d[g], Q(kZ)[p]));
      float* row = enc + p * ld_enc;
      if (kk == 0) {
        row[c] = to_compute(pt, bf16);
      } else {
        float sn, cs;
        sincosf(ldexpf(pt, kk - 1), &sn, &cs);
        row[3 + 6 * (kk - 1) + c] = to_compute(sn, bf16);
        row[3 + 6 * (kk - 1) + 3 + c] = to_compute(cs, bf16);
      }
    }
    __syncthreads();

    // 3. trunk forward: layer 0 reads enc, the skip layer [act, enc].
    for (int i = 0; i < depth; ++i) {
      const int off = layer_offset(i, in_dim, hidden, skip_at);
      const int n_in = layer_in_dim(i, in_dim, hidden, skip_at);
      if constexpr (kMma) {
        const Seg in = i == 0 ? Seg{enc, ld_enc, in_dim} : Seg{A(i - 1), LD(i - 1), n_in};
        const float* b = prm.w_fwd + off + n_in * hidden;
        float* out = A(i);
        const int ld_o = LD(i);
        tile_products(in, prm.w_mma + mma_fwd_off(i, in_dim, hidden, skip_at) / 4, hidden,
                      [&](int p, int c, float v0, float v1) {
          out[p * ld_o + c] = to_compute(fmaxf(v0 + __ldg(b + c), 0.f), true);
          out[p * ld_o + c + 1] = to_compute(fmaxf(v1 + __ldg(b + c + 1), 0.f), true);
        });
        __syncthreads();
        continue;
      }
      const Seg a = i == 0 ? Seg{enc, in_dim, in_dim} : Seg{A(i - 1), ld_h, hidden};
      const Seg b = (i > 0 && i == skip_at) ? Seg{enc, in_dim, in_dim} : Seg{enc, in_dim, 0};
      const float* W = prm.w_fwd + off;
      for (int item = tid; item < n_pg * n_og; item += nthr)
        point_product_item<kRelu>(item, a, b, W, hidden, W + n_in * hidden, nullptr, 0, A(i),
                                  ld_h, p_pad, bf16);
      __syncthreads();
    }

    // 4. head: rgb logits and raw density (+ noise)
    const float* hin = A(depth - 1);
    for (int idx = tid; idx < P * 4; idx += nthr) {
      const int p = idx >> 2, c = idx & 3;
      const float* row = hin + p * ld_h;
      float acc = 0.f;
      for (int k = 0; k < hidden; ++k) acc = fmaf(row[k], __ldg(wh + k * 4 + c), acc);
      acc += __ldg(bh + c);
      if (c < 3) {
        Q(kRgb0 + c)[p] = acc;
      } else {
        if (prm.noise != nullptr) acc += prm.noise[ray0 * S + p];
        Q(kSigmaRaw)[p] = acc;
      }
    }
    __syncthreads();

    // 5. per-point composite terms
    for (int p = tid; p < P; p += nthr) {
      const float sigma = fmaxf(Q(kSigmaRaw)[p], 0.f);
      const float one_m = expf(__fmul_rn(-sigma, Q(kDelta)[p])) + kTransEps;
      Q(kOneM)[p] = one_m;
      Q(kAlpha)[p] = 1.f - (one_m - kTransEps);
#pragma unroll
      for (int c = 0; c < 3; ++c) Q(kRgb0 + c)[p] = 1.f / (1.f + expf(-Q(kRgb0 + c)[p]));
    }
    __syncthreads();

    // 6. per ray, front to back: exclusive transmittance, composite,
    //    residual, loss and the composite's gradient.
    for (int r = tid; r < TR; r += nthr) {
      float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const int p = r * S + s;
        Q(kTrans)[p] = trans;
        const float w = Q(kAlpha)[p] * trans;
        cr += Q(kRgb0)[p] * w;
        cg += Q(kRgb1)[p] * w;
        cb += Q(kRgb2)[p] * w;
        acc += w;
        trans = trans * Q(kOneM)[p];
      }
      if (prm.white_bkgd) {
        cr += 1.f - acc;
        cg += 1.f - acc;
        cb += 1.f - acc;
      }
      const float* t = prm.target + (ray0 + r) * 3;
      const float e0 = cr - t[0], e1 = cg - t[1], e2 = cb - t[2];
      const float two_n = 2.f * prm.inv_n;
      float* ray = rs + r * kRayScalars;
      ray[0] = two_n * e0;
      ray[1] = two_n * e1;
      ray[2] = two_n * e2;
      ray[3] = prm.white_bkgd ? -(ray[0] + ray[1] + ray[2]) : 0.f;
      ray[4] = e0 * e0 + e1 * e1 + e2 * e2;
    }
    __syncthreads();

    // 7. per-point backward terms (thread 0 first adds the tile's loss)
    if (tid == 0) {
      float tl = 0.f;
      for (int r = 0; r < TR; ++r) tl += rs[r * kRayScalars + 4];
      block_loss += tl * prm.inv_n;
    }
    for (int p = tid; p < P; p += nthr) {
      const float* ray = rs + (p / S) * kRayScalars;
      const float alpha = Q(kAlpha)[p], trans = Q(kTrans)[p];
      const float w = alpha * trans;
      float g_w = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = Q(kRgb0 + c)[p];
        g_w += ray[c] * rgb;
        const float g_rgb = ray[c] * w;
        Q(kGHead0 + c)[p] = to_compute(g_rgb * rgb * (1.f - rgb), bf16);
      }
      g_w += ray[3];
      Q(kGAlpha)[p] = g_w * trans;
      Q(kSuffix)[p] = (g_w * alpha) * trans;
    }
    __syncthreads();

    // 8. per ray, back to front: exclusive suffix sum of g_trans * trans
    for (int r = tid; r < TR; r += nthr) {
      float suf = 0.f;
      for (int s = S - 1; s >= 0; --s) {
        const int p = r * S + s;
        const float x = Q(kSuffix)[p];
        Q(kSuffix)[p] = suf;
        suf += x;
      }
    }
    __syncthreads();

    // 9. density gradient, in the reference's order
    for (int p = tid; p < P; p += nthr) {
      const float one_m = Q(kOneM)[p];
      const float g_one_m = Q(kSuffix)[p] / one_m - Q(kGAlpha)[p];
      const float g_sigma = g_one_m * (-Q(kDelta)[p] * (one_m - kTransEps));
      Q(kGHead3)[p] = to_compute(g_sigma * (Q(kSigmaRaw)[p] > 0.f ? 1.f : 0.f), bf16);
    }
    __syncthreads();

    // 10. head backward: weight and bias gradients, and the upstream
    //     gradient masked by the last layer's ReLU, into G.
    {
      const int n_up = p_pad * hidden;
      for (int item = tid; item < hidden + 4 + n_up; item += nthr) {
        if (item < hidden) {
          const int k = item;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          for (int p = 0; p < P; ++p) {
            const float x = hin[p * ld_h + k];
            a0 = fmaf(x, Q(kGHead0)[p], a0);
            a1 = fmaf(x, Q(kGHead1)[p], a1);
            a2 = fmaf(x, Q(kGHead2)[p], a2);
            a3 = fmaf(x, Q(kGHead3)[p], a3);
          }
          float* d = part + head_off + k * 4;
          if (!first) {  // all reads before the stores (see weight_grad_item)
            a0 += d[0];
            a1 += d[1];
            a2 += d[2];
            a3 += d[3];
          }
          d[0] = a0;
          d[1] = a1;
          d[2] = a2;
          d[3] = a3;
        } else if (item < hidden + 4) {
          const int c = item - hidden;
          float a = 0.f;
          for (int p = 0; p < P; ++p) a += Q(kGHead0 + c)[p];
          float* d = part + head_off + hidden * 4 + c;
          *d = first ? a : *d + a;
        } else {
          const int e = item - hidden - 4;
          const int p = e / hidden, k = e % hidden;
          float v = 0.f;
          if (p < P) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(wh) + k);
            v = w.x * Q(kGHead0)[p];
            v = fmaf(w.y, Q(kGHead1)[p], v);
            v = fmaf(w.z, Q(kGHead2)[p], v);
            v = fmaf(w.w, Q(kGHead3)[p], v);
            v = to_compute(v, bf16) * (hin[p * ld_h + k] > 0.f ? 1.f : 0.f);
          }
          G[p * ld_h + k] = v;
        }
      }
    }
    __syncthreads();

    // 11. trunk backward, last layer first. Layer i's output gradient is
    //     in G (i = depth-1) or in act_{i+1}'s buffer; its upstream
    //     gradient, masked by act_{i-1} > 0, goes into act_i's buffer.
    for (int i = depth - 1; i >= 0; --i) {
      const float* g = i == depth - 1 ? G : A(i + 1);
      const int off = layer_offset(i, in_dim, hidden, skip_at);
      const int n_in = layer_in_dim(i, in_dim, hidden, skip_at);
      if constexpr (kMma) {
        // The weight and bias gradients (one segment, one row of ones),
        // and the upstream gradient masked by act_{i-1} into act_i's
        // buffer, which no product of this layer reads.
        const int ld_g = i == depth - 1 ? ld_h : LD(i + 1);
        const Seg in = i == 0 ? Seg{enc, ld_enc, in_dim} : Seg{A(i - 1), LD(i - 1), n_in};
        mma_weight_grad<4>(in, g, ld_g, hidden, part + off, first);
        if (i > 0) {
          float* up = A(i);
          const float* mask = A(i - 1);
          const int ld_u = LD(i), ld_m = LD(i - 1);
          tile_products(Seg{g, ld_g, hidden}, prm.w_mma + (mma_up + (i - 1) * hidden * hidden) / 4,
                        hidden, [&](int p, int k, float v0, float v1) {
            up[p * ld_u + k] = mask[p * ld_m + k] > 0.f ? to_compute(v0, true) : 0.f;
            up[p * ld_u + k + 1] = mask[p * ld_m + k + 1] > 0.f ? to_compute(v1, true) : 0.f;
          });
        }
        __syncthreads();
        continue;
      }
      const Seg a = i == 0 ? Seg{enc, in_dim, in_dim} : Seg{A(i - 1), ld_h, hidden};
      const Seg b = (i > 0 && i == skip_at) ? Seg{enc, in_dim, in_dim} : Seg{enc, in_dim, 0};
      const int items_a = (a.n + kCols - 1) / kCols * n_og;
      const int items_b = (b.n + kCols - 1) / kCols * n_og;
      const int items_up = i > 0 ? n_pg * n_og : 0;
      const float* WT = prm.w_bwd + (size_t)(i > 0 ? i - 1 : 0) * hidden * hidden;
      for (int item = tid; item < items_a + items_b + hidden + items_up; item += nthr) {
        int it = item;
        if (it < items_a) {
          weight_grad_item(it, a, 0, g, ld_h, hidden, P, part + off, first);
          continue;
        }
        it -= items_a;
        if (it < items_b) {
          weight_grad_item(it, b, a.n, g, ld_h, hidden, P, part + off, first);
          continue;
        }
        it -= items_b;
        if (it < hidden) {
          float s = 0.f;
          for (int p = 0; p < P; ++p) s += g[p * ld_h + it];
          float* d = part + off + n_in * hidden + it;
          *d = first ? s : *d + s;
          continue;
        }
        it -= hidden;
        point_product_item<kMaskedGrad>(it, Seg{g, ld_h, hidden}, Seg{g, ld_h, 0}, WT, hidden,
                                        nullptr, A(i - 1), ld_h, A(i), ld_h, p_pad, bf16);
      }
      __syncthreads();
    }
  }
  if (tid == 0) part[n_grad] = block_loss;
}

// Probe: z[ray][s] as K2's own sample_depth draws it, one block per tile
// of `tile_rays` rays (the tile must not change the draws).
__global__ void jitter_probe_kernel(float* z, const int* seed, int tile_rays, int S,
                                    float near, float h_bin) {
  const unsigned int sd = (unsigned int)(*seed);
  const int ray0 = blockIdx.x * tile_rays;
  for (int p = threadIdx.x; p < tile_rays * S; p += blockDim.x) {
    const int ray = ray0 + p / S, s = p % S;
    z[(size_t)ray * S + s] = sample_depth(sd, ray, s, S, near, h_bin, true);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int tinynerf_fused_train_smem_bytes(int tile_rays, int n_samples, int num_freqs, int hidden,
                                    int depth) {
  const int P = tile_rays * n_samples;
  const int p_pad = (P + kRows - 1) / kRows * kRows;
  const int in_dim = 3 + 6 * num_freqs;
  const int floats = p_pad * in_dim + (depth + 1) * p_pad * (hidden + 1) +
                     kNumScalars * p_pad + tile_rays * kRayScalars;
  return floats * (int)sizeof(float);
}

// The spill route: floats of one block's slab of the workspace (the
// activation stack; with kMma (mma != 0) and a skip, the encoding inside
// it), and the shared memory that a spill block keeps (the encoding
// otherwise, the per-point and per-ray scalars), in bytes.
long long tinynerf_fused_train_workspace_floats(int tile_rays, int n_samples, int num_freqs,
                                                int hidden, int depth, int skip_at, int mma) {
  const int P = tile_rays * n_samples;
  const int p_pad = (P + kRows - 1) / kRows * kRows;
  return stack_floats(p_pad, 3 + 6 * num_freqs, hidden, depth, mma && skip_at >= 1);
}

int tinynerf_fused_train_spill_smem_bytes(int tile_rays, int n_samples, int num_freqs,
                                          int skip_at, int mma) {
  const int P = tile_rays * n_samples;
  const int p_pad = (P + kRows - 1) / kRows * kRows;
  const int enc = mma && skip_at >= 1 ? 0 : p_pad * (3 + 6 * num_freqs);
  return (enc + kNumScalars * p_pad + tile_rays * kRayScalars) * (int)sizeof(float);
}

// Launch the step kernel on n_blocks x n_scenes blocks, then the
// reduction. n_rays (a scene's rays) must be a multiple of tile_rays,
// n_blocks <= n_rays / tile_rays, hidden a multiple of 8 (the float4
// weight loads). The memory route is the caller's: spill = 0 keeps the
// whole carve in shared memory (tinynerf_fused_train_smem_bytes, at most
// 227 KB); spill = 1 runs fused_train_kernel<., ., true> with the activation
// stack in `workspace`, n_scenes x n_blocks slabs of
// tinynerf_fused_train_workspace_floats (anything else is
// cudaErrorInvalidValue, no launch). partials is (n_scenes, n_blocks, row),
// row a multiple of 4 and > n_grad; dst has row entries (-1 for the
// padding after the loss). out (n_scenes, n_grad + 1) receives each
// scene's n_grad gradient values in parameter order and its loss last.
// n_scenes is in [1, 65535]. One scene runs fused_train_kernel<kMma,
// false, .> on the pointers as given and reads no stride. More run
// fused_train_kernel<kMma, true, .>: per scene k, rays_o, rays_d, target
// (n_rays, 3) and noise (n_rays, n_samples) at k times their size, seed[k],
// and the k-th slab of each weight buffer: w_fwd at k * fwd_stride floats, w_bwd at k * bwd_stride
// floats, w_mma at k * mma_stride bf16 values. Each stride must be its
// buffer's size rounded up to a multiple of 4 (0 for a null buffer: every
// slab starts 16-byte aligned for the float4 weight loads) and n_grad one
// model's gradient floats; anything else is cudaErrorInvalidValue, no
// launch. The route is the
// caller's: w_mma null runs the CUDA-core kernel (from w_bwd); w_mma set
// (the packed fragments) runs the tensor-core kernel, and only a bf16
// launch with hidden a multiple of 32 and 64-point tiles may set it (else
// cudaErrorInvalidValue, no launch). Returns the CUDA error code of the
// first failing call (0 = ok).
int tinynerf_fused_train(const float* rays_o, const float* rays_d, const float* target,
                         const float* noise, const int* seed, const float* w_fwd,
                         const float* w_bwd, const void* w_mma, float* partials, const int* dst,
                         float* out, int n_rays, int tile_rays, int n_samples, int num_freqs,
                         int hidden, int depth, int skip_at, float near, float h_bin, float inv_n,
                         int randomized, int white_bkgd, int bf16, int n_blocks, int n_grad,
                         int row, int n_scenes, long long fwd_stride, long long bwd_stride,
                         long long mma_stride, int spill, float* workspace, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool mma = w_mma != nullptr;
  if (row <= n_grad || row % 4 != 0 || n_scenes < 1 || n_scenes > 65535 || hidden <= 0 ||
      hidden % 8 != 0 || (spill != 0) != (workspace != nullptr) ||
      (mma && (!bf16 || hidden <= 0 || hidden % 32 != 0 ||
               tile_rays * n_samples != kMmaChunkPoints)))
    return (int)cudaErrorInvalidValue;
  const bool scenes = n_scenes > 1;
  if (scenes) {  // each scene's slab of the packed weights: exactly one buffer's size
    const int in_dim = 3 + 6 * num_freqs;
    const long long want_bwd = (long long)(depth > 1 ? depth - 1 : 1) * hidden * hidden;
    const long long want_mma =
        mma_fwd_off(depth, in_dim, hidden, skip_at) + (long long)(depth - 1) * hidden * hidden;
    auto slab = [](long long n) { return (n + 3) / 4 * 4; };
    if (n_grad != layer_offset(depth, in_dim, hidden, skip_at) + hidden * 4 + 4 ||
        fwd_stride != slab(n_grad) || bwd_stride != (w_bwd != nullptr ? slab(want_bwd) : 0) ||
        mma_stride != (mma ? slab(want_mma) : 0))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = spill ? tinynerf_fused_train_spill_smem_bytes(tile_rays, n_samples, num_freqs,
                                                                 skip_at, mma)
                         : tinynerf_fused_train_smem_bytes(tile_rays, n_samples, num_freqs,
                                                           hidden, depth);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  Params prm{rays_o, rays_d, target, noise, seed, w_fwd, w_bwd,
             static_cast<const uint2*>(w_mma), partials,
             n_rays, tile_rays, n_samples, num_freqs, hidden, depth, skip_at, row,
             near, h_bin, inv_n, randomized, white_bkgd, bf16};
  decltype(&fused_train_kernel<false, false, false>) kernel;
  if (spill)
    kernel = scenes ? (mma ? fused_train_kernel<true, true, true>
                           : fused_train_kernel<false, true, true>)
                    : (mma ? fused_train_kernel<true, false, true>
                           : fused_train_kernel<false, false, true>);
  else
    kernel = scenes ? (mma ? fused_train_kernel<true, true, false>
                           : fused_train_kernel<false, true, false>)
                    : (mma ? fused_train_kernel<true, false, false>
                           : fused_train_kernel<false, false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(n_blocks, n_scenes), kThreads, smem, st>>>(
      prm, SceneStrides{fwd_stride, bwd_stride, mma_stride}, workspace);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<dim3((row + 255) / 256, n_scenes), 256, 0, st>>>(
      partials, n_blocks, row, dst, out, n_grad + 1);
  return (int)cudaGetLastError();
}

// The jitter probe: z (n_rays, n_samples) from K2's device function.
int tinynerf_fused_train_jitter(float* z, const int* seed, int n_rays, int tile_rays,
                                int n_samples, float near, float h_bin, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  jitter_probe_kernel<<<n_rays / tile_rays, 256, 0, (cudaStream_t)stream>>>(
      z, seed, tile_rays, n_samples, near, h_bin);
  return (int)cudaGetLastError();
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
