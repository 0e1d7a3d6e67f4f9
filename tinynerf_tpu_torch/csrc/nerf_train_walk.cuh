// The NeRF-MLP training walk shared by the train kernels K4/K6
// (fused_nerf_train.cu) and the block-partials pair K7 (fused_partials.cu):
// one block walks ray tiles; per tile it runs the forward of each segment
// of `seg` samples (rays -> points -> encoding -> trunk with skip -> sigma
// head -> view-direction branch -> rgb head), composites front to back,
// then walks the segments back to front and runs the backward to the
// PARAMETER gradients. The template argument says what a launch does:
//
//   Walk::kLoss         K4 and K6: forward, composite, MSE against the
//                       target, backward; writes the loss and gradients.
//   Walk::kPartialsFwd  K7's forward: forward and composite only; writes
//                       the shard's partials C(3), A, T, D per ray, each
//                       segment's entry transmittance and optionally the
//                       block-local weights. No workspace, no backward.
//   Walk::kPartialsBwd  K7's backward: takes the per-ray cotangents of the
//                       partials (and optionally of the local weights)
//                       and the forward's entry transmittances, walks the
//                       segments back to front rematerialising each one's
//                       forward, and writes the gradients.
//
// Products. The second template argument, kMma, is the launch's route,
// chosen by configuration (launch_walk_by_route): every bf16 launch of K4,
// K6 and K7 (forward and backward) at the widths the tensor-core products
// take sets it and runs the three MLP products (forward, weight gradients,
// upstream gradients) on the tensor cores through mma.sync (mma_bf16.cuh,
// weights packed by kernels/fused_nerf_train.py::pack_mma_weights), with
// the bias gradients as rows of ones of the weight gradients; every f32
// launch, and bf16 at other widths (hidden 48), leaves it unset and runs
// the CUDA-core products described below, f32 being the exactness
// reference. With kMma the sigma head sums
// over four lanes a point, the backward reloads the workspace with float4
// loads, and a walk that rematerialises its segments (K6) stores no
// activations in its first forward walk (the reverse walk recomputes
// them); K4's one segment stores them in its only forward walk, and K7's
// backward rematerialises from the same products its forward ran.

// Design. The forward of a segment (TR rays x `seg` samples, a whole
// number of 128-point chunks; the general walk below lifts this and the
// thread count) is K3's: nerf_mlp.cuh's dense_relu over one
// 128-row shared buffer, 2*max(hidden, rgb_hidden) threads of 8x8
// register blocks (rgb_in's rows per thread fit its width). The backward
// needs every trunk layer's post-activation, 8 x 256 x 128 floats
// (1 MB) a chunk, more than a block's 227 KB of shared memory, so the
// forward also writes each layer's output (the encoding, the trunk
// activations, rgb_in's output) to a per-block workspace in device memory
// and the backward reads them back. Storing is cheaper than recomputing
// where the segment is still in place (K4: one segment of all S samples);
// with several segments (K6, K7) the reverse walk recomputes each
// segment's forward, as the TPU kernels do, which keeps the workspace
// O(seg), not O(S). Each 64-point backward chunk reads and writes the
// block's whole row of partials (2 MB at the flagship): the price of no
// atomics.
//
// The backward runs in chunks of 64 points: the shared buffer holds two
// 64-row halves, a layer's input (In) and its output gradient (G). Per
// layer: the weight-gradient blocks (weight_grad_item, 8x8 per thread,
// summed over the chunk's points and added to the block's own row of
// partials in device memory), then the upstream product (4x8 per thread
// in registers, from G and the layer's transposed weights), a barrier, and
// the masked upstream gradient written over In's activation columns, which
// makes In the next layer's G: the halves swap roles each layer.
//
// Gradient partials: a persistent grid of about one block per SM; block b
// walks the ray tiles b, b + gridDim.x, ... and read-modify-writes only its
// own row (n_grad + 1 floats: every packed weight, then the loss). A
// second kernel sums the rows in a fixed order and scatters them to the
// model's parameter order: no float atomics, bit-identical launches.
//
// Scenes: the grid's second axis (blockIdx.y) is the scene of multi-scene
// training (K4 and K6; K7 launches one). A stack runs
// nerf_walk_scenes_kernel, whose scene_args moves every per-scene pointer
// to scene k's slab: its rays, targets, depths, deltas, noise and outputs,
// its seed seed[k], its weights (strides checked by launch_walk_by_route),
// its blocks' workspace and partial rows. Ray indices stay scene-local and
// the blocks per scene do not depend on K, so scene k's results are
// bit-identical to a one-scene launch. A one-scene launch runs
// nerf_walk_kernel, which has no scene offsets in it.
//
// The general walk (third template argument kGeneral; a shape route chosen
// by configuration, kernels/fused_nerf.py::nerf_shape, and checked again by
// walk_shape_ok) takes every width and segment the one-round walk cannot:
// - past block_threads = 512 (hidden or rgb_hidden past 256) the block
//   keeps 512 threads and each product takes its items in rounds of whole
//   point groups (dense_relu_rounds, upstream_rounds; on the tensor cores
//   mma_dense_relu_rounds and mma_upstream_rounds, whole 64-row or
//   32-point halves a round, so hidden up to 512): a round reads and then
//   overwrites only its own rows, and every output's sum is the one-round
//   product's, bit for bit;
// - a segment of TR x seg points need not fill whole 128-point chunks: the
//   per-point buffers and each workspace layer hold it rounded up to whole
//   chunks (chunk_points), the rows past it encode the origin (finite
//   values) and get zero head gradients, so every backward chunk's G rows
//   there are zero and add exactly nothing to any weight gradient;
// - where X (128 rows of ld floats) does not fit 227 KB beside the rest, X
//   lives in the block's slab of a device buffer (`spill`), reached through
//   the same generic pointers, and the scalars stay in shared memory.
// Forced onto a recipe's shape, both general routes give the one-round
// walk's results bit for bit. The one-round walk's code is kept as it was
// (its ptxas lines too): every change sits behind `if constexpr (kGeneral)`.

// Numerics follow the TPU kernels term by term, with one exact rewrite:
// the composite with one_m = exp(-sigma delta) + 1e-10 and the 1e10
// terminal delta scaled by ||d||; the density gradient by a recurrence on
// differences of g_w instead of the reference's suffix-sum difference,
// which cancels (see segment_grads); the trunk's output gradient is the
// sigma-head plus the rgb-branch contribution; rgb_in's upstream product
// uses its first `hidden` input rows only (the direction encoding gets a
// weight gradient only), and the skip layer's skips the encoding rows;
// ReLU masks come from the stored post-activations. The walk carries the
// running transmittance and the density recurrence from segment to
// segment (where the TPU's streamed kernels scale block-local products),
// so on one union K6 computes K4's per-point values bit for bit and only
// the order in which the gradient partials are summed differs. With bf16
// set every upstream gradient is rounded to bf16 where the reference's
// dense_bwd rounds it, products accumulate in f32, and the composite and
// the recurrences run in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "nerf_mlp.cuh"
#include "train_common.cuh"

namespace {

constexpr int kBwdPoints = 64;  // point rows of one backward chunk
constexpr int kBwdRows = 4;     // MT of the backward upstream products
static_assert(kBwdPoints == kMmaChunkPoints, "the tensor-core weight gradient sums 64 points");

enum class Walk { kLoss, kPartialsFwd, kPartialsBwd };

// Per-point scalars of a segment, structure of arrays: ps[q * n_seg + p].
enum : int {
  kZ, kDelta, kSigmaRaw, kRgb0, kRgb1, kRgb2, kOneM, kTrans, kGW,
  kGRgb0, kGRgb1, kGRgb2, kGSigma, kNumScalars
};
// Per-ray scalars: rs[q * TR + r]. The k*Next values carry the density
// recurrence from the sample after a segment into it (see segment_grads);
// kDepth is K7's D partial, kGT and kGD the cotangents of T and D.
enum : int {
  kGComp0, kGComp1, kGComp2, kGAcc, kTRun, kC0, kC1, kC2, kA, kSqErr,
  kHaveNext, kDNext, kOmNext, kGwNext, kRgbNext0, kRgbNext1, kRgbNext2,
  kDepth, kGT, kGD, kRayScalars
};

struct Args {
  const float* rays_o;  // (R, 3)
  const float* rays_d;  // (R, 3)
  const float* target;  // (R, 3), kLoss only
  const float* z;       // (R, S), or null: the grid, jittered when randomized
  const float* delta;   // (R, S) deltas times ||d||, or null: from the depths
  const float* noise;   // (R, S) pre-ReLU density noise, or null
  const int* seed;      // one int32 on the device: the jitter's key
  const float* w_fwd;   // kernels/fused_nerf.py::pack_nerf_weights
  const float* w_bwd;   // kernels/fused_nerf_train.py::pack_backward_weights
  float* ws;            // (gridDim.x, workspace floats)
  float* partials;      // (gridDim.x, n_grad + 1)
  float* w_out;         // (R, S) per-sample weights, or null
  float* z_out;         // (R, S) the depths used, or null
  int n_rays, n_real, S, seg, tile_rays;
  int num_freqs, dir_freqs, use_viewdirs, hidden, depth, skip_at, rgb_hidden;
  float near, h_bin, inv_n;
  int randomized, white_bkgd, bf16;
  const float* g_ray;   // K7 backward: (R, 6) cotangents of C(3), A, T, D
  const float* g_w;     // K7 backward: (R, S) cotangent of the local weights, or null
  float* tin;           // K7: (R, S / seg) each segment's entry transmittance
  float* out6;          // K7 forward: (R, 6) partials C(3), A, T, D
  const void* w_mma;    // kMma: kernels/fused_nerf_train.py::pack_mma_weights (bf16)
};

// The scene axis of a K4 or K6 launch: the grid's second axis and a
// scene's slab of w_fwd, w_bwd (floats) and w_mma (bf16 values). Kept out
// of Args, so that the one-scene kernels' argument is what it was before
// the axis (more fields in a kernel's argument struct can change its code:
// they did in K2's).
struct WalkScenes {
  int n = 1;
  long long fwd_stride = 0, bwd_stride = 0, mma_stride = 0;
};

// Offset of trunk layer i's W (in, H) then b (H) in the packed weights,
// which is also the layout of the gradient partials.
__host__ __device__ inline int layer_off(int i, int E, int H, int skip_at) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += (layer_in_dim(j, E, H, skip_at) + 1) * H;
  return off;
}

// Packed weights (= gradient floats) of one MLP: trunk (W, b)..., sigma
// (W hidden, b, 3 pad), rgb_in (W (H + Dd, RH), b), rgb (W (RH, 3), b).
__host__ __device__ inline int walk_n_grad(int E, int Dd, int H, int D, int skip_at, int RH) {
  return layer_off(D, E, H, skip_at) + H + 4 + (H + Dd + 1) * RH + RH * 3 + 3;
}

// Workspace floats of one block: every activation of one segment (general:
// of its rows rounded up to whole chunks).
__host__ __device__ inline long long walk_workspace_floats(int tile_rays, int seg, int num_freqs,
                                                           int hidden, int depth, int rgb_hidden,
                                                           bool general = false) {
  const long long n = general ? chunk_points(tile_rays * seg) : (long long)tile_rays * seg;
  return n * (depth * hidden + rgb_hidden + enc_dim(num_freqs));
}

// acc[i][j] = sum over o < n_red of G[p][o] * WT[o][col0 + j], for the
// rows p = pg + n_pg*i of a backward chunk; WT is row-major with rows of
// n_cols (nn.Linear's own (out, in) weight, first n_cols input columns).
__device__ __forceinline__ void upstream_item(const float* G, int ld, int n_red,
                                              const float* __restrict__ WT, int n_cols, int pg,
                                              int col0, float (&acc)[kBwdRows][kCols]) {
  constexpr int n_pg = kBwdPoints / kBwdRows;
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const float* gin = G + pg * ld;
  const float* wrow = WT + col0;
#pragma unroll 4
  for (int o = 0; o < n_red; ++o, wrow += n_cols) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wrow) + 1);
    const float w[kCols] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      const float x = gin[i * n_pg * ld + o];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
    }
  }
}

// upstream_item for the general walk, with its epilogue: the items
// (point group pg, column group) go in rounds of whole point groups
// (item = pg * n_og + og, the column group the fast index), and after each
// round's barrier store(pg, col0, acc) receives the round's sums
// (upstream_item's, bit for bit). A round reads only its own rows of G, so
// the epilogue may write over them. The caller synchronises before the
// first round reads. blockDim.x >= n_cols / kCols.
template <class F>
__device__ __forceinline__ void upstream_rounds(const float* G, int ld, int n_red,
                                                const float* __restrict__ WT, int n_cols, F store) {
  constexpr int n_pg = kBwdPoints / kBwdRows;
  const int n_og = n_cols / kCols, per = blockDim.x / n_og;
  const int col0 = (threadIdx.x % n_og) * kCols;
#pragma unroll 1
  for (int pg0 = 0; pg0 < n_pg; pg0 += per) {
    const int pg = pg0 + threadIdx.x / n_og;
    const bool active = (int)threadIdx.x < per * n_og && pg < n_pg;
    float acc[kBwdRows][kCols];
    if (active) upstream_item(G, ld, n_red, WT, n_cols, pg, col0, acc);
    __syncthreads();  // every read of this round's rows is done
    if (active) store(pg, col0, acc);
    __syncthreads();
  }
}

// rows x n floats from device memory (row stride n, n a multiple of 4,
// 16-byte aligned) into the shared rows of stride ld: float4 loads, several
// in flight per thread. No barrier.
__device__ __forceinline__ void load_rows4(float* dst, int ld, const float* src, int rows, int n) {
  const int n4 = n / 4;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < rows * n4; idx += blockDim.x) {
    const int p = idx / n4, c = (idx - p * n4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + (size_t)p * n + c);
    float* d = dst + p * ld + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

__device__ __forceinline__ void accumulate(float* d, float s, bool first) {
  *d = first ? s : *d + s;
}

// kMma: the three MLP products on the tensor cores (mma_bf16.cuh), bf16 at
// the tensor-core widths; false keeps the CUDA-core products (f32, and bf16
// rounded at run time at other widths). kGeneral: the general walk (see the
// header): products in rounds, a segment ending in a partial chunk, and X
// in the block's slab of `spill` when that is given.
template <Walk kMode, bool kMma = false, bool kGeneral = false>
__device__ __forceinline__ void nerf_walk(const Args& a, float* spill = nullptr) {
  // K7's forward keeps no activations: nothing reads them back.
  constexpr bool kStore = kMode != Walk::kPartialsFwd;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = a.tile_rays, SEG = a.seg, S = a.S, H = a.hidden, D = a.depth;
  const int RH = a.rgb_hidden, L = a.num_freqs;
  const int E = enc_dim(L), Dd = dir_dim(a.dir_freqs, a.use_viewdirs);
  const int ld = row_stride(H, L, a.dir_freqs, a.use_viewdirs, RH);
  const bool bf16 = a.bf16 != 0;
  const int n_seg = TR * SEG;  // points of one segment (one-round walk: whole 128-point chunks)
  // Rows of the per-point buffers and of each workspace layer: n_seg, or
  // in the general walk n_seg rounded up to whole chunks (rows past n_seg
  // hold finite values of the origin and zero gradients).
  const int NP = kGeneral ? chunk_points(n_seg) : n_seg;
  const int NB = S / SEG;
  float* X = smem;                        // (kTilePoints, ld)
  float* pts = X + kTilePoints * ld;      // (kTilePoints, 3)
  if constexpr (kGeneral) {
    if (spill != nullptr) {  // X in the block's slab; the rest stays shared
      X = spill + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * spill_floats(ld);
      pts = smem;
    }
  }
  float* ps = pts + kTilePoints * 3;      // kNumScalars x NP
  float* rs = ps + kNumScalars * NP;      // kRayScalars x TR
  float* denc = rs + kRayScalars * TR;    // (TR, Dd)
  float* tin = denc + TR * Dd;            // (NB, TR): each block's entry T
  auto Q = [&](int q) { return ps + q * NP; };
  auto RS = [&](int q) { return rs + q * TR; };

  // Packed weights (and gradients): trunk (W, b)..., sigma (W hidden, b,
  // 3 pad), rgb_in (W (H + Dd, RH), b), rgb (W (RH, 3), b).
  const int off_sigma = layer_off(D, E, H, a.skip_at);
  const int off_rgb_in = off_sigma + H + 4;
  const int off_rgb = off_rgb_in + (H + Dd + 1) * RH;
  const int n_grad = off_rgb + RH * 3 + 3;
  const float* w_sigma = a.w_fwd + off_sigma;
  const float* w_rgb_in = a.w_fwd + off_rgb_in;
  const float* w_rgb = a.w_fwd + off_rgb;
  // kMma: the packed B fragments, 4 bf16 values to a uint2.
  const uint2* w_mma = static_cast<const uint2*>(a.w_mma);
  const int mma_rgb_in = mma_fwd_off(D, E, H, a.skip_at);
  const int mma_up = mma_rgb_in + pad32(H + Dd) * RH;  // trunk layer 1's upstream
  float* part = kStore ? a.partials + (size_t)blockIdx.x * (n_grad + 1) : nullptr;
  // Workspace: per trunk layer (n_seg, H) post-activations, rgb_in's
  // output (n_seg, RH), the encoding (n_seg, E).
  float* ws = kStore ? a.ws + (size_t)blockIdx.x * NP * (D * H + RH + E) : nullptr;
  float* ws_g1 = kStore ? ws + (size_t)D * NP * H : nullptr;
  float* ws_enc = kStore ? ws_g1 + (size_t)NP * RH : nullptr;
  const bool randomized = a.randomized != 0;
  const unsigned int seed = randomized ? (unsigned int)(*a.seed) : 0u;

  int ray0 = 0;
  bool first = true;       // the block's row of partials is still unwritten
  float block_loss = 0.f;  // thread 0 only

  // Forward of segment b: depths, then per 128-point chunk the points,
  // the encoding, the trunk, the heads. Per-point (sigma_raw, rgb) go to
  // the scalars, every activation (kStore) to the workspace; the
  // tensor-core walk stores only when `keep` (not in K6's first walk,
  // whose activations the reverse walk recomputes).
  auto segment_forward = [&](int b, bool keep) {
    const bool store = kStore && (keep || !kMma);
    const int s0 = b * SEG;
    for (int q = tid; q < n_seg; q += nt) {
      const int g = ray0 + q / SEG, s = s0 + q % SEG;
      const size_t gs = (size_t)g * S + s;
      const float z = a.z != nullptr ? a.z[gs]
                                     : sample_depth(seed, g, s, S, a.near, a.h_bin, randomized);
      Q(kZ)[q] = z;
      if (a.z_out != nullptr) a.z_out[gs] = z;
      if (a.delta != nullptr) Q(kDelta)[q] = a.delta[gs];
    }
    if constexpr (kGeneral) {
      for (int q = n_seg + tid; q < NP; q += nt) Q(kZ)[q] = Q(kDelta)[q] = 0.f;
    }
    __syncthreads();
    if (a.delta == nullptr) {  // one segment of all S samples: z_{s+1} - z_s
      for (int q = tid; q < n_seg; q += nt) {
        const int g = ray0 + q / SEG, s = q % SEG;
        const float dz = s == S - 1 ? kDeltaInf : __fsub_rn(Q(kZ)[q + 1], Q(kZ)[q]);
        Q(kDelta)[q] = __fmul_rn(dz, ray_norm(a.rays_d + (size_t)g * 3));
      }
    }
    for (int c0 = 0; c0 < n_seg; c0 += kTilePoints) {
      for (int p = tid; p < kTilePoints; p += nt) {
        const int q = c0 + p, g = ray0 + q / SEG;
        const float z = Q(kZ)[q];
        if constexpr (kGeneral) {
          // The general walk's rows past the segment take the origin.
          const bool real = q < n_seg;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = real ? __fadd_rn(a.rays_o[(size_t)g * 3 + c],
                                             __fmul_rn(a.rays_d[(size_t)g * 3 + c], z))
                                 : 0.f;
            pts[p * 3 + c] = v;
            X[p * ld + H + c] = to_compute(v, bf16);
          }
          continue;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = __fadd_rn(a.rays_o[(size_t)g * 3 + c],
                                    __fmul_rn(a.rays_d[(size_t)g * 3 + c], z));
          pts[p * 3 + c] = v;
          X[p * ld + H + c] = to_compute(v, bf16);
        }
      }
      __syncthreads();
      encode_bands<kTilePoints>(X, ld, H, pts, L, bf16);
      __syncthreads();
      if (store) {
        for (int idx = tid; idx < kTilePoints * E; idx += nt) {
          const int p = idx / E, j = idx % E;
          ws_enc[(size_t)(c0 + p) * E + j] = X[p * ld + H + j];
        }
      }
      // Trunk: layer 0 reads the encoding, the skip layer [h, enc].
      const float* wp = a.w_fwd;
      for (int i = 0; i < D; ++i) {
        const int n_in = layer_in_dim(i, E, H, a.skip_at);
        if constexpr (kMma && kGeneral) {
          mma_dense_relu_rounds<4>(X, ld, i == 0 ? H : 0, n_in, H,
                                   w_mma + mma_fwd_off(i, E, H, a.skip_at) / 4, wp + n_in * H,
                                   store ? ws + ((size_t)i * NP + c0) * H : nullptr);
        } else if constexpr (kMma) {
          mma_dense_relu<4>(X, ld, i == 0 ? H : 0, n_in, H,
                            w_mma + mma_fwd_off(i, E, H, a.skip_at) / 4, wp + n_in * H,
                            store ? ws + ((size_t)i * NP + c0) * H : nullptr);
        } else if constexpr (kGeneral) {
          dense_relu_rounds<kStore>(X, ld, i == 0 ? H : 0, n_in, H, wp, wp + n_in * H, bf16,
                                    kStore ? ws + ((size_t)i * NP + c0) * H : nullptr);
        } else {
          dense_relu<kTilePoints, 8, kStore>(X, ld, i == 0 ? H : 0, n_in, H, wp, wp + n_in * H,
                                             bf16, kStore ? ws + ((size_t)i * NP + c0) * H
                                                          : nullptr);
        }
        wp += (n_in + 1) * H;
      }
      // Raw density (+ noise) from the trunk; then the direction encoding
      // goes over the dead encoding columns.
      if constexpr (kMma) {
        // 4 neighbouring lanes a point, each over every 4th column, summed
        // by shuffles; whole warps run every round.
        for (int base = 0; base < 4 * kTilePoints; base += nt) {
          const int idx = base + tid, p = idx >> 2, q = idx & 3;
          const bool valid = idx < 4 * kTilePoints;
          float acc = quad_dot(X + p * ld, w_sigma, H, q, valid);
          if (valid && q == 0) {
            acc += __ldg(w_sigma + H);
            const int qp = c0 + p;
            if constexpr (kGeneral) {
              if (a.noise != nullptr && qp < n_seg)
                acc += a.noise[(size_t)(ray0 + qp / SEG) * S + s0 + qp % SEG];
            } else {
              if (a.noise != nullptr) acc += a.noise[(size_t)(ray0 + qp / SEG) * S + s0 + qp % SEG];
            }
            Q(kSigmaRaw)[qp] = acc;
          }
        }
      } else {
        for (int p = tid; p < kTilePoints; p += nt) {
          const float* row = X + p * ld;
          float acc = 0.f;
          for (int k = 0; k < H; ++k) acc = fmaf(row[k], __ldg(w_sigma + k), acc);
          acc += __ldg(w_sigma + H);
          const int q = c0 + p;
          if constexpr (kGeneral) {
            if (a.noise != nullptr && q < n_seg)
              acc += a.noise[(size_t)(ray0 + q / SEG) * S + s0 + q % SEG];
          } else {
            if (a.noise != nullptr) acc += a.noise[(size_t)(ray0 + q / SEG) * S + s0 + q % SEG];
          }
          Q(kSigmaRaw)[q] = acc;
        }
      }
      for (int idx = tid; idx < kTilePoints * Dd; idx += nt) {
        const int p = idx / Dd, j = idx % Dd;
        if constexpr (kGeneral) {  // rows past the segment: ray 0's
          const int r = (c0 + p) / SEG;
          X[p * ld + H + j] = denc[(r < TR ? r : 0) * Dd + j];
        } else {
          X[p * ld + H + j] = denc[((c0 + p) / SEG) * Dd + j];
        }
      }
      __syncthreads();
      const float* b_in = w_rgb_in + (H + Dd) * RH;
      float* st = kStore ? ws_g1 + (size_t)c0 * RH : nullptr;
      if constexpr (kMma && kGeneral) {
        const uint2* wm = w_mma + mma_rgb_in / 4;
        float* sm = store ? st : nullptr;
        switch (4 * RH / H) {
          case 1: mma_dense_relu_rounds<1>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
          case 2: mma_dense_relu_rounds<2>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
          default: mma_dense_relu_rounds<4>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
        }
      } else if constexpr (kMma) {
        // 2 warps over the rows, H / 32 over rgb_in's columns, 8 NT each.
        const uint2* wm = w_mma + mma_rgb_in / 4;
        float* sm = store ? st : nullptr;
        switch (4 * RH / H) {
          case 1: mma_dense_relu<1>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
          case 2: mma_dense_relu<2>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
          default: mma_dense_relu<4>(X, ld, 0, H + Dd, RH, wm, b_in, sm); break;
        }
      } else if constexpr (kGeneral) {
        dense_relu_rounds<kStore>(X, ld, 0, H + Dd, RH, w_rgb_in, b_in, bf16, st);
      } else {
        dense_relu_fit<kTilePoints, kStore>(X, ld, 0, H + Dd, RH, w_rgb_in, b_in, bf16, st);
      }
      const float* b_rgb = w_rgb + RH * 3;
      for (int idx = tid; idx < kTilePoints * 3; idx += nt) {
        const int p = idx / 3, c = idx % 3;
        const float* row = X + p * ld;
        float acc = 0.f;
        for (int k = 0; k < RH; ++k) acc = fmaf(row[k], __ldg(w_rgb + k * 3 + c), acc);
        Q(kRgb0 + c)[c0 + p] = 1.f / (1.f + expf(-(acc + __ldg(b_rgb + c))));
      }
      __syncthreads();
    }
  };

  // Composite of segment b: thread r walks ray r's samples in order with
  // the ray's running transmittance (the exclusive product of one_m over
  // all earlier samples, continued from segment to segment), and stashes
  // its value at the segment's entry. K7's forward also sums w * z.
  auto segment_composite = [&](int b) {
    for (int r = tid; r < TR; r += nt) {
      const int g = ray0 + r;
      float trans = RS(kTRun)[r];
      float cr = RS(kC0)[r], cg = RS(kC1)[r], cb = RS(kC2)[r], acc = RS(kA)[r];
      float dep = RS(kDepth)[r];
      tin[b * TR + r] = trans;
      for (int sl = 0; sl < SEG; ++sl) {
        const int q = r * SEG + sl;
        const float one_m =
            expf(-__fmul_rn(fmaxf(Q(kSigmaRaw)[q], 0.f), Q(kDelta)[q])) + kTransEps;
        const float alpha = 1.f - (one_m - kTransEps);
        const float w = __fmul_rn(alpha, trans);
        cr = fmaf(w, Q(kRgb0)[q], cr);
        cg = fmaf(w, Q(kRgb1)[q], cg);
        cb = fmaf(w, Q(kRgb2)[q], cb);
        acc += w;
        if constexpr (kMode == Walk::kPartialsFwd) dep = fmaf(w, Q(kZ)[q], dep);
        if (a.w_out != nullptr) a.w_out[(size_t)g * S + b * SEG + sl] = w;
        trans = __fmul_rn(trans, one_m);
      }
      RS(kTRun)[r] = trans;
      RS(kC0)[r] = cr;
      RS(kC1)[r] = cg;
      RS(kC2)[r] = cb;
      RS(kA)[r] = acc;
      RS(kDepth)[r] = dep;
    }
    __syncthreads();
  };

  // Residual, loss and the composite's gradient per ray; padding rays
  // (g >= n_real) get none.
  auto ray_loss = [&]() {
    for (int r = tid; r < TR; r += nt) {
      const int g = ray0 + r;
      const bool real = g < a.n_real;
      const float bg = a.white_bkgd ? 1.f - RS(kA)[r] : 0.f;
      float e[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        e[c] = real ? (RS(kC0 + c)[r] + bg) - a.target[(size_t)g * 3 + c] : 0.f;
      const float two_n = 2.f * a.inv_n;
#pragma unroll
      for (int c = 0; c < 3; ++c) RS(kGComp0 + c)[r] = two_n * e[c];
      RS(kGAcc)[r] = a.white_bkgd ? -(two_n * e[0] + two_n * e[1] + two_n * e[2]) : 0.f;
      RS(kSqErr)[r] = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    }
    __syncthreads();
    if (tid == 0) {
      float tl = 0.f;
      for (int r = 0; r < TR; ++r) tl += RS(kSqErr)[r];
      block_loss += tl * a.inv_n;
    }
  };

  // K7's forward result per ray: the partials and the entry transmittances.
  auto write_partials = [&]() {
    for (int r = tid; r < TR; r += nt) {
      const int g = ray0 + r;
      float* o = a.out6 + (size_t)g * 6;
      o[0] = RS(kC0)[r];
      o[1] = RS(kC1)[r];
      o[2] = RS(kC2)[r];
      o[3] = RS(kA)[r];
      o[4] = RS(kTRun)[r];
      o[5] = RS(kDepth)[r];
      for (int b = 0; b < NB; ++b) a.tin[(size_t)g * NB + b] = tin[b * TR + r];
    }
    __syncthreads();
  };

  // K7's backward inputs per ray: the partials' cotangents (zero for the
  // padding rays) and the forward's entry transmittances.
  auto ray_cotangents = [&]() {
    for (int r = tid; r < TR; r += nt) {
      const int g = ray0 + r;
      const float* gr = a.g_ray + (size_t)g * 6;
      RS(kGComp0)[r] = gr[0];
      RS(kGComp1)[r] = gr[1];
      RS(kGComp2)[r] = gr[2];
      RS(kGAcc)[r] = gr[3];
      RS(kGT)[r] = gr[4];
      RS(kGD)[r] = gr[5];
      for (int b = 0; b < NB; ++b) tin[b * TR + r] = a.tin[(size_t)g * NB + b];
    }
    __syncthreads();
  };

  // Per-point head gradients of segment b. Front to back, from the
  // stashed entry transmittance: the weights, the rgb gradients and
  //   g_w_i = sum_c g_comp_c rgb_c,i + g_acc (+ g_D z_i + g_w,ext_i for K7).
  // Back to front, the density gradient by the recurrence
  //   D_i = (g_w_{i+1} - g_w_i) + eps g_w_{i+1} + one_m_{i+1} D_{i+1},
  //   D_{S-1} = g_T - g_w_{S-1},   g_one_m_i = trans_i D_i,
  // where g_T is the cotangent of the pass's transmittance (0 for the
  // loss: the composite closes), continued across segments through the
  // k*Next carries. g_w_{i+1} - g_w_i is formed from its parts,
  // sum_c g_comp_c (rgb_c,i+1 - rgb_c,i) (+ g_D (z_i+1 - z_i) + the
  // difference of g_w,ext), so the constant g_acc cancels exactly. It is
  // the reference's suf_i / one_m_i - g_alpha_i rewritten exactly (alpha +
  // one_m = 1 + eps; the seed g_T * T of the reference's suffix sum is
  // g_T here): that form subtracts two terms of size g_w * trans whose
  // difference is tiny where the colour barely changes along the ray, and
  // at the flagship's 192-sample union its rounding reached 2e-3 of the
  // sigma head's gradient; the differences here are nearly exact in f32.
  // The products and the recurrence run in the order of one segment of all
  // S samples, so the streamed K6 computes K4's per-point values.
  auto segment_grads = [&](int b) {
    for (int r = tid; r < TR; r += nt) {
      const int g = ray0 + r;
      const float gc[3] = {RS(kGComp0)[r], RS(kGComp1)[r], RS(kGComp2)[r]};
      const float g_acc = RS(kGAcc)[r];
      const float g_dep = kMode == Walk::kPartialsBwd ? RS(kGD)[r] : 0.f;
      const float* gwe = kMode == Walk::kPartialsBwd && a.g_w != nullptr
                             ? a.g_w + (size_t)g * S + b * SEG : nullptr;
      float trans = tin[b * TR + r];
      for (int sl = 0; sl < SEG; ++sl) {
        const int q = r * SEG + sl;
        const float one_m =
            expf(-__fmul_rn(fmaxf(Q(kSigmaRaw)[q], 0.f), Q(kDelta)[q])) + kTransEps;
        const float alpha = 1.f - (one_m - kTransEps);
        const float w = __fmul_rn(alpha, trans);
        float g_w = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float rgb = Q(kRgb0 + c)[q];
          g_w += gc[c] * rgb;
          Q(kGRgb0 + c)[q] = to_compute(gc[c] * w * rgb * (1.f - rgb), bf16);
        }
        g_w += g_acc;
        if constexpr (kMode == Walk::kPartialsBwd) {
          g_w = fmaf(g_dep, Q(kZ)[q], g_w);
          if (gwe != nullptr) g_w += gwe[sl];
        }
        Q(kOneM)[q] = one_m;
        Q(kTrans)[q] = trans;
        Q(kGW)[q] = g_w;
        trans = __fmul_rn(trans, one_m);
      }
      bool have = RS(kHaveNext)[r] != 0.f;
      float d_next = RS(kDNext)[r], om_next = RS(kOmNext)[r], gw_next = RS(kGwNext)[r];
      float rn[3] = {RS(kRgbNext0)[r], RS(kRgbNext1)[r], RS(kRgbNext2)[r]};
      for (int sl = SEG - 1; sl >= 0; --sl) {
        const int q = r * SEG + sl;
        const float rgb[3] = {Q(kRgb0)[q], Q(kRgb1)[q], Q(kRgb2)[q]};
        const float one_m = Q(kOneM)[q], g_w = Q(kGW)[q];
        float d = -g_w;
        if constexpr (kMode == Walk::kPartialsBwd) {
          if (!have) d = RS(kGT)[r] - g_w;
        }
        if (have) {
          float dgw = gc[0] * (rn[0] - rgb[0]);
          dgw = fmaf(gc[1], rn[1] - rgb[1], dgw);
          dgw = fmaf(gc[2], rn[2] - rgb[2], dgw);
          if constexpr (kMode == Walk::kPartialsBwd) {
            // The next sample's depth and g_w,ext, from device memory
            // (it may lie in the segment after this one).
            const size_t gs = (size_t)g * S + b * SEG + sl;
            dgw = fmaf(g_dep, a.z[gs + 1] - Q(kZ)[q], dgw);
            if (gwe != nullptr) dgw += a.g_w[gs + 1] - gwe[sl];
          }
          d = dgw + fmaf(kTransEps, gw_next, om_next * d_next);
        }
        const float g_sigma = (Q(kTrans)[q] * d) * (-Q(kDelta)[q] * (one_m - kTransEps));
        Q(kGSigma)[q] = to_compute(Q(kSigmaRaw)[q] > 0.f ? g_sigma : 0.f, bf16);
        have = true;
        d_next = d;
        om_next = one_m;
        gw_next = g_w;
#pragma unroll
        for (int c = 0; c < 3; ++c) rn[c] = rgb[c];
      }
      RS(kHaveNext)[r] = 1.f;
      RS(kDNext)[r] = d_next;
      RS(kOmNext)[r] = om_next;
      RS(kGwNext)[r] = gw_next;
#pragma unroll
      for (int c = 0; c < 3; ++c) RS(kRgbNext0 + c)[r] = rn[c];
    }
    if constexpr (kGeneral) {
      // The rows past the segment add nothing: zero head gradients, so every
      // backward chunk's G rows there are zero (their inputs are finite).
      for (int q = n_seg + tid; q < NP; q += nt)
        Q(kGRgb0)[q] = Q(kGRgb1)[q] = Q(kGRgb2)[q] = Q(kGSigma)[q] = 0.f;
    }
    __syncthreads();
  };

  // Backward of the segment in 64-point chunks, from the head gradients
  // and the workspace to the partials.
  auto segment_backward = [&]() {
    constexpr int n_pg = kBwdPoints / kBwdRows;
    // The thread's upstream block. The upstream products' output is (64,
    // H): threads past its 2 * H blocks (block_threads, when rgb_hidden >
    // hidden) compute block 0 again and write nothing; a branch around the
    // product instead made ptxas spill far more of the walk's registers.
    const int pg = tid % n_pg, up_col = (tid / n_pg) * kCols;
    const bool up_active = up_col < H;
    const int col0 = up_active ? up_col : 0;
    float acc[kBwdRows][kCols];
    for (int c0 = 0; c0 < n_seg; c0 += kBwdPoints) {
      float* In = X;                     // a layer's input
      float* G = X + kBwdPoints * ld;    // a layer's output gradient
      const float* gr[3] = {Q(kGRgb0) + c0, Q(kGRgb1) + c0, Q(kGRgb2) + c0};
      const float* gs = Q(kGSigma) + c0;

      // 1. In = [h_trunk, d_enc] (rgb_in's input), G = rgb_in's output.
      if constexpr (kMma) {
        load_rows4(In, ld, ws + ((size_t)(D - 1) * NP + c0) * H, kBwdPoints, H);
        load_rows4(G, ld, ws_g1 + (size_t)c0 * RH, kBwdPoints, RH);
      } else {
        for (int idx = tid; idx < kBwdPoints * H; idx += nt) {
          const int p = idx / H, k = idx % H;
          In[p * ld + k] = ws[((size_t)(D - 1) * NP + c0 + p) * H + k];
        }
      }
      for (int idx = tid; idx < kBwdPoints * Dd; idx += nt) {
        const int p = idx / Dd, j = idx % Dd;
        if constexpr (kGeneral) {
          const int r = (c0 + p) / SEG;
          In[p * ld + H + j] = denc[(r < TR ? r : 0) * Dd + j];
        } else {
          In[p * ld + H + j] = denc[((c0 + p) / SEG) * Dd + j];
        }
      }
      if constexpr (!kMma) {
        for (int idx = tid; idx < kBwdPoints * RH; idx += nt) {
          const int p = idx / RH, k = idx % RH;
          G[p * ld + k] = ws_g1[(size_t)(c0 + p) * RH + k];
        }
      }
      __syncthreads();

      // 2. rgb and sigma heads: weight and bias gradients.
      for (int item = tid; item < RH * 3 + 3 + H + 1; item += nt) {
        float s = 0.f;
        if (item < RH * 3) {
          const int k = item / 3, c = item % 3;
          for (int p = 0; p < kBwdPoints; ++p) s = fmaf(G[p * ld + k], gr[c][p], s);
          accumulate(part + off_rgb + item, s, first);
        } else if (item < RH * 3 + 3) {
          const int c = item - RH * 3;
          for (int p = 0; p < kBwdPoints; ++p) s += gr[c][p];
          accumulate(part + off_rgb + item, s, first);
        } else if (item < RH * 3 + 3 + H) {
          const int k = item - RH * 3 - 3;
          for (int p = 0; p < kBwdPoints; ++p) s = fmaf(In[p * ld + k], gs[p], s);
          accumulate(part + off_sigma + k, s, first);
        } else {
          for (int p = 0; p < kBwdPoints; ++p) s += gs[p];
          accumulate(part + off_sigma + H, s, first);
        }
      }
      __syncthreads();

      // 3. rgb_in's output gradient, masked by its ReLU, in place.
      for (int idx = tid; idx < kBwdPoints * RH; idx += nt) {
        const int p = idx / RH, k = idx % RH;
        float v = gr[0][p] * __ldg(w_rgb + k * 3);
        v = fmaf(gr[1][p], __ldg(w_rgb + k * 3 + 1), v);
        v = fmaf(gr[2][p], __ldg(w_rgb + k * 3 + 2), v);
        float* x = G + p * ld + k;
        *x = *x > 0.f ? to_compute(v, bf16) : 0.f;
      }
      __syncthreads();

      // 4. rgb_in: weight and bias gradients; the trunk's output gradient
      //    (rgb branch + sigma head, masked by the trunk's ReLU) into G.
      if constexpr (kMma) {
        const Seg in{In, ld, H + Dd};  // and the bias gradient as a row of ones
        switch (RH % 32 == 0 ? 4 : RH % 16 == 0 ? 2 : 1) {
          case 4: mma_weight_grad<4>(in, G, ld, RH, part + off_rgb_in, first); break;
          case 2: mma_weight_grad<2>(in, G, ld, RH, part + off_rgb_in, first); break;
          default: mma_weight_grad<1>(in, G, ld, RH, part + off_rgb_in, first); break;
        }
        auto trunk_grad = [&](int p, int k, float v0, float v1) {
          const float v[2] = {v0, v1};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float g_sig = to_compute(__ldg(w_sigma + k + c) * gs[p], true);
            const float x = to_compute(to_compute(v[c], true) + g_sig, true);
            G[p * ld + k + c] = In[p * ld + k + c] > 0.f ? x : 0.f;
          }
        };
        const uint2* w_up = w_mma + (mma_up + (D - 1) * H * H) / 4;
        if constexpr (kGeneral) {
          mma_upstream_rounds(G, ld, RH, w_up, H, trunk_grad);
        } else {
          float up[kUpMTiles][kUpNTiles][4];
          const int n0 = mma_upstream(up, G, ld, RH, w_up, H);
          __syncthreads();
          for_each_pair(up, ((tid >> 5) % 2) * 16 * kUpMTiles, n0, trunk_grad);
          __syncthreads();
        }
      } else {
        const int items_w = (H + Dd + kCols - 1) / kCols * (RH / kCols);
        for (int item = tid; item < items_w + RH; item += nt) {
          if (item < items_w) {
            weight_grad_item(item, Seg{In, ld, H + Dd}, 0, G, ld, RH, kBwdPoints,
                             part + off_rgb_in, first);
          } else {
            const int o = item - items_w;
            float s = 0.f;
            for (int p = 0; p < kBwdPoints; ++p) s += G[p * ld + o];
            accumulate(part + off_rgb_in + (H + Dd) * RH + o, s, first);
          }
        }
        if constexpr (kGeneral) {
          upstream_rounds(G, ld, RH, a.w_bwd + (size_t)(D - 1) * H * H, H,
                          [&](int pg, int col0, const float (&acc)[kBwdRows][kCols]) {
#pragma unroll
            for (int i = 0; i < kBwdRows; ++i) {
              const int p = pg + n_pg * i;
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                const int k = col0 + j;
                const float g_sig = to_compute(__ldg(w_sigma + k) * gs[p], bf16);
                const float v = to_compute(to_compute(acc[i][j], bf16) + g_sig, bf16);
                G[p * ld + k] = In[p * ld + k] > 0.f ? v : 0.f;
              }
            }
          });
        } else {
          upstream_item(G, ld, RH, a.w_bwd + (size_t)(D - 1) * H * H, H, pg, col0, acc);
          __syncthreads();
          if (up_active) {
#pragma unroll
            for (int i = 0; i < kBwdRows; ++i) {
              const int p = pg + n_pg * i;
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                const int k = col0 + j;
                const float g_sig = to_compute(__ldg(w_sigma + k) * gs[p], bf16);
                const float v = to_compute(to_compute(acc[i][j], bf16) + g_sig, bf16);
                G[p * ld + k] = In[p * ld + k] > 0.f ? v : 0.f;
              }
            }
          }
          __syncthreads();
        }
      }

      // 5. Trunk, last layer first: G holds layer i's (masked) output
      //    gradient; In receives layer i's input, then the upstream
      //    gradient over its activation columns, and the halves swap.
      for (int i = D - 1; i >= 0; --i) {
        if (i > 0) {
          if constexpr (kMma) {
            load_rows4(In, ld, ws + ((size_t)(i - 1) * NP + c0) * H, kBwdPoints, H);
          } else {
            for (int idx = tid; idx < kBwdPoints * H; idx += nt) {
              const int p = idx / H, k = idx % H;
              In[p * ld + k] = ws[((size_t)(i - 1) * NP + c0 + p) * H + k];
            }
          }
        }
        if (i == 0 || i == a.skip_at) {
          for (int idx = tid; idx < kBwdPoints * E; idx += nt) {
            const int p = idx / E, j = idx % E;
            In[p * ld + H + j] = ws_enc[(size_t)(c0 + p) * E + j];
          }
        }
        __syncthreads();
        const int off = layer_off(i, E, H, a.skip_at);
        const int n_in = layer_in_dim(i, E, H, a.skip_at);
        if constexpr (kMma) {
          // One segment (the skip layer's [h, enc] are In's columns [0, H +
          // E)); the bias gradient is its row of ones.
          mma_weight_grad<4>(i == 0 ? Seg{In + H, ld, E} : Seg{In, ld, n_in}, G, ld, H,
                             part + off, first);
          if (i > 0) {
            auto masked = [&](int p, int k, float v0, float v1) {
              float* x = In + p * ld + k;
              x[0] = x[0] > 0.f ? to_compute(v0, true) : 0.f;
              x[1] = x[1] > 0.f ? to_compute(v1, true) : 0.f;
            };
            const uint2* w_up = w_mma + (mma_up + (i - 1) * H * H) / 4;
            if constexpr (kGeneral) {
              mma_upstream_rounds(G, ld, H, w_up, H, masked);
            } else {
              float up[kUpMTiles][kUpNTiles][4];
              const int n0 = mma_upstream(up, G, ld, H, w_up, H);
              __syncthreads();
              for_each_pair(up, ((tid >> 5) % 2) * 16 * kUpMTiles, n0, masked);
            }
            float* t = In;
            In = G;
            G = t;
          }
          __syncthreads();
          continue;
        }
        const Seg sa = i == 0 ? Seg{In + H, ld, E} : Seg{In, ld, H};
        const Seg sb = (i > 0 && i == a.skip_at) ? Seg{In + H, ld, E} : Seg{In, ld, 0};
        const int n_og = H / kCols;
        const int items_a = (sa.n + kCols - 1) / kCols * n_og;
        const int items_b = (sb.n + kCols - 1) / kCols * n_og;
        for (int item = tid; item < items_a + items_b + H; item += nt) {
          if (item < items_a) {
            weight_grad_item(item, sa, 0, G, ld, H, kBwdPoints, part + off, first);
          } else if (item < items_a + items_b) {
            weight_grad_item(item - items_a, sb, sa.n, G, ld, H, kBwdPoints, part + off, first);
          } else {
            const int o = item - items_a - items_b;
            float s = 0.f;
            for (int p = 0; p < kBwdPoints; ++p) s += G[p * ld + o];
            accumulate(part + off + n_in * H + o, s, first);
          }
        }
        if (i > 0) {
          if constexpr (kGeneral) {
            upstream_rounds(G, ld, H, a.w_bwd + (size_t)(i - 1) * H * H, H,
                            [&](int pg, int col0, const float (&acc)[kBwdRows][kCols]) {
#pragma unroll
              for (int ii = 0; ii < kBwdRows; ++ii) {
                float* row = In + (pg + n_pg * ii) * ld + col0;
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                  row[j] = row[j] > 0.f ? to_compute(acc[ii][j], bf16) : 0.f;
              }
            });
          } else {
            upstream_item(G, ld, H, a.w_bwd + (size_t)(i - 1) * H * H, H, pg, col0, acc);
            __syncthreads();
            if (up_active) {
#pragma unroll
              for (int ii = 0; ii < kBwdRows; ++ii) {
                float* row = In + (pg + n_pg * ii) * ld + col0;
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                  row[j] = row[j] > 0.f ? to_compute(acc[ii][j], bf16) : 0.f;
              }
            }
          }
          float* t = In;
          In = G;
          G = t;
        }
        __syncthreads();
      }
      first = false;
    }
  };

  const int n_tiles = a.n_rays / TR;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    ray0 = tile * TR;
    for (int idx = tid; idx < TR * Dd; idx += nt) {
      const int r = idx / Dd, j = idx % Dd;
      const float* d = a.rays_d + (size_t)(ray0 + r) * 3;
      denc[idx] = to_compute(dir_enc_value(d, ray_norm(d), j), bf16);
    }
    for (int r = tid; r < TR; r += nt) {
      RS(kTRun)[r] = 1.f;
      RS(kC0)[r] = RS(kC1)[r] = RS(kC2)[r] = RS(kA)[r] = RS(kHaveNext)[r] = RS(kDepth)[r] = 0.f;
    }
    __syncthreads();
    if constexpr (kMode == Walk::kPartialsBwd) {
      ray_cotangents();
    } else {
      for (int b = 0; b < NB; ++b) {
        segment_forward(b, NB == 1);
        segment_composite(b);
      }
    }
    if constexpr (kMode == Walk::kPartialsFwd) {
      write_partials();
    } else {
      if constexpr (kMode == Walk::kLoss) ray_loss();
      for (int b = NB - 1; b >= 0; --b) {
        // The backward rematerialises each segment; K4's one segment is
        // still in place.
        if (kMode == Walk::kPartialsBwd || NB > 1) segment_forward(b, true);
        segment_grads(b);
        segment_backward();
      }
    }
  }
  if constexpr (kStore) {
    if (tid == 0) part[n_grad] = block_loss;
  }
}

// Scene sc's arguments (see the header): every per-scene pointer moved to
// its slab; null pointers stay null. Scene 0 is the launch's own. kGeneral:
// the general walk's workspace rows (whole chunks).
template <bool kGeneral = false>
__device__ __forceinline__ Args scene_args(Args a, const WalkScenes& st, int sc) {
  const size_t r3 = (size_t)sc * a.n_rays * 3, rs = (size_t)sc * a.n_rays * a.S;
  a.rays_o += r3;
  a.rays_d += r3;
  if (a.target != nullptr) a.target += r3;
  if (a.z != nullptr) a.z += rs;
  if (a.delta != nullptr) a.delta += rs;
  if (a.noise != nullptr) a.noise += rs;
  if (a.w_out != nullptr) a.w_out += rs;
  if (a.z_out != nullptr) a.z_out += rs;
  if (a.seed != nullptr) a.seed += sc;
  a.w_fwd += sc * st.fwd_stride;
  if (a.w_bwd != nullptr) a.w_bwd += sc * st.bwd_stride;
  if (a.w_mma != nullptr)
    a.w_mma = static_cast<const __nv_bfloat16*>(a.w_mma) + sc * st.mma_stride;
  const int E = enc_dim(a.num_freqs), Dd = dir_dim(a.dir_freqs, a.use_viewdirs);
  if (a.ws != nullptr)
    a.ws += (size_t)sc * gridDim.x *
            walk_workspace_floats(a.tile_rays, a.seg, a.num_freqs, a.hidden, a.depth,
                                  a.rgb_hidden, kGeneral);
  if (a.partials != nullptr)
    a.partials += (size_t)sc * gridDim.x *
                  (walk_n_grad(E, Dd, a.hidden, a.depth, a.skip_at, a.rgb_hidden) + 1);
  return a;
}

// One scene (every K7 launch, and K4 and K6 on one scene): the launch's
// own pointers. kGeneral: the general walk; `spill` its X slabs, or null
// (X in shared memory; always null without kGeneral).
template <Walk kMode, bool kMma, bool kGeneral>
__global__ void __launch_bounds__(kMaxBlockThreads, 1) nerf_walk_kernel(Args a, float* spill) {
  nerf_walk<kMode, kMma, kGeneral>(a, spill);
}

// Scene blockIdx.y of a stack (K4 and K6). A kernel of its own, so that a
// one-scene launch runs nerf_walk with no scene offsets in it.
template <Walk kMode, bool kMma, bool kGeneral>
__global__ void __launch_bounds__(kMaxBlockThreads, 1) nerf_walk_scenes_kernel(Args a,
                                                                        WalkScenes st,
                                                                        float* spill) {
  nerf_walk<kMode, kMma, kGeneral>(scene_args<kGeneral>(a, st, blockIdx.y), spill);
}

// Shared memory of one block, in bytes, for tile_rays rays and segments
// of `seg` samples out of n_samples: X and the points, the per-point and
// per-ray scalars, the direction encodings, the entry transmittances.
// general: the general walk's per-point rows (whole chunks); spill: X in
// device memory (spill_floats(ld) a block) instead.
inline int walk_smem_bytes(int tile_rays, int seg, int n_samples, int num_freqs, int dir_freqs,
                           int use_viewdirs, int hidden, int rgb_hidden, bool general = false,
                           bool spill = false) {
  const int ld = row_stride(hidden, num_freqs, dir_freqs, use_viewdirs, rgb_hidden);
  const int n = general ? chunk_points(tile_rays * seg) : tile_rays * seg;
  const long long floats = (long long)kTilePoints * ((spill ? 0 : ld) + 3) +
                           (long long)kNumScalars * n + kRayScalars * tile_rays +
                           tile_rays * dir_dim(dir_freqs, use_viewdirs) +
                           (long long)(n_samples / seg) * tile_rays;
  return floats * (long long)sizeof(float) > 0x7fffffff ? 0x7fffffff
                                                        : (int)(floats * sizeof(float));
}

// The walk on n_blocks x scenes.n blocks; then, when dst is given, the
// reduction of each scene's partial rows into its n_grad - 2 floats of out
// (the parameters in their order without the layout's 3 padding floats,
// the loss last). kMma takes the tensor-core products; kGeneral the
// general walk on nerf_general_threads threads (spill: its X slabs, or
// null), else block_threads. Returns the CUDA error code (0 = ok).
template <Walk kMode, bool kMma = false, bool kGeneral = false>
int launch_walk(const Args& a, const WalkScenes& scenes, int n_blocks, int n_grad,
                const int* dst, float* out, float* spill, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = walk_smem_bytes(a.tile_rays, a.seg, a.S, a.num_freqs, a.dir_freqs,
                                   a.use_viewdirs, a.hidden, a.rgb_hidden, kGeneral,
                                   spill != nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_blocks, scenes.n);
  const int threads = kGeneral ? nerf_general_threads(a.hidden, a.rgb_hidden)
                               : block_threads(a.hidden, a.rgb_hidden);
  if (scenes.n > 1) {
    if constexpr (kMode == Walk::kLoss) {
      err = cudaFuncSetAttribute(nerf_walk_scenes_kernel<kMode, kMma, kGeneral>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      nerf_walk_scenes_kernel<kMode, kMma, kGeneral><<<grid, threads, smem, st>>>(a, scenes,
                                                                                 spill);
    } else {
      return (int)cudaErrorInvalidValue;  // K7 launches one scene
    }
  } else {
    err = cudaFuncSetAttribute(nerf_walk_kernel<kMode, kMma, kGeneral>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    nerf_walk_kernel<kMode, kMma, kGeneral><<<grid, threads, smem, st>>>(a, spill);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || dst == nullptr) return (int)err;
  const int row = n_grad + 1;
  reduce_partials_kernel<<<dim3((row + 255) / 256, scenes.n), 256, 0, st>>>(
      a.partials, n_blocks, row, dst, out, n_grad - 2);
  return (int)cudaGetLastError();
}

// Whether the tensor-core walk takes these widths (mma_dense_relu: warps
// own whole 32-column tiles of a trunk layer's output, and hidden / 32
// warps share rgb_in's columns in 1, 2 or 4 whole 8-column tiles each;
// the general walk's 16 warps hold a 64-row half's hidden / 32 tiles a
// round, so hidden <= 512): kernels/fused_nerf.py::mma_shapes_ok.
inline bool walk_mma_widths(int hidden, int rgb_hidden) {
  if (hidden <= 0 || hidden % 32 != 0 || hidden > 32 * (kMaxBlockThreads / 32) ||
      (4 * rgb_hidden) % hidden != 0)
    return false;
  const int nt_rgb = 4 * rgb_hidden / hidden;
  return nt_rgb == 1 || nt_rgb == 2 || nt_rgb == 4;
}

// The shape routes of a launch (kernels/fused_nerf.py::nerf_shape, a
// function of the configuration): the one-round walk (general 0) needs
// block_threads <= kMaxBlockThreads and whole 128-point chunks a segment; the
// general walk (general 1) takes any width up to kMaxGeneralWidth, any
// segment, and X in spill's slabs when spill is given. Off these: false.
inline bool walk_shape_ok(const Args& a, int general, const float* spill) {
  if (a.tile_rays < 1 || a.seg < 1 || a.S % a.seg != 0 || a.n_rays % a.tile_rays != 0)
    return false;
  if (!general)
    return spill == nullptr && block_threads(a.hidden, a.rgb_hidden) <= kMaxBlockThreads &&
           (a.tile_rays * a.seg) % kTilePoints == 0;
  return a.hidden <= kMaxGeneralWidth && a.rgb_hidden <= kMaxGeneralWidth;
}

// Every entry point's launch, on the route the caller chose
// (kernels/fused_nerf_train.py::uses_tensor_cores, a function of the dtype
// and the widths): w_mma given (pack_mma_weights) runs the tensor-core walk,
// which only bf16 at walk_mma_widths may take; w_mma null runs the CUDA-core
// walk, for f32 and for bf16 widths off that layout (which rounds to bf16 at
// run time, to_compute), at hidden and rgb_hidden multiples of 8 (the
// wrappers zero-pad other widths). The shape route (general, spill) must
// pass walk_shape_ok. Anything else is
// refused with cudaErrorInvalidValue and nothing launches: a bf16 launch
// at a tensor-core width without its fragments never becomes a CUDA-core
// launch, and the CUDA-core walk's backward needs w_bwd. `scenes` (K4 and
// K6; K7 launches one) must hold 1 to 65535 scenes, and more than one must
// also give each weight buffer's stride as exactly one MLP's size rounded
// up to a multiple of 4 (w_bwd's and w_mma's 0 when null: every scene's
// slab starts 16-byte aligned, as the CUDA-core products' float4 weight
// loads need) and n_grad as walk_n_grad, else it is refused the same way.
// One scene reads no stride.
template <Walk kMode>
int launch_walk_by_route(Args a, const void* w_mma, int n_blocks, int n_grad, const int* dst,
                         float* out, int device, void* stream, WalkScenes scenes = {},
                         int general = 0, float* spill = nullptr) {
  const bool mma = a.bf16 && walk_mma_widths(a.hidden, a.rgb_hidden);
  if ((w_mma != nullptr) != mma || scenes.n < 1 || scenes.n > 65535 ||
      !walk_shape_ok(a, general, spill))
    return (int)cudaErrorInvalidValue;
  if (scenes.n > 1) {
    const int E = enc_dim(a.num_freqs), Dd = dir_dim(a.dir_freqs, a.use_viewdirs);
    const int H = a.hidden, D = a.depth, RH = a.rgb_hidden;
    const long long want_bwd = (long long)(D - 1) * H * H + (long long)RH * H;
    const long long want_mma = mma_fwd_off(D, E, H, a.skip_at) + (long long)pad32(H + Dd) * RH +
                               (long long)(D - 1) * H * H + (long long)pad32(RH) * H;
    const int want_grad = walk_n_grad(E, Dd, H, D, a.skip_at, RH);
    auto slab = [](long long n) { return (n + 3) / 4 * 4; };
    if ((kMode != Walk::kPartialsFwd && n_grad != want_grad) ||
        scenes.fwd_stride != slab(want_grad) ||
        scenes.bwd_stride != (a.w_bwd != nullptr ? slab(want_bwd) : 0) ||
        scenes.mma_stride != (mma ? slab(want_mma) : 0))
      return (int)cudaErrorInvalidValue;
  }
  if (!mma) {
    if (kMode != Walk::kPartialsFwd && a.w_bwd == nullptr) return (int)cudaErrorInvalidValue;
    if (a.hidden <= 0 || a.hidden % kCols != 0 || a.rgb_hidden <= 0 || a.rgb_hidden % kCols != 0)
      return (int)cudaErrorInvalidValue;
    return general ? launch_walk<kMode, false, true>(a, scenes, n_blocks, n_grad, dst, out, spill,
                                                     device, stream)
                   : launch_walk<kMode>(a, scenes, n_blocks, n_grad, dst, out, nullptr, device,
                                        stream);
  }
  a.w_mma = w_mma;
  return general ? launch_walk<kMode, true, true>(a, scenes, n_blocks, n_grad, dst, out, spill,
                                                  device, stream)
                 : launch_walk<kMode, true>(a, scenes, n_blocks, n_grad, dst, out, nullptr, device,
                                            stream);
}

}  // namespace
