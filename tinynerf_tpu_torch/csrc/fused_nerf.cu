// Fused full-NeRF MLP render on Hopper (sm_90a): rays -> depths ->
// points -> Fourier encoding -> trunk with skip -> sigma head -> view-
// direction branch -> rgb head -> alpha composite. Two entry points
// share one kernel:
//
//   tinynerf_fused_nerf           K3, replaces the Pallas TPU kernel
//       tinynerf_tpu/kernels/fused_nerf.py:183 (fused_nerf_render_rays,
//       body _nerf_kernel). Depths analytic (linspace) or given (R, S);
//       optional per-sample weights out (R, S).
//   tinynerf_fused_nerf_streamed  K5, replaces
//       tinynerf_tpu/kernels/fused_nerf_stream.py:451
//       (fused_nerf_render_rays_streamed, body _streamed_render_kernel).
//       Given sorted depths and precomputed deltas (R, S); walks sample
//       blocks in order carrying (T_run, C, A) per ray.
//
// The Python wrappers are tinynerf_tpu_torch/kernels/fused_nerf.py and
// tinynerf_tpu_torch/kernels/fused_nerf_stream.py. The chunked MLP
// forward (dense_relu, both encodings) is in nerf_mlp.cuh, its tensor-core
// twin (mma_dense_relu) in mma_bf16.cuh, both shared with the training
// walk of K4/K6/K7 (nerf_train_walk.cuh).
//
// What bounds it on an H100: arithmetic. At the flagship width (hidden
// 256, depth 8, skip at 4, L=10, L_dir=4, rgb_hidden 64) a point costs
// 509,568 multiply-adds against a few bytes of depth input, while the
// unfused composition moves every (points, 319) activation through
// device memory. The kernel keeps a chunk's encoding and activations in
// shared memory and writes only (R, 4) (and the (R, S) weights when
// asked).
//
// Products, by the template argument kMma, chosen by configuration in
// the wrappers (render_uses_tensor_cores), never by a failure: a bf16
// launch at the widths mma_dense_relu takes (hidden a multiple of 32,
// 4 * rgb_hidden / hidden in {1, 2, 4}; every recipe of the repo) sets it
// and runs the trunk and rgb_in on the tensor cores (mma.sync m16n8k16,
// f32 accumulation) from the packed forward B fragments w_mma, at the
// training walk's offsets (mma_fwd_off); its sigma head sums over four
// lanes a point as the walk's does, so bf16 K3/K5 and bf16 K4 compute the
// same per-point values from equal inputs. f32 launches, and the bf16
// widths off that layout (hidden 48, say), run the CUDA cores' f32 FMAs
// below, the exactness reference.
//
// Shared memory at hidden 256 is what shapes the design. A block takes
// TR rays; their points are processed in chunks of PT = 128 point rows
//
//   X[p][0, hidden)               hidden activations h (then rgb_in's out)
//   X[p][hidden, hidden + E)      encoding [x, sin 2^k x, cos 2^k x]
//
// so the skip concat [h, enc] is columns [0, hidden + E). After the
// trunk, the (dead) encoding columns are overwritten with the ray's
// direction encoding, so rgb_in's input [h, d_enc] is columns
// [0, hidden + Dd). 128 rows x 319 floats is 163 KB: a whole sample row
// of one ray (192 points at the flagship's fine pass) would not fit, so
// the chunk, not the ray, is the unit of the MLP, and per-point
// (rgb, sigma) go to a small head buffer that the composite reads.
// On the CUDA cores each dense layer is a register-tiled product: a
// thread owns an 8-row x 8-column block (2*max(hidden, rgb_hidden)
// threads, 512 at hidden 256; rgb_in's rows per thread fit its width, and
// threads past a layer's blocks idle) and holds the whole sum in
// registers, so the output can be written over its input after a
// barrier; one buffer serves every layer. Widths that are not multiples
// of 8 reach the kernel zero-padded by the wrappers (exact: a padded
// column is ReLU(0) = 0 and the next layer's padded rows are 0). The
// point group is the fast thread index, so the block reads each weight row
// about once per chunk (weights stay in L2: 2 MB per MLP in f32). Row
// strides are odd, so the rows a warp reads at one column fall in
// distinct banks. On the tensor cores the same 2*hidden threads are
// hidden/16 warps, each a 64-row x 32-column tile of the chunk (8 NT
// columns for rgb_in), its sums in registers and written over the input
// after a barrier in the same way; A fragments come from the f32 buffer,
// the B fragments from L2, two k-steps ahead (mma_bf16.cuh).
//
// Widths past 256 (block_threads past 512) or a buffer past 227 KB take
// fused_nerf_general_kernel, a shape route chosen by configuration
// (kernels/fused_nerf.py::nerf_shape, checked again by launch): 512 threads
// walking the tiles, the trunk and rgb_in in rounds of whole point groups
// (dense_relu_rounds; on the tensor cores mma_dense_relu_rounds, hidden up
// to 512), and on its spill route X in a device slab a block. Every
// other line is this kernel's, so the two agree bit for bit wherever both
// run; fused_nerf_kernel itself is as it was.
//
// Composite: one thread per ray walks its samples in order. K3 is one
// segment of all S samples; K5 is segments of `sample_block` samples,
// each composited as soon as its heads are ready, with the transmittance
// carried as T_run * (block-local exclusive prefix), as _streamed_render_
// kernel does. With equal inputs both give the same per-point MLP values
// (same code, same order) and composites equal to f32 rounding.
//
// Numerics: depths, points, deltas and the composite are f32 with
// uncontracted (_rn) products where the reference rounds; sin/cos are
// the accurate libdevice versions because arguments reach 2^9 * x (never
// build with --use_fast_math). With bf16 set, every MLP input (encoding,
// direction encoding, hidden activations, rgb_in output) is rounded to
// bf16 where it is written and the wrapper rounds the weights; products
// are exact in f32 and the sums accumulate in f32 (on the tensor cores in
// their k-step order, so bf16 K3/K5 differ from the CUDA-core kernel by
// summation order only).

#include "mma_bf16.cuh"
#include "nerf_mlp.cuh"

namespace {

constexpr int kTrunkRows = 8;  // MT of the trunk products

struct Args {
  const float* rays_o;   // (R, 3)
  const float* rays_d;   // (R, 3)
  const float* z;        // (R, S), or null: analytic linspace depths
  const float* delta;    // (R, S) deltas times ||d||, or null: from z
  const float* weights;  // packed, see kernels/fused_nerf.py::pack_nerf_weights
  float* out;            // (R, 4): composite rgb (no background), acc
  float* w_out;          // (R, S) per-sample weights, or null
  int S, seg, tile_rays, num_freqs, dir_freqs, use_viewdirs;
  int hidden, depth, skip_at, rgb_hidden, bf16;
  float near, far;
  const void* w_mma;     // kMma: kernels/fused_nerf.py::pack_mma_forward (bf16), else null
};

// Depth of sample s of global ray g.
__device__ __forceinline__ float depth_at(const Args& a, int g, int s) {
  if (a.z != nullptr) return a.z[(size_t)g * a.S + s];
  const float t = (float)s / (float)(a.S - 1);
  return __fadd_rn(__fmul_rn(a.near, 1.f - t), __fmul_rn(a.far, t));
}

// delta_s = (z_{s+1} - z_s) * ||d||, 1e10 * ||d|| for the last sample.
__device__ __forceinline__ float delta_at(const Args& a, int g, int s, float norm) {
  if (a.delta != nullptr) return a.delta[(size_t)g * a.S + s];
  const float dz = s == a.S - 1 ? kDeltaInf : __fsub_rn(depth_at(a, g, s + 1), depth_at(a, g, s));
  return __fmul_rn(dz, norm);
}

template <bool kMma>
__global__ void __launch_bounds__(kMaxBlockThreads, 1) fused_nerf_kernel(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = a.tile_rays, SEG = a.seg, H = a.hidden;
  const int E = enc_dim(a.num_freqs), Dd = dir_dim(a.dir_freqs, a.use_viewdirs);
  const int ld = row_stride(H, a.num_freqs, a.dir_freqs, a.use_viewdirs, a.rgb_hidden);
  const bool bf16 = a.bf16 != 0;
  float* X = smem;                             // (PT, ld)
  float* pts = X + kTilePoints * ld;           // (PT, 3)
  float* heads = pts + kTilePoints * 3;        // (TR * SEG, 4): r, g, b, sigma
  float* denc = heads + TR * SEG * 4;          // (TR, Dd)
  const int ray0 = blockIdx.x * TR;

  // Packed weights: trunk (W, b)..., sigma (W hidden, b, 3 pad), rgb_in
  // (W (H + Dd, rgb_hidden), b), rgb (W (rgb_hidden, 3), b).
  const float* w_sigma = a.weights;
  for (int i = 0; i < a.depth; ++i) w_sigma += (layer_in_dim(i, E, H, a.skip_at) + 1) * H;
  const float* w_rgb_in = w_sigma + H + 4;
  const float* w_rgb = w_rgb_in + (H + Dd + 1) * a.rgb_hidden;
  // kMma: the packed forward B fragments, 4 bf16 values to a uint2.
  const uint2* w_mma = static_cast<const uint2*>(a.w_mma);

  // Direction encoding of d/||d||, once per ray.
  for (int idx = tid; idx < TR * Dd; idx += nt) {
    const int r = idx / Dd, j = idx % Dd;
    const float* d = a.rays_d + (size_t)(ray0 + r) * 3;
    denc[idx] = to_compute(dir_enc_value(d, ray_norm(d), j), bf16);
  }

  // Per-ray carry, held by thread r < TR across the sample segments.
  float T_run = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f;
  const int n_pts = TR * SEG;  // points of one segment
  for (int s0 = 0; s0 < a.S; s0 += SEG) {
    for (int c0 = 0; c0 < n_pts; c0 += kTilePoints) {
      // Points (rows past the segment's last point encode the origin).
      for (int p = tid; p < kTilePoints; p += nt) {
        const int q = c0 + p;
        float v[3] = {0.f, 0.f, 0.f};
        if (q < n_pts) {
          const int g = ray0 + q / SEG;
          const float z = depth_at(a, g, s0 + q % SEG);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[c] = __fadd_rn(a.rays_o[(size_t)g * 3 + c], __fmul_rn(a.rays_d[(size_t)g * 3 + c], z));
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pts[p * 3 + c] = v[c];
          X[p * ld + H + c] = to_compute(v[c], bf16);
        }
      }
      __syncthreads();
      // Encoding in the model's interleaved order: column 3 + 6k + c is
      // sin(2^k x_c), column 3 + 6k + 3 + c is cos(2^k x_c).
      encode_bands<kTilePoints>(X, ld, H, pts, a.num_freqs, bf16);
      __syncthreads();

      // Trunk: layer 0 reads the encoding, the skip layer [h, enc].
      const float* wp = a.weights;
      for (int i = 0; i < a.depth; ++i) {
        const int in_col = i == 0 ? H : 0;
        const int n_in = layer_in_dim(i, E, H, a.skip_at);
        if constexpr (kMma) {
          mma_dense_relu<4>(X, ld, in_col, n_in, H, w_mma + mma_fwd_off(i, E, H, a.skip_at) / 4,
                            wp + n_in * H, nullptr);
        } else {
          dense_relu<kTilePoints, kTrunkRows>(X, ld, in_col, n_in, H, wp, wp + n_in * H, bf16);
        }
        wp += (n_in + 1) * H;
      }

      // sigma = relu(h @ w + b) from the trunk; then the direction
      // encoding goes over the dead encoding columns.
      if constexpr (kMma) {
        // 4 neighbouring lanes a point (quad_dot, the training walk's sigma
        // head); whole warps run every round.
        for (int base = 0; base < 4 * kTilePoints; base += nt) {
          const int idx = base + tid, p = idx >> 2, j = idx & 3;
          const bool valid = idx < 4 * kTilePoints;
          const float s = quad_dot(X + p * ld, w_sigma, H, j, valid);
          const int q = c0 + p;
          if (valid && j == 0 && q < n_pts) heads[q * 4 + 3] = fmaxf(s + __ldg(w_sigma + H), 0.f);
        }
      } else {
        for (int p = tid; p < kTilePoints; p += nt) {
          const float* row = X + p * ld;
          float s = 0.f;
          for (int k = 0; k < H; ++k) s = fmaf(row[k], __ldg(w_sigma + k), s);
          const int q = c0 + p;
          if (q < n_pts) heads[q * 4 + 3] = fmaxf(s + __ldg(w_sigma + H), 0.f);
        }
      }
      for (int idx = tid; idx < kTilePoints * Dd; idx += nt) {
        const int p = idx / Dd, j = idx % Dd;
        const int q = c0 + p;
        const int r = q < n_pts ? q / SEG : 0;
        X[p * ld + H + j] = denc[r * Dd + j];
      }
      __syncthreads();

      // rgb_in: [h, d_enc] -> rgb_hidden. Tensor cores: 2 warps over the
      // rows, H / 32 over the columns, 8 * (4 * rgb_hidden / H) each; CUDA
      // cores: the fewest rows per thread with which the block's threads
      // cover the output (dense_relu_fit), at any rgb_hidden.
      const float* b_in = w_rgb_in + (H + Dd) * a.rgb_hidden;
      if constexpr (kMma) {
        const uint2* wm = w_mma + mma_fwd_off(a.depth, E, H, a.skip_at) / 4;
        switch (4 * a.rgb_hidden / H) {
          case 1: mma_dense_relu<1>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
          case 2: mma_dense_relu<2>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
          default: mma_dense_relu<4>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
        }
      } else {
        dense_relu_fit<kTilePoints>(X, ld, 0, H + Dd, a.rgb_hidden, w_rgb_in, b_in, bf16);
      }

      // rgb = sigmoid(g1 @ W + b).
      const float* b_rgb = w_rgb + a.rgb_hidden * 3;
      for (int idx = tid; idx < kTilePoints * 3; idx += nt) {
        const int p = idx / 3, c = idx % 3;
        const float* row = X + p * ld;
        float s = 0.f;
        for (int k = 0; k < a.rgb_hidden; ++k) s = fmaf(row[k], __ldg(w_rgb + k * 3 + c), s);
        const int q = c0 + p;
        if (q < n_pts) heads[q * 4 + c] = 1.f / (1.f + expf(-(s + __ldg(b_rgb + c))));
      }
      __syncthreads();
    }

    // Composite of the segment: thread r walks ray r's samples in order,
    // trans = T_run * (segment-local exclusive product of one_m).
    if (tid < TR) {
      const int g = ray0 + tid;
      const float norm = ray_norm(a.rays_d + (size_t)g * 3);
      float tl = 1.f;
      for (int sl = 0; sl < SEG; ++sl) {
        const int s = s0 + sl;
        const float* hd = heads + (tid * SEG + sl) * 4;
        const float one_m = expf(-__fmul_rn(hd[3], delta_at(a, g, s, norm))) + kTransEps;
        const float alpha = 1.f - (one_m - kTransEps);
        const float w = __fmul_rn(alpha, __fmul_rn(T_run, tl));
        cr = fmaf(w, hd[0], cr);
        cg = fmaf(w, hd[1], cg);
        cb = fmaf(w, hd[2], cb);
        acc += w;
        if (a.w_out != nullptr) a.w_out[(size_t)g * a.S + s] = w;
        tl = __fmul_rn(tl, one_m);
      }
      T_run = __fmul_rn(T_run, tl);
    }
    __syncthreads();  // the head buffer is refilled by the next segment
  }
  if (tid < TR)
    reinterpret_cast<float4*>(a.out)[ray0 + tid] = make_float4(cr, cg, cb, acc);
}


// The general kernel's own arguments, kept out of Args (more fields in a
// kernel's argument struct can change its code): the tiles it walks and,
// on the spill route, gridDim.x slabs of spill_floats(ld) for X (null: X
// in shared memory).
struct GeneralArgs {
  float* spill;
  int n_tiles;
};

// The general kernel (kernels/fused_nerf.py::nerf_shape), for the widths
// whose one-round block would pass kMaxBlockThreads threads or 227 KB: a block
// of nerf_general_threads walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; the trunk and rgb_in take their items in rounds of whole
// point groups (dense_relu_rounds, mma_dense_relu_rounds), and on the
// spill route X lives in the block's slab of device memory, reached
// through the same generic pointers. Everything else is fused_nerf_kernel's
// code, so each point's values and each ray's composite are that kernel's,
// bit for bit, wherever both run.
template <bool kMma>
__global__ void __launch_bounds__(kMaxBlockThreads, 1) fused_nerf_general_kernel(Args a,
                                                                          GeneralArgs g) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = a.tile_rays, SEG = a.seg, H = a.hidden;
  const int E = enc_dim(a.num_freqs), Dd = dir_dim(a.dir_freqs, a.use_viewdirs);
  const int ld = row_stride(H, a.num_freqs, a.dir_freqs, a.use_viewdirs, a.rgb_hidden);
  const bool bf16 = a.bf16 != 0;
  float* X = g.spill != nullptr ? g.spill + (size_t)blockIdx.x * spill_floats(ld) : smem;
  float* pts = g.spill != nullptr ? smem : X + kTilePoints * ld;  // (PT, 3)
  float* heads = pts + kTilePoints * 3;        // (TR * SEG, 4): r, g, b, sigma
  float* denc = heads + TR * SEG * 4;          // (TR, Dd)

  const float* w_sigma = a.weights;
  for (int i = 0; i < a.depth; ++i) w_sigma += (layer_in_dim(i, E, H, a.skip_at) + 1) * H;
  const float* w_rgb_in = w_sigma + H + 4;
  const float* w_rgb = w_rgb_in + (H + Dd + 1) * a.rgb_hidden;
  const uint2* w_mma = static_cast<const uint2*>(a.w_mma);
  const int n_pts = TR * SEG;  // points of one segment

  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    for (int idx = tid; idx < TR * Dd; idx += nt) {
      const int r = idx / Dd, j = idx % Dd;
      const float* d = a.rays_d + (size_t)(ray0 + r) * 3;
      denc[idx] = to_compute(dir_enc_value(d, ray_norm(d), j), bf16);
    }
    float T_run = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f;
    for (int s0 = 0; s0 < a.S; s0 += SEG) {
      for (int c0 = 0; c0 < n_pts; c0 += kTilePoints) {
        for (int p = tid; p < kTilePoints; p += nt) {
          const int q = c0 + p;
          float v[3] = {0.f, 0.f, 0.f};
          if (q < n_pts) {
            const int gr = ray0 + q / SEG;
            const float z = depth_at(a, gr, s0 + q % SEG);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              v[c] = __fadd_rn(a.rays_o[(size_t)gr * 3 + c], __fmul_rn(a.rays_d[(size_t)gr * 3 + c], z));
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            pts[p * 3 + c] = v[c];
            X[p * ld + H + c] = to_compute(v[c], bf16);
          }
        }
        __syncthreads();
        encode_bands<kTilePoints>(X, ld, H, pts, a.num_freqs, bf16);
        __syncthreads();

        const float* wp = a.weights;
        for (int i = 0; i < a.depth; ++i) {
          const int in_col = i == 0 ? H : 0;
          const int n_in = layer_in_dim(i, E, H, a.skip_at);
          if constexpr (kMma) {
            mma_dense_relu_rounds<4>(X, ld, in_col, n_in, H,
                                     w_mma + mma_fwd_off(i, E, H, a.skip_at) / 4, wp + n_in * H,
                                     nullptr);
          } else {
            dense_relu_rounds(X, ld, in_col, n_in, H, wp, wp + n_in * H, bf16);
          }
          wp += (n_in + 1) * H;
        }

        if constexpr (kMma) {
          for (int base = 0; base < 4 * kTilePoints; base += nt) {
            const int idx = base + tid, p = idx >> 2, j = idx & 3;
            const bool valid = idx < 4 * kTilePoints;
            const float s = quad_dot(X + p * ld, w_sigma, H, j, valid);
            const int q = c0 + p;
            if (valid && j == 0 && q < n_pts) heads[q * 4 + 3] = fmaxf(s + __ldg(w_sigma + H), 0.f);
          }
        } else {
          for (int p = tid; p < kTilePoints; p += nt) {
            const float* row = X + p * ld;
            float s = 0.f;
            for (int k = 0; k < H; ++k) s = fmaf(row[k], __ldg(w_sigma + k), s);
            const int q = c0 + p;
            if (q < n_pts) heads[q * 4 + 3] = fmaxf(s + __ldg(w_sigma + H), 0.f);
          }
        }
        for (int idx = tid; idx < kTilePoints * Dd; idx += nt) {
          const int p = idx / Dd, j = idx % Dd;
          const int q = c0 + p;
          const int r = q < n_pts ? q / SEG : 0;
          X[p * ld + H + j] = denc[r * Dd + j];
        }
        __syncthreads();

        const float* b_in = w_rgb_in + (H + Dd) * a.rgb_hidden;
        if constexpr (kMma) {
          const uint2* wm = w_mma + mma_fwd_off(a.depth, E, H, a.skip_at) / 4;
          switch (4 * a.rgb_hidden / H) {
            case 1: mma_dense_relu_rounds<1>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
            case 2: mma_dense_relu_rounds<2>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
            default: mma_dense_relu_rounds<4>(X, ld, 0, H + Dd, a.rgb_hidden, wm, b_in, nullptr); break;
          }
        } else {
          dense_relu_rounds(X, ld, 0, H + Dd, a.rgb_hidden, w_rgb_in, b_in, bf16);
        }

        const float* b_rgb = w_rgb + a.rgb_hidden * 3;
        for (int idx = tid; idx < kTilePoints * 3; idx += nt) {
          const int p = idx / 3, c = idx % 3;
          const float* row = X + p * ld;
          float s = 0.f;
          for (int k = 0; k < a.rgb_hidden; ++k) s = fmaf(row[k], __ldg(w_rgb + k * 3 + c), s);
          const int q = c0 + p;
          if (q < n_pts) heads[q * 4 + c] = 1.f / (1.f + expf(-(s + __ldg(b_rgb + c))));
        }
        __syncthreads();
      }

      if (tid < TR) {
        const int gr = ray0 + tid;
        const float norm = ray_norm(a.rays_d + (size_t)gr * 3);
        float tl = 1.f;
        for (int sl = 0; sl < SEG; ++sl) {
          const int s = s0 + sl;
          const float* hd = heads + (tid * SEG + sl) * 4;
          const float one_m = expf(-__fmul_rn(hd[3], delta_at(a, gr, s, norm))) + kTransEps;
          const float alpha = 1.f - (one_m - kTransEps);
          const float w = __fmul_rn(alpha, __fmul_rn(T_run, tl));
          cr = fmaf(w, hd[0], cr);
          cg = fmaf(w, hd[1], cg);
          cb = fmaf(w, hd[2], cb);
          acc += w;
          if (a.w_out != nullptr) a.w_out[(size_t)gr * a.S + s] = w;
          tl = __fmul_rn(tl, one_m);
        }
        T_run = __fmul_rn(T_run, tl);
      }
      __syncthreads();
    }
    if (tid < TR)
      reinterpret_cast<float4*>(a.out)[ray0 + tid] = make_float4(cr, cg, cb, acc);
  }
}

// Shared memory of one block, in bytes: X and the points, the heads of a
// segment, the direction encodings; spill: X in device memory instead.
int smem_bytes(int tile_rays, int seg, int num_freqs, int dir_freqs, int use_viewdirs,
               int hidden, int rgb_hidden, bool spill = false) {
  const int ld = row_stride(hidden, num_freqs, dir_freqs, use_viewdirs, rgb_hidden);
  const long long floats = (long long)kTilePoints * ((spill ? 0 : ld) + 3) +
                           (long long)tile_rays * seg * 4 +
                           tile_rays * dir_dim(dir_freqs, use_viewdirs);
  return floats * (long long)sizeof(float) > 0x7fffffff ? 0x7fffffff
                                                        : (int)(floats * sizeof(float));
}

template <bool kMma>
int launch_kernel(const Args& a, int n_rays, int smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_kernel<kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_nerf_kernel<kMma><<<n_rays / a.tile_rays, block_threads(a.hidden, a.rgb_hidden), smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMma>
int launch_general(const Args& a, const GeneralArgs& g, int n_blocks, int smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_general_kernel<kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_nerf_general_kernel<kMma><<<n_blocks, nerf_general_threads(a.hidden, a.rgb_hidden), smem,
                                    (cudaStream_t)stream>>>(a, g);
  return (int)cudaGetLastError();
}

// The routes are the caller's (kernels/fused_nerf.py: render_uses_tensor_cores
// and nerf_shape). Products: w_mma null runs the CUDA cores, at hidden and
// rgb_hidden multiples of 8 (the wrappers zero-pad other widths); w_mma set
// runs the tensor cores, and only a bf16 launch at the widths mma_dense_relu
// takes (hidden a multiple of 32 up to 512, 4 * rgb_hidden / hidden in
// {1, 2, 4}) may set it. Shape: general 0 runs fused_nerf_kernel, whose
// block must fit kMaxBlockThreads threads, one tile a block; general 1 runs
// fused_nerf_general_kernel on n_blocks blocks (widths up to
// kMaxGeneralWidth, tile_rays at most its threads), X in spill's slabs when
// spill is given. Off those: cudaErrorInvalidValue, no launch.
int launch(const Args& a, int n_rays, int general, float* spill, int n_blocks, int device,
           void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.tile_rays < 1 || a.seg < 1 || a.S % a.seg != 0 || n_rays % a.tile_rays != 0 ||
      a.hidden <= 0 || a.rgb_hidden <= 0)
    return (int)cudaErrorInvalidValue;
  if (general ? (a.hidden > kMaxGeneralWidth || a.rgb_hidden > kMaxGeneralWidth || n_blocks < 1 ||
                 a.tile_rays > nerf_general_threads(a.hidden, a.rgb_hidden))
              : (spill != nullptr || block_threads(a.hidden, a.rgb_hidden) > kMaxBlockThreads))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(a.tile_rays, a.seg, a.num_freqs, a.dir_freqs, a.use_viewdirs,
                              a.hidden, a.rgb_hidden, spill != nullptr);
  const GeneralArgs g{spill, n_rays / a.tile_rays};
  if (a.w_mma == nullptr) {
    if (a.hidden % kCols != 0 || a.rgb_hidden % kCols != 0) return (int)cudaErrorInvalidValue;
    return general ? launch_general<false>(a, g, n_blocks, smem, stream)
                   : launch_kernel<false>(a, n_rays, smem, stream);
  }
  const int nt_rgb = 4 * a.rgb_hidden / a.hidden;
  if (!a.bf16 || a.hidden % 32 != 0 || a.hidden > 512 || (4 * a.rgb_hidden) % a.hidden != 0 ||
      (nt_rgb != 1 && nt_rgb != 2 && nt_rgb != 4))
    return (int)cudaErrorInvalidValue;
  return general ? launch_general<true>(a, g, n_blocks, smem, stream)
                 : launch_kernel<true>(a, n_rays, smem, stream);
}

}  // namespace

extern "C" {

// Shared memory of one block, in bytes, for tile_rays rays and segments
// of `seg` samples (seg = S for K3, the sample block for K5); spill: X in
// device memory (the general kernel's spill route).
int tinynerf_fused_nerf_smem_bytes(int tile_rays, int seg, int num_freqs, int dir_freqs,
                                   int use_viewdirs, int hidden, int rgb_hidden, int spill) {
  return smem_bytes(tile_rays, seg, num_freqs, dir_freqs, use_viewdirs, hidden, rgb_hidden,
                    spill != 0);
}

// Threads of one block: one per 8x8 block of the widest (128, n) product;
// general: that capped at kMaxBlockThreads (the products in rounds).
int tinynerf_fused_nerf_threads(int hidden, int rgb_hidden, int general) {
  return general ? nerf_general_threads(hidden, rgb_hidden) : block_threads(hidden, rgb_hidden);
}

// Floats of one block's X slab on the spill route.
long long tinynerf_fused_nerf_spill_floats(int hidden, int num_freqs, int dir_freqs,
                                           int use_viewdirs, int rgb_hidden) {
  return spill_floats(row_stride(hidden, num_freqs, dir_freqs, use_viewdirs, rgb_hidden));
}

// K3. z (R, S) or null for the analytic linspace; w_out (R, S) or null;
// w_mma the packed forward fragments (the tensor-core route) or null (the
// CUDA cores); general, spill and n_blocks the shape route (launch). n_rays
// must be a multiple of tile_rays. Returns the CUDA error code of the
// attribute call or of the launch (0 = ok).
int tinynerf_fused_nerf(const float* rays_o, const float* rays_d, const float* z,
                        const float* weights, const void* w_mma, float* out, float* w_out,
                        int n_rays, int tile_rays, int n_samples, int num_freqs, int dir_freqs,
                        int use_viewdirs, int hidden, int depth, int skip_at, int rgb_hidden,
                        float near, float far, int bf16, int general, float* spill, int n_blocks,
                        int device, void* stream) {
  const Args a{rays_o, rays_d, z, nullptr, weights, out, w_out, n_samples, n_samples,
               tile_rays, num_freqs, dir_freqs, use_viewdirs, hidden, depth, skip_at,
               rgb_hidden, bf16, near, far, w_mma};
  return launch(a, n_rays, general, spill, n_blocks, device, stream);
}

// K5. z and delta (R, S); S must be a multiple of sample_block and n_rays
// of tile_rays; w_mma, general, spill and n_blocks as K3's. Returns the
// CUDA error code (0 = ok).
int tinynerf_fused_nerf_streamed(const float* rays_o, const float* rays_d, const float* z,
                                 const float* delta, const float* weights, const void* w_mma,
                                 float* out, int n_rays, int tile_rays, int n_samples,
                                 int sample_block, int num_freqs, int dir_freqs,
                                 int use_viewdirs, int hidden, int depth, int skip_at,
                                 int rgb_hidden, int bf16, int general, float* spill,
                                 int n_blocks, int device, void* stream) {
  const Args a{rays_o, rays_d, z, delta, weights, out, nullptr, n_samples, sample_block,
               tile_rays, num_freqs, dir_freqs, use_viewdirs, hidden, depth, skip_at,
               rgb_hidden, bf16, 0.f, 0.f, w_mma};
  return launch(a, n_rays, general, spill, n_blocks, device, stream);
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
