// The bf16 tensor-core products of the NeRF MLP kernels: warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with f32
// accumulation, on Hopper (sm_90a) as on every card since sm_80.
//
// Rule of the design: every bf16 launch of K4, K6 and K7 at the widths
// mma_dense_relu takes runs its three MLP products here (the trunk's and
// rgb_in's forward, the weight gradients, the upstream gradients;
// nerf_train_walk.cuh with kMma); every bf16 launch of the render kernels
// K3/K5 (fused_nerf.cu with kMma) at the same widths, and of the TinyNeRF
// render K1
// (fused_render.cu) at its tiles of at most 128 points, runs its forward
// products here; every bf16 launch of the TinyNeRF train kernel K2
// (fused_train.cu) at its 64-point tiles runs its three products here
// (64-row warp tiles of mma_rows, mma_weight_grad). f32 launches, and the
// few bf16 widths and tiles off those layouts, keep the CUDA-core
// products of nerf_mlp.cuh, train_common.cuh and K1's and K2's own.
//
// Operands. The kernels' shared buffer stays f32 with its odd row stride. A
// fragment is built by loading floats and packing them to bf16x2, which is
// exact: with bf16 set every MLP input and every output gradient is
// already rounded to bf16 where it is written (to_compute). The weights'
// B fragments are packed on the host (kernels/fused_nerf.py::pack_mma_b:
// pack_mma_weights for the walk, its forward prefix pack_mma_forward for
// the render) in the order one warp reads them: for each 16-deep k-step
// and 8-column tile, one 8-byte load per lane, straight from L2.
//
// The k order. A product sums over k, so a lane may hold any k as long as
// its A and B values agree. Lane (g = lane / 4, t = lane % 4) of k-step
// ks takes the physical columns c + j, j = 0..3, c = 32 (ks / 2) + 8 t +
// 4 (ks % 2), as the instruction's logical k = 2t, 2t+1, 2t+8, 2t+9. The
// rows a warp reads then fall in distinct banks (the row stride is -1
// modulo 32 and the columns step by 8), and k pads to a multiple of 32:
// the packed weights are zero there and the forward's and upstream's A
// loads are masked to zero (the buffer's columns past the input may hold
// anything). The weight gradient sums over the chunk's 64 points in the
// same order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nerf_mlp.cuh"
#include "train_common.cuh"

namespace {

constexpr int kMmaChunkPoints = 64;  // points of a backward chunk: 4 k-steps of a weight gradient
constexpr int kFwdMTiles = 4;  // 16-row tiles of a forward warp: 2 warps over 128 rows
constexpr int kUpMTiles = 2;   // of an upstream warp: 2 warps over the chunk's 64 points
constexpr int kUpNTiles = 4;   // 8-column tiles of an upstream warp
constexpr int kGradMTiles = 2; // of a weight-gradient item: 32 input rows

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

// Input width of trunk layer i: the encoding (E), the skip layer's [h, enc]
// or the hidden activations.
__host__ __device__ inline int layer_in_dim(int i, int E, int H, int skip_at) {
  return i == 0 ? E : (i == skip_at ? H + E : H);
}

// Offset, in bf16 values, of trunk layer i's forward B fragments in the
// packed tensor-core weights (pack_mma_weights): the forward of trunk
// layers 0..D-1 (pad32(in) x H each), rgb_in's forward (pad32(H + Dd) x
// RH), the upstream of trunk layers 1..D-1 (H x H each), then rgb_in's
// upstream (pad32(RH) x H). The render kernels read the forward prefix
// alone (pack_mma_forward), at the same offsets.
__host__ __device__ inline int mma_fwd_off(int i, int E, int H, int skip_at) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += pad32(layer_in_dim(j, E, H, skip_at)) * H;
  return off;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's first physical k of k-step ks (see the header).
__device__ __forceinline__ int lane_k(int ks, int t) { return (ks >> 1) * 32 + 8 * t + 4 * (ks & 1); }

// A fragment of rows r and r + 8 of a row-major f32 buffer (row stride
// ld), physical columns k .. k+3, zero from column n on.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4], const float* r0, int ld, int k,
                                            int n) {
  const float* r1 = r0 + 8 * ld;
  float v0[4], v1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = k + j < n;
    v0[j] = ok ? r0[k + j] : 0.f;
    v1[j] = ok ? r1[k + j] : 0.f;
  }
  a[0] = pack_bf16x2(v0[0], v0[1]);
  a[1] = pack_bf16x2(v1[0], v1[1]);
  a[2] = pack_bf16x2(v0[2], v0[3]);
  a[3] = pack_bf16x2(v1[2], v1[3]);
}

// acc[mt][nt] += rows [m0, m0 + 16 MT) of A (row-major f32 at `A`, row
// stride ld, the first n_k columns) times columns [8 nt0, 8 (nt0 + NT)) of
// the packed B (n_tiles 8-column tiles per k-step).
template <int MT, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[MT][NT][4], const float* A, int ld, int m0,
                                         int n_k, const uint2* __restrict__ Bp, int n_tiles,
                                         int nt0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const float* arow = A + (m0 + g) * ld;
  const uint2* bp = Bp + nt0 * 32 + lane;
  const int n_ks = pad32(n_k) / 16;  // even: whole 32-column panels
  // B comes from L2: each k-step's loads are issued two steps ahead.
  uint2 b[2][NT];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[s][nt] = __ldg(bp + (s * n_tiles + nt) * 32);
#pragma unroll 1
  for (int ks = 0; ks < n_ks; ks += 2) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = lane_k(ks + s, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        load_a_rows(a, arow + 16 * mt * ld, ld, k, n_k);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_16816(acc[mt][nt], a, b[s][nt].x, b[s][nt].y);
      }
      if (ks + s + 2 < n_ks) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[s][nt] = __ldg(bp + ((ks + s + 2) * n_tiles + nt) * 32);
      }
    }
  }
}

// Calls f(row, col, acc[mt][nt][e0], acc[mt][nt][e0 + 1]) for each pair
// of neighbouring columns the lane holds, rows from m0, columns from n0.
template <int MT, int NT, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NT][4], int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(m0 + 16 * mt + 8 * h + g, n0 + 8 * nt + 2 * t, acc[mt][nt][2 * h],
          acc[mt][nt][2 * h + 1]);
}

// nerf_mlp.cuh's dense_relu on the tensor cores, same contract:
// X[p][0, n_out) = to_compute(relu(X[p][in_col, in_col + n_in) @ W + b))
// for the 128 rows, written over the input after a barrier; a non-null
// `store` also receives the rows (row stride n_out). W is the layer's
// packed B; warp w takes rows 64 (w % 2) on and columns 8 NT (w / 2) on, so
// blockDim.x / 32 must be 2 n_out / (8 NT).
template <int NT>
__device__ void mma_dense_relu(float* X, int ld, int in_col, int n_in, int n_out,
                               const uint2* __restrict__ W, const float* __restrict__ b,
                               float* __restrict__ store) {
  constexpr int MT = kFwdMTiles;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp % 2) * 16 * MT, nt0 = (warp / 2) * NT;
  float acc[MT][NT][4];
  mma_rows<MT, NT>(acc, X + in_col, ld, m0, n_in, W, n_out / 8, nt0);
  __syncthreads();  // every read of the input columns is done
  for_each_pair(acc, m0, 8 * nt0, [&](int p, int c, float v0, float v1) {
    v0 = to_compute(fmaxf(v0 + __ldg(b + c), 0.f), true);
    v1 = to_compute(fmaxf(v1 + __ldg(b + c + 1), 0.f), true);
    X[p * ld + c] = v0;
    X[p * ld + c + 1] = v1;
    if (store != nullptr)
      *reinterpret_cast<float2*>(store + (size_t)p * n_out + c) = make_float2(v0, v1);
  });
  __syncthreads();
}

// mma_dense_relu for the general kernels, whose blocks (at most 16 warps)
// may hold fewer warps than the 2 n_out / (8 NT) warp tiles: the tiles
// go in rounds of whole 64-row halves, each round every column tile of
// one half (two halves a round where the block has the warps), warp w
// taking half w % halves and column tile w / halves as mma_dense_relu's
// warps do, so each tile's sums are mma_dense_relu's bit for bit. A round
// reads and then overwrites only its own rows. n_out / (8 NT) <= warps.
template <int NT>
__device__ void mma_dense_relu_rounds(float* X, int ld, int in_col, int n_in, int n_out,
                                      const uint2* __restrict__ W, const float* __restrict__ b,
                                      float* __restrict__ store) {
  constexpr int MT = kFwdMTiles;
  const int warp = threadIdx.x >> 5, n_ct = n_out / (8 * NT);
  const int halves = (int)(blockDim.x >> 5) >= 2 * n_ct ? 2 : 1;
  const bool active = warp < halves * n_ct;
#pragma unroll 1
  for (int h0 = 0; h0 < 2; h0 += halves) {
    const int m0 = (h0 + warp % halves) * 16 * MT, nt0 = (warp / halves) * NT;
    float acc[MT][NT][4];
    if (active) mma_rows<MT, NT>(acc, X + in_col, ld, m0, n_in, W, n_out / 8, nt0);
    __syncthreads();  // every read of this round's rows is done
    if (active) {
      for_each_pair(acc, m0, 8 * nt0, [&](int p, int c, float v0, float v1) {
        v0 = to_compute(fmaxf(v0 + __ldg(b + c), 0.f), true);
        v1 = to_compute(fmaxf(v1 + __ldg(b + c + 1), 0.f), true);
        X[p * ld + c] = v0;
        X[p * ld + c + 1] = v1;
        if (store != nullptr)
          *reinterpret_cast<float2*>(store + (size_t)p * n_out + c) = make_float2(v0, v1);
      });
    }
    __syncthreads();
  }
}

// The upstream product of a 64-point backward chunk into registers:
// acc = G[:, 0, n_red) @ W^T[:, :n_cols), W's packed upstream B. Warp w
// takes points 32 (w % 2) on and columns 32 (w / 2) on; blockDim.x / 32
// must be n_cols / 16. Returns the warp tile's first column; its first
// point is 32 (w % 2). No barrier: the caller synchronises before it
// writes the rows it read.
__device__ __forceinline__ int mma_upstream(float (&acc)[kUpMTiles][kUpNTiles][4],
                                            const float* G, int ld, int n_red,
                                            const uint2* __restrict__ W, int n_cols) {
  const int warp = threadIdx.x >> 5;
  const int nt0 = (warp / 2) * kUpNTiles;
  mma_rows<kUpMTiles, kUpNTiles>(acc, G, ld, (warp % 2) * 16 * kUpMTiles, n_red, W, n_cols / 8,
                                 nt0);
  return 8 * nt0;
}

// mma_upstream for the general kernels, with its epilogue: the warp tiles
// (32 points x 32 columns) go in rounds of whole 32-point halves of the
// chunk, as mma_dense_relu_rounds takes its rows, and after each round's
// barrier store(p, k, v0, v1) receives the round's sums (mma_upstream's,
// bit for bit). A round reads only its own rows of G, so the epilogue may
// write over them (rgb_in's upstream writes the trunk's gradient into G).
// The caller synchronises before the first round reads, as for
// mma_upstream. n_cols / 32 <= warps.
template <class F>
__device__ void mma_upstream_rounds(const float* G, int ld, int n_red,
                                    const uint2* __restrict__ W, int n_cols, F store) {
  const int warp = threadIdx.x >> 5, n_ct = n_cols / (8 * kUpNTiles);
  const int halves = (int)(blockDim.x >> 5) >= 2 * n_ct ? 2 : 1;
  const bool active = warp < halves * n_ct;
#pragma unroll 1
  for (int h0 = 0; h0 < 2; h0 += halves) {
    const int m0 = (h0 + warp % halves) * 16 * kUpMTiles, nt0 = (warp / halves) * kUpNTiles;
    float acc[kUpMTiles][kUpNTiles][4];
    if (active) mma_rows<kUpMTiles, kUpNTiles>(acc, G, ld, m0, n_red, W, n_cols / 8, nt0);
    __syncthreads();  // every read of this round's rows is done
    if (active) for_each_pair(acc, m0, 8 * nt0, store);
    __syncthreads();
  }
}

// train_common.cuh's weight_grad_item loop on the tensor cores, with the
// bias gradient as one more input row of ones: part[k * n_out + o] (+)=
// sum over the chunk's 64 points p of in[p][k] * G[p][o] for k < in.n,
// and of G[p][o] for k = in.n (the layout's bias row, after W's rows);
// `first` writes, else adds. The block's warps take items of 32 input
// rows x 8 NT outputs in turn. Rows past in.n are dropped.
template <int NT>
__device__ void mma_weight_grad(Seg in, const float* G, int ld_g, int n_out,
                                float* __restrict__ part, bool first) {
  constexpr int MT = kGradMTiles;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_ng = n_out / (8 * NT), n_items = (in.n + 16 * MT) / (16 * MT) * n_ng;
#pragma unroll 1
  for (int item = warp; item < n_items; item += nw) {
    const int m0 = (item / n_ng) * 16 * MT, n0 = (item % n_ng) * 8 * NT;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMmaChunkPoints / 16; ++ks) {
      const int p = lane_k(ks, t);  // the lane's points p .. p+3
      const float* x = in.ptr + p * in.ld;
      const float* gp = G + p * ld_g;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = n0 + 8 * nt + g;
        b[nt][0] = pack_bf16x2(gp[o], gp[ld_g + o]);
        b[nt][1] = pack_bf16x2(gp[2 * ld_g + o], gp[3 * ld_g + o]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + 16 * mt + g;
        float v[2][4];  // rows m and m + 8, the lane's 4 points
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[h][j] = m + 8 * h < in.n ? x[j * in.ld + m + 8 * h] : (m + 8 * h == in.n ? 1.f : 0.f);
        const uint32_t a[4] = {pack_bf16x2(v[0][0], v[0][1]), pack_bf16x2(v[1][0], v[1][1]),
                               pack_bf16x2(v[0][2], v[0][3]), pack_bf16x2(v[1][2], v[1][3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    // Read every earlier partial before the first store (as weight_grad_item).
    if (!first) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = m0 + 16 * mt + 8 * h + g;
          if (k <= in.n) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float2 old = *reinterpret_cast<const float2*>(
                  part + (size_t)k * n_out + n0 + 8 * nt + 2 * t);
              acc[mt][nt][2 * h] += old.x;
              acc[mt][nt][2 * h + 1] += old.y;
            }
          }
        }
    }
    for_each_pair(acc, m0, n0, [&](int k, int o, float v0, float v1) {
      if (k <= in.n) *reinterpret_cast<float2*>(part + (size_t)k * n_out + o) = make_float2(v0, v1);
    });
  }
}

}  // namespace
