// Device code shared by the train kernels: K2 (fused_train.cu) and
// K4/K6 (fused_nerf_train.cu).
//
// - sample_depth: the stratified jitter. Philox4_32_10 (curand_kernel.h)
//   keyed by the int32 seed, with subsequence = global ray index and
//   offset = sample, so z depends on (seed, ray, sample) alone, not on
//   the tile or the block that drew it. u = (bits & 0xFFFFFF) * 2^-24
//   lies in [0, 1).
// - weight_grad_item: one 8x8 register block of a weight gradient,
//   summed over a tile's points and added to the block's own row of
//   gradient partials in device memory.
// - reduce_partials_kernel: the fixed-order sum of the partial rows, one
//   scene a grid row. No float atomics anywhere, so a launch is
//   bit-identical to the next.

#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr int kGradCols = 8;  // k and o extent of a weight-gradient block

// Depth of sample s of global ray `ray`: the reference's stratified bins
// near + s*h_bin (first and last half-bins clamped), or the grid itself.
__device__ __forceinline__ float sample_depth(unsigned int seed, int ray, int s, int S,
                                              float near, float h_bin, bool randomized) {
  const float grid = __fadd_rn(near, __fmul_rn(h_bin, (float)s));
  if (!randomized) return grid;
  curandStatePhilox4_32_10_t st;
  curand_init((unsigned long long)seed, (unsigned long long)ray, (unsigned long long)s, &st);
  const unsigned int bits = curand(&st);
  const float u = (float)(bits & 0xFFFFFFu) * (1.0f / 16777216.0f);
  const float half = 0.5f * h_bin;
  const float lower = s == 0 ? grid : __fsub_rn(grid, half);
  const float upper = s == S - 1 ? grid : __fadd_rn(grid, half);
  return __fadd_rn(lower, __fmul_rn(__fsub_rn(upper, lower), u));
}

struct Seg {  // columns [0, n) of a row-per-point buffer with row stride ld
  const float* ptr;
  int ld;
  int n;
};

// One thread block of a weight gradient, item = (k group, o group):
// part[(row0 + k) * n_out + o] (+)= sum over points p < P of
// in[p][k] * g[p][o], for k = kb + n_kb*jk < s.n and o = og + n_og*jo.
// Strided k and o keep a warp's shared-memory reads conflict-free and
// its device-memory writes contiguous over o. `first` writes, else adds.
__device__ __forceinline__ void weight_grad_item(int item, Seg s, int row0, const float* g,
                                                 int ld_g, int n_out, int P,
                                                 float* __restrict__ part, bool first) {
  const int n_og = n_out / kGradCols;
  const int n_kb = (s.n + kGradCols - 1) / kGradCols;
  const int kb = item / n_og;
  const int og = item % n_og;
  bool valid[kGradCols];
#pragma unroll
  for (int jk = 0; jk < kGradCols; ++jk) valid[jk] = kb + n_kb * jk < s.n;
  float acc[kGradCols][kGradCols];
#pragma unroll
  for (int jk = 0; jk < kGradCols; ++jk)
#pragma unroll
    for (int jo = 0; jo < kGradCols; ++jo) acc[jk][jo] = 0.f;

#pragma unroll 2
  for (int p = 0; p < P; ++p) {
    const float* xr = s.ptr + p * s.ld + kb;
    const float* gr = g + p * ld_g + og;
    float x[kGradCols], gv[kGradCols];
#pragma unroll
    for (int jk = 0; jk < kGradCols; ++jk) x[jk] = valid[jk] ? xr[n_kb * jk] : 0.f;
#pragma unroll
    for (int jo = 0; jo < kGradCols; ++jo) gv[jo] = gr[n_og * jo];
#pragma unroll
    for (int jk = 0; jk < kGradCols; ++jk)
#pragma unroll
      for (int jo = 0; jo < kGradCols; ++jo) acc[jk][jo] = fmaf(x[jk], gv[jo], acc[jk][jo]);
  }
  // Read every earlier partial before the first store: interleaved
  // read-add-store through one pointer would serialize 64 L2 round trips.
  float* dst = part + (size_t)(row0 + kb) * n_out + og;
  if (!first) {
#pragma unroll
    for (int jk = 0; jk < kGradCols; ++jk)
#pragma unroll
      for (int jo = 0; jo < kGradCols; ++jo)
        if (valid[jk]) acc[jk][jo] += dst[(size_t)n_kb * jk * n_out + n_og * jo];
  }
#pragma unroll
  for (int jk = 0; jk < kGradCols; ++jk)
#pragma unroll
    for (int jo = 0; jo < kGradCols; ++jo)
      if (valid[jk]) dst[(size_t)n_kb * jk * n_out + n_og * jo] = acc[jk][jo];
}

// out[dst[j]] = sum over blocks b, in order, of partials[b][j]; entries
// with dst[j] < 0 (alignment padding of the layout) are skipped. The
// scene axis is blockIdx.y: scene k's n_blocks partial rows follow scene
// k-1's, and its output is out + k * n_out. A one-scene launch reads and
// writes what it did before the axis existed.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                                       int row, const int* __restrict__ dst,
                                       float* __restrict__ out, int n_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= row || dst[j] < 0) return;
  const float* p = partials + (size_t)blockIdx.y * n_blocks * row;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += p[(size_t)b * row + j];
  out[(size_t)blockIdx.y * n_out + dst[j]] = s;
}

}  // namespace
