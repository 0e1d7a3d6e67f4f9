// Fused full-NeRF training pass on Hopper (sm_90a): one MLP pass of the
// hierarchical NeRF (rays -> depths -> points -> encoding -> trunk with
// skip -> sigma head -> view-direction branch -> rgb head -> composite ->
// MSE) and its backward to the PARAMETER gradients, in one launch (plus a
// small fixed-order reduction of the per-block partial sums). Two entry
// points share one kernel:
//
//   tinynerf_fused_nerf_train           K4, replaces the Pallas TPU kernel
//       tinynerf_tpu/kernels/fused_nerf_train.py:344 (fused_nerf_pass_grads,
//       body _nerf_train_kernel). Depths: the stratified jitter drawn in
//       the kernel (the coarse pass), the grid, or given (R, S) (the fine
//       pass); optionally writes the per-sample weights and the depths it
//       used, which the hierarchical resampling reads.
//   tinynerf_fused_nerf_train_streamed  K6, replaces
//       tinynerf_tpu/kernels/fused_nerf_stream.py:548
//       (fused_nerf_pass_grads_streamed, body _streamed_kernel). Given
//       sorted depths and deltas (R, S); walks sample blocks forward
//       carrying (T_run, C, A) per ray and stashing each block's entry T,
//       then walks them backward, rematerialising each block's forward.
//
// The Python wrappers are tinynerf_tpu_torch/kernels/fused_nerf_train.py
// (K4) and tinynerf_tpu_torch/kernels/fused_nerf_stream.py (K6).
//
// What bounds it on an H100: arithmetic. At the flagship width (hidden
// 256, depth 8, skip at 4, L=10, L_dir=4, rgb_hidden 64) a point costs
// 509,568 multiply-adds forward and as many again for each of the two
// backward products (weight gradients, upstream gradients). The route is
// chosen by configuration (kernels/fused_nerf_train.py::uses_tensor_cores,
// checked again by launch_walk_by_route): every bf16 launch of K4 and K6
// (and of K7) at the widths the tensor-core products take (every recipe of
// the repo) runs those products on the tensor cores (mma.sync m16n8k16,
// f32 accumulation; mma_bf16.cuh, weights packed by
// kernels/fused_nerf_train.py::pack_mma_weights); every f32 launch, and
// bf16 at other widths (hidden 48; hidden 256 with rgb_hidden 32), runs
// them on the CUDA cores' f32 FMAs, bf16 rounding its matmul inputs at run
// time. f32 is the exactness reference the bf16 walks and the f32 gates are
// held to.
//
// The walk itself (the forward of each segment, the composite, the
// backward in 64-point chunks, the gradient partials and the density
// recurrence) is nerf_train_walk.cuh's, Walk::kLoss, which K7
// (fused_partials.cu) shares; its header explains the design. K4 keeps its
// one segment's activations in the workspace from the forward to the
// backward; K6 rematerialises each block's forward on the reverse walk.
//
// Both entries take a scene axis (multi-scene training: one launch a step
// trains every scene): n_scenes in [1, 65535] slabs of every per-scene
// buffer, each slab the one-scene layout below, seed[k] for scene k, and
// each weight buffer's stride (one MLP's packed size rounded up to a
// multiple of 4; with more than one scene launch_walk_by_route refuses any
// other, one scene reads none). Scene k's loss and gradients are
// bit-identical to a one-scene launch on its slabs. The gradient output
// holds n_grad - 2 floats a scene.

#include "nerf_train_walk.cuh"

extern "C" {

// Shared memory of one block, in bytes, for tile_rays rays and segments
// of `seg` samples (seg = S for K4, the sample block for K6).
int tinynerf_fused_nerf_train_smem_bytes(int tile_rays, int seg, int n_samples, int num_freqs,
                                         int dir_freqs, int use_viewdirs, int hidden,
                                         int rgb_hidden) {
  return walk_smem_bytes(tile_rays, seg, n_samples, num_freqs, dir_freqs, use_viewdirs,
                         hidden, rgb_hidden);
}

// Workspace floats of one block: every activation of one segment.
long long tinynerf_fused_nerf_train_workspace_floats(int tile_rays, int seg, int num_freqs,
                                                     int hidden, int depth, int rgb_hidden) {
  return walk_workspace_floats(tile_rays, seg, num_freqs, hidden, depth, rgb_hidden);
}

int tinynerf_fused_nerf_train_max_threads() { return kMaxThreads; }

// K4. z and delta (R, S), or both null (the grid, jittered with the
// int32 *seed when randomized, deltas from it); noise (R, S) or null;
// w_out and z_out (R, S) or null.
// n_rays must be a multiple of tile_rays; rays from n_real on are padding
// (no loss, no gradient), in every scene. w_mma given (pack_mma_weights; bf16 at the
// tensor-core widths only) runs the products on the tensor cores, w_bwd
// unused; w_mma null runs them on the CUDA cores from w_bwd (f32, or bf16
// at other widths). Off that route: cudaErrorInvalidValue, no launch.
// Returns the CUDA error code (0 = ok).
int tinynerf_fused_nerf_train(const float* rays_o, const float* rays_d, const float* target,
                              const float* z, const float* delta, const float* noise,
                              const int* seed, const float* w_fwd, const float* w_bwd,
                              const void* w_mma, float* ws, float* partials,
                              const int* dst, float* out, float* w_out, float* z_out, int n_rays,
                              int n_real, int tile_rays, int n_samples, int num_freqs,
                              int dir_freqs, int use_viewdirs, int hidden, int depth, int skip_at,
                              int rgb_hidden, float near, float h_bin, float inv_n,
                              int randomized, int white_bkgd, int bf16, int n_blocks, int n_grad,
                              int n_scenes, long long fwd_stride, long long bwd_stride,
                              long long mma_stride, int device, void* stream) {
  const Args a{rays_o, rays_d, target, z, delta, noise, seed, w_fwd, w_bwd, ws, partials,
               w_out, z_out, n_rays, n_real, n_samples, n_samples, tile_rays, num_freqs,
               dir_freqs, use_viewdirs, hidden, depth, skip_at, rgb_hidden, near, h_bin, inv_n,
               randomized, white_bkgd, bf16};
  return launch_walk_by_route<Walk::kLoss>(a, w_mma, n_blocks, n_grad, dst, out, device,
                                            stream,
                                            {n_scenes, fwd_stride, bwd_stride, mma_stride});
}

// K6. z and delta (R, S); S must be a multiple of sample_block and n_rays
// of tile_rays. bf16 and f32 as K4. Returns the CUDA error code (0 = ok).
int tinynerf_fused_nerf_train_streamed(const float* rays_o, const float* rays_d,
                                       const float* target, const float* z, const float* delta,
                                       const float* noise, const float* w_fwd,
                                       const float* w_bwd, const void* w_mma, float* ws,
                                       float* partials,
                                       const int* dst, float* out, int n_rays, int n_real,
                                       int tile_rays, int n_samples, int sample_block,
                                       int num_freqs, int dir_freqs, int use_viewdirs,
                                       int hidden, int depth, int skip_at, int rgb_hidden,
                                       float inv_n, int white_bkgd, int bf16, int n_blocks,
                                       int n_grad, int n_scenes, long long fwd_stride,
                                       long long bwd_stride, long long mma_stride, int device,
                                       void* stream) {
  const Args a{rays_o, rays_d, target, z, delta, noise, nullptr, w_fwd, w_bwd, ws, partials,
               nullptr, nullptr, n_rays, n_real, n_samples, sample_block, tile_rays, num_freqs,
               dir_freqs, use_viewdirs, hidden, depth, skip_at, rgb_hidden, 0.f, 0.f, inv_n,
               0, white_bkgd, bf16};
  return launch_walk_by_route<Walk::kLoss>(a, w_mma, n_blocks, n_grad, dst, out, device,
                                            stream,
                                            {n_scenes, fwd_stride, bwd_stride, mma_stride});
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
