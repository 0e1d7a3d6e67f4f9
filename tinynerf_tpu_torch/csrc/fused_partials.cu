// Block-partials NeRF-MLP kernel pair on Hopper (sm_90a), K7: replaces the
// Pallas TPU kernels of tinynerf_tpu/kernels/fused_partials.py:381
// (make_fused_block_partials_fn; bodies _partials_fwd_kernel :79 and
// _partials_bwd_kernel :195). One sample shard of the sharded hierarchical
// loss (tinynerf_tpu_torch/parallel/train.py): the shard's depths z
// (R, S), the GLOBAL deltas sliced to the shard (they see the next shard's
// first depth and the 1e10 terminal) and the pre-ReLU density noise.
//
//   tinynerf_partials_fwd  the forward: walks the shard's sample blocks
//       carrying (T_run, C, A, D) per ray and writes the partials
//       C(3), A, T, D (the composite left open: no background), each
//       block's entry transmittance (the backward's residual) and
//       optionally the block-local weights alpha * T_within_shard.
//   tinynerf_partials_bwd  the backward: the cotangents of the partials
//       per ray, g_C(3), g_A, g_T, g_D, and optionally of the local
//       weights, to the parameter gradients. It walks the blocks back to
//       front, rematerialising each block's forward from the entry
//       transmittances; the density recurrence starts at the shard's last
//       sample from g_T (the product rule of T = prod one_m, which the
//       reference seeds its suffix sum with as g_T * T).
//
// Both are nerf_train_walk.cuh's walk (Walk::kPartialsFwd and
// Walk::kPartialsBwd), the walk of K6: the same forward, composite,
// backward chunks, gradient partials and fixed-order reduction, so K7 on
// one union computes K6's per-point values. The Python wrapper is
// tinynerf_tpu_torch/kernels/fused_partials.py (a torch.autograd.Function).
//
// What bounds it on an H100: arithmetic, as K6. At the flagship width a
// point costs 509,568 multiply-adds forward; the backward recomputes the
// forward and adds the weight-gradient and upstream products. As for K4
// and K6, the route is chosen by configuration (launch_walk_by_route):
// bf16 at the tensor-core widths runs those products on the tensor cores
// (mma_bf16.cuh, from pack_mma_weights' fragments; the forward and the
// backward's rematerialised forward with the same products, so the
// backward recomputes the forward's values); f32, and bf16 at other
// widths, on the CUDA cores, f32 being the exactness reference.

#include "nerf_train_walk.cuh"

extern "C" {

// Workspace floats of one block of the backward.
long long tinynerf_partials_workspace_floats(int tile_rays, int sample_block, int num_freqs,
                                             int hidden, int depth, int rgb_hidden, int general) {
  return walk_workspace_floats(tile_rays, sample_block, num_freqs, hidden, depth, rgb_hidden,
                               general != 0);
}

// The forward. z, delta and noise (R, S) (noise may be null); out6 (R, 6)
// C(3), A, T, D; tin (R, S / sample_block); w_out (R, S) or null; w_mma
// the tensor-core fragments, given exactly for bf16 at the tensor-core
// widths (launch_walk_by_route). n_rays must be a multiple
// of tile_rays and S of sample_block; general and spill the shape route, as
// K4's (fused_nerf_train.cu). Returns the CUDA error code (0 = ok).
int tinynerf_partials_fwd(const float* rays_o, const float* rays_d, const float* z,
                          const float* delta, const float* noise, const float* w_fwd,
                          const void* w_mma, float* out6, float* tin, float* w_out, int n_rays, int tile_rays,
                          int n_samples, int sample_block, int num_freqs, int dir_freqs,
                          int use_viewdirs, int hidden, int depth, int skip_at, int rgb_hidden,
                          int bf16, int n_blocks, int general, float* spill, int device,
                          void* stream) {
  Args a{};
  a.rays_o = rays_o;
  a.rays_d = rays_d;
  a.z = z;
  a.delta = delta;
  a.noise = noise;
  a.w_fwd = w_fwd;
  a.w_out = w_out;
  a.n_rays = a.n_real = n_rays;
  a.S = n_samples;
  a.seg = sample_block;
  a.tile_rays = tile_rays;
  a.num_freqs = num_freqs;
  a.dir_freqs = dir_freqs;
  a.use_viewdirs = use_viewdirs;
  a.hidden = hidden;
  a.depth = depth;
  a.skip_at = skip_at;
  a.rgb_hidden = rgb_hidden;
  a.bf16 = bf16;
  a.tin = tin;
  a.out6 = out6;
  return launch_walk_by_route<Walk::kPartialsFwd>(a, w_mma, n_blocks, 0, nullptr, nullptr,
                                                   device, stream, {}, general, spill);
}

// The backward. tin (R, S / sample_block) from the forward; g_ray (R, 6)
// the cotangents of C(3), A, T, D; g_w (R, S) or null; w_mma (bf16 at the
// tensor-core widths) or else w_bwd; general and spill as the forward's. Writes
// the parameter gradients to out in the order dst gives (then one unused
// float). Returns the CUDA error code (0 = ok).
int tinynerf_partials_bwd(const float* rays_o, const float* rays_d, const float* z,
                          const float* delta, const float* noise, const float* tin,
                          const float* g_ray, const float* g_w, const float* w_fwd,
                          const float* w_bwd, const void* w_mma, float* ws, float* partials, const int* dst,
                          float* out, int n_rays, int tile_rays, int n_samples, int sample_block,
                          int num_freqs, int dir_freqs, int use_viewdirs, int hidden, int depth,
                          int skip_at, int rgb_hidden, int bf16, int n_blocks, int n_grad,
                          int general, float* spill, int device, void* stream) {
  Args a{};
  a.rays_o = rays_o;
  a.rays_d = rays_d;
  a.z = z;
  a.delta = delta;
  a.noise = noise;
  a.w_fwd = w_fwd;
  a.w_bwd = w_bwd;
  a.ws = ws;
  a.partials = partials;
  a.n_rays = a.n_real = n_rays;
  a.S = n_samples;
  a.seg = sample_block;
  a.tile_rays = tile_rays;
  a.num_freqs = num_freqs;
  a.dir_freqs = dir_freqs;
  a.use_viewdirs = use_viewdirs;
  a.hidden = hidden;
  a.depth = depth;
  a.skip_at = skip_at;
  a.rgb_hidden = rgb_hidden;
  a.bf16 = bf16;
  a.g_ray = g_ray;
  a.g_w = g_w;
  a.tin = const_cast<float*>(tin);
  return launch_walk_by_route<Walk::kPartialsBwd>(a, w_mma, n_blocks, n_grad, dst, out, device,
                                                   stream, {}, general, spill);
}

const char* tinynerf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
