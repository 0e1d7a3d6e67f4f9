"""Fused full-NeRF training pass (K4) and the hierarchical fused gradient
function, on one CUDA kernel (csrc/fused_nerf_train.cu).

fused_nerf_pass_grads replaces the Pallas TPU kernel
tinynerf_tpu/kernels/fused_nerf_train.py:344 (body _nerf_train_kernel):
one NeRF-MLP pass, forward + composite + MSE + backward to the parameter
gradients. The coarse pass draws its stratified jitter in the kernel
(Philox keyed by (seed, ray, sample), K2's draw) and emits the per-sample
weights and the depths it used; the fine pass takes a given depth union.
The streamed twin K6 (kernels/fused_nerf_stream.py) is the kernel's
second entry point.

make_fused_nerf_grad_fn is the hierarchical step of
tinynerf_tpu/kernels/fused_nerf_train.py:464-573: the coarse pass
through K4, sample_pdf and the sorted union in torch, the fine pass
through K4 or, by the JAX package's routing rule, the streamed K6.

K4, K6 and K7 (kernels/fused_partials.py) route by configuration,
never after a failure (uses_tensor_cores): bf16 at the widths the
tensor-core products take (mma_shapes_ok; every recipe of the repo) runs
its MLP products on the tensor cores from the B fragments of
pack_mma_weights (csrc/mma_bf16.cuh; packed by kernels/fused_nerf.py's
mma_operands and pack_mma_b, which the render kernels share); f32, the
exactness reference, and bf16 at other widths (hidden 48; hidden 256
with rgb_hidden 32) run the CUDA-core walk from pack_backward_weights,
bf16 rounding at run time. .mma_launches counts the tensor-core
launches. The shape route (kernels/fused_nerf.py::nerf_shape) picks the
one-round walk, or the general walk (products in rounds past 512 threads,
tiles that end in a partial 128-point chunk, X in device memory past 227
KB), counted by .general_launches and .spill_launches.

The kernel writes its gradients in pack_nerf_weights' layout; a second
small kernel sums the per-block partials in a fixed order and scatters
them to model.parameters() order through scatter_index (the port of
kernel_grads_to_pytree, :305-341; the port's kernels use the model's own
encoding order, so there is no row permutation to invert).

What bounds it on an H100, and the kernel's layout: see the header of
csrc/fused_nerf_train.cu.

fused_nerf_pass_grads_plain is the same function in torch ops with
torch.autograd.grad: the CPU path of the wrapper, the tests' subject,
and the reference the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tinynerf_tpu_torch.kernels.fused_nerf import (
    NerfShape,
    check_inputs,
    composite_one_m,
    deltas,
    launch_shape,
    mma_operands,
    mma_shapes_ok,
    nerf_shape,
    pack_mma_b,
    pack_nerf_weights,
    pad_rays,
    padded_cfg,
    padded_widths,
    spill_buffer,
    unpad_grads,
)
from tinynerf_tpu_torch.kernels.fused_train import (
    _seed_tensor,
    _seeds_tensor,
    _split_grads,
    draw_step_inputs,
    join_scenes,
    scene_slabs,
    stratified_depths,
)
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, NeRFMLP, nerf_layer_in_dims, run_mlp, view_encoding
from tinynerf_tpu_torch.ops.sampling import sample_pdf
from tinynerf_tpu_torch.utils.metrics import mse2psnr
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

# The routing rule's ray tile (tinynerf_tpu/kernels/fused_nerf_train.py:57).
DEFAULT_TILE_R = 128
# The fine pass streams (K6) when the monolithic TPU kernel's activation
# scratch, depth x hidden x tile_r x S_union in the compute dtype, would
# pass 60 MB: a budget of the TPU's VMEM (fused_nerf_train.py:490-518),
# not of this kernel, kept so that one configuration takes the same
# kernels in both packages.
STREAM_ACT_BYTES = 60 * 1024 * 1024


def pass_grads_plain(mlp: NeRFMLP, rays_o, rays_d, target, z, sigma_noise, white_bkgd: bool,
                     cfg: NeRFConfig, sample_block: int):
    """One pass over the depths z (R, S) in torch ops, composited in blocks
    of `sample_block` samples with the entry transmittance carried ->
    (loss, grads aligned to mlp.parameters(), weights (R, S)), the
    gradients by torch.autograd.grad. One block of S is K4's composite."""
    R, S = z.shape
    d_enc_ray = view_encoding(rays_d, cfg)
    delta = deltas(z, rays_d)
    params = list(mlp.parameters())
    with torch.enable_grad():
        T_run = torch.ones(R, dtype=z.dtype, device=rays_o.device)
        C, A, ws = 0.0, 0.0, []
        for s0 in range(0, S, sample_block):
            zb = z[:, s0:s0 + sample_block]
            pts = rays_o[:, None, :] + rays_d[:, None, :] * zb[..., None]
            noise = None
            if sigma_noise is not None:
                noise = sigma_noise[:, s0:s0 + sample_block].reshape(-1, 1).float()
            rgb, sigma = run_mlp(mlp, pts, d_enc_ray, cfg, sigma_noise=noise)
            c, a, w, blk = composite_one_m(rgb, sigma, delta[:, s0:s0 + sample_block], t_in=T_run)
            C, A, T_run = C + c, A + a, T_run * blk
            ws.append(w)
        comp = C + (1.0 - A[:, None]) if white_bkgd else C
        loss = torch.mean((comp - target.to(comp.dtype)) ** 2)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads), torch.cat(ws, dim=1).detach()


def fused_nerf_pass_grads_plain(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seed,
    z_vals: Optional[torch.Tensor] = None,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    white_bkgd: bool = True,
    emit_sampling: bool = False,
    cfg: Optional[NeRFConfig] = None,
):
    """K4's semantics in torch ops -> (loss, grads aligned to
    mlp.parameters()), plus (weights (R, S), z (R, S)) with emit_sampling.

    z_vals None: the grid near + s*h, with randomized=True one uniform
    draw in each bin from a torch.Generator seeded with `seed` (the
    kernel's bins, another stream than its Philox draws). sigma_noise
    (R, S) is added to the raw density before the ReLU. A float64 copy
    of the MLP gives the same function with float64 sums: the points, the
    encoding and the deltas stay float32 and the matmul inputs are still
    rounded to compute_dtype."""
    cfg = cfg or mlp.cfg
    z = z_vals
    if z is None:
        z = stratified_depths(seed, rays_o.shape[0], n_samples, near, far, randomized,
                              rays_o.device)
    loss, grads, w = pass_grads_plain(mlp, rays_o, rays_d, target, z, sigma_noise, white_bkgd,
                                      cfg, z.shape[1])
    return (loss, grads, w, z) if emit_sampling else (loss, grads)


def pack_backward_weights(mlp: NeRFMLP, cfg: NeRFConfig) -> torch.Tensor:
    """The upstream products' weights, rounded to compute_dtype: trunk
    layers 1..depth-1 then rgb_in, each weight[:, :hidden] in nn.Linear's
    own (out, in) layout (the rows the upstream gradient needs: the skip
    layer's encoding rows and rgb_in's direction rows get no gradient).
    Stacked scenes give (K, n), a row a scene."""
    h = cfg.hidden
    lead = mlp.rgb_in.weight.shape[:-2]
    parts = [lin.weight.detach()[..., :h] for lin in list(mlp.layers)[1:]]
    parts.append(mlp.rgb_in.weight.detach()[..., :h])
    return torch.cat([p.to(cfg.compute_dtype).float().reshape(*lead, -1) for p in parts],
                     dim=-1).contiguous()


def uses_tensor_cores(cfg: NeRFConfig) -> bool:
    """The route of K4, K6 and K7, by configuration: bf16 at the widths the
    tensor-core walk takes (mma_shapes_ok) runs it (True); f32 and bf16
    at other widths (hidden 48; hidden 256 with rgb_hidden 32) run the
    CUDA-core walk (False). Never raises; a pure function of the dtype
    and the widths, so no launch falls back after a failure."""
    return cfg.compute_dtype == torch.bfloat16 and mma_shapes_ok(cfg)


def pack_mma_weights(mlp: NeRFMLP, cfg: NeRFConfig) -> torch.Tensor:
    """Every B operand of mma_operands, packed by pack_mma_b and
    concatenated (bf16): the w_mma buffer of every tensor-core launch of K4, K6
    and K7, whose offsets csrc/mma_bf16.cuh (mma_fwd_off) mirrors; (K, n)
    for stacked scenes."""
    return torch.cat([pack_mma_b(b) for _, b in mma_operands(mlp, cfg)], dim=-1).contiguous()


def grad_layout(cfg: NeRFConfig) -> dict:
    """Parameter name -> index tensor (the parameter's shape) into the
    kernel's gradient layout, which is pack_nerf_weights' layout: per
    trunk layer W (in, hidden) then b; sigma W (hidden), b, 3 padding
    entries; rgb_in W (hidden + dir_dim, rgb_hidden), b; rgb W
    (rgb_hidden, 3), b."""
    h, rh = cfg.hidden, cfg.rgb_hidden
    out, off = {}, 0

    def linear(name, n_in, n_out, pad=0):
        nonlocal off
        out[f"{name}.weight"] = off + torch.arange(n_in * n_out).reshape(n_in, n_out).t()
        out[f"{name}.bias"] = off + n_in * n_out + torch.arange(n_out)
        off += (n_in + 1) * n_out + pad

    for i, n_in in enumerate(nerf_layer_in_dims(cfg)):
        linear(f"layers.{i}", n_in, h)
    linear("sigma", h, 1, pad=3)
    linear("rgb_in", h + cfg.dir_dim, rh)
    linear("rgb", rh, 3)
    return out


@functools.lru_cache(maxsize=None)
def scatter_index(names: tuple, cfg: NeRFConfig, device: torch.device) -> torch.Tensor:
    """dst (n_grad + 1,) int32: kernel-layout index -> position in the
    flat output (the parameters in `names` order, the loss last; -1 for
    the layout's padding entries)."""
    layout = grad_layout(cfg)
    if sorted(names) != sorted(layout):
        raise ValueError(f"unexpected parameters {names}")
    src = torch.cat([layout[n].reshape(-1) for n in names])
    n = src.numel()
    n_grad = sum(lin.numel() for lin in layout.values()) + 3
    dst = torch.full((n_grad + 1,), -1, dtype=torch.int64)
    dst[src] = torch.arange(n)
    dst[n_grad] = n
    return dst.to(torch.int32).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/fused_nerf_train.cu, typed for
    ctypes: every pointer and the stream as c_void_p."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("fused_nerf_train")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    ll = ctypes.c_longlong
    lib.tinynerf_fused_nerf_train.argtypes = ([p] * 16 + [i] * 11 + [f] * 3 + [i] * 6
                                              + [ll] * 3 + [i, p, i, p])
    lib.tinynerf_fused_nerf_train.restype = i
    lib.tinynerf_fused_nerf_train_streamed.argtypes = ([p] * 13 + [i] * 12 + [f] + [i] * 5
                                                       + [ll] * 3 + [i, p, i, p])
    lib.tinynerf_fused_nerf_train_streamed.restype = i
    lib.tinynerf_fused_nerf_train_smem_bytes.argtypes = [i] * 10
    lib.tinynerf_fused_nerf_train_smem_bytes.restype = i
    lib.tinynerf_fused_nerf_train_workspace_floats.argtypes = [i] * 7
    lib.tinynerf_fused_nerf_train_workspace_floats.restype = ll
    lib.tinynerf_fused_nerf_train_spill_floats.argtypes = [i] * 5
    lib.tinynerf_fused_nerf_train_spill_floats.restype = ll
    lib.tinynerf_fused_nerf_train_threads.argtypes = [i] * 3
    lib.tinynerf_fused_nerf_train_threads.restype = i
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def walk_route(cfg: NeRFConfig, S: int, seg: int) -> str:
    """The walk's shape route in words (nerf_shape at cfg's launched widths)."""
    shape = nerf_shape(padded_cfg(cfg), S, seg)
    if not shape.general:
        return f"one-round walk, {shape.tile_rays} rays a tile"
    rounds = f"{shape.rounds} round{'s' if shape.rounds != 1 else ''}"
    return (f"general walk, {rounds}, {shape.tile_rays} rays a tile"
            + (", X in device memory" if shape.spill else ""))


def count_launch(fn, cfg: NeRFConfig, shape: NerfShape, scenes: bool = False) -> None:
    """Count one launch of a K4, K6 or K7 wrapper `fn` by route: the
    tensor cores (.mma_launches), the general walk (.general_launches), its
    spill route (.spill_launches), a stack of scenes (.scene_launches)."""
    fn.launches += 1
    fn.mma_launches += int(uses_tensor_cores(cfg))
    fn.general_launches += int(shape.general)
    fn.spill_launches += int(shape.spill)
    if scenes:
        fn.scene_launches += 1


def check_train_launch(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, target, z, sigma_noise,
                       S: int, seg: int, route: Optional[str] = None) -> NerfShape:
    """Validate what the train kernel takes for a pass of S samples in
    segments of `seg`; returns its shape (nerf_shape)."""
    check_inputs(mlp, cfg, rays_o, rays_d, z)
    R = rays_o.shape[0]
    if target.device != rays_o.device or target.dtype != torch.float32 or tuple(target.shape) != (R, 3):
        raise ValueError(f"target must be float32 ({R}, 3) on {rays_o.device}")
    if sigma_noise is not None and (sigma_noise.device != rays_o.device
                                    or sigma_noise.dtype != torch.float32
                                    or tuple(sigma_noise.shape) != (R, S)):
        raise ValueError(f"sigma_noise must be float32 ({R}, {S}) on {rays_o.device}")
    return launch_shape(cfg, S, seg, walk=True, route=route)


def launch_pass(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, target, shape: NerfShape, S: int, *,
                streamed: bool, seg: int, name: str, given: NeRFMLP, z=None, sigma_noise=None,
                seed=None, near: float = 2.0, far: float = 6.0, randomized: bool = False,
                white_bkgd: bool = True, emit_sampling: bool = False):
    """Pad the rays to whole tiles and launch K4 (seg == S: depths given
    or drawn in the kernel) or the streamed K6 (z given, segments of
    `seg` samples) in `shape` (check_train_launch's) -> (loss, grads
    aligned to mlp.parameters()[, weights, z]). The packing and the launch
    are the spans `<name>.pack` (repacks keyed on `given`, the wrapper's
    module before padded_widths) and `<name>.launch`.

    One scene: rays (R, 3), z and sigma_noise (R, S), `seed` an int or a
    one-element device tensor. K stacked scenes (rays (K, R, 3), an `mlp`
    whose parameters carry the scene axis, multiscene.py): z and
    sigma_noise (K, R, S), `seed` K seeds; the results gain the leading K
    axis, and the weights are packed once for all scenes."""
    scenes = rays_o.dim() == 3
    if not scenes:
        rays_o, rays_d, target = rays_o[None], rays_d[None], target[None]
        z = None if z is None else z[None]
        sigma_noise = None if sigma_noise is None else sigma_noise[None]
    K, R = rays_o.shape[:2]
    tile = shape.tile_rays
    pad = -R % tile
    dev = rays_o.device
    o, d = pad_rays(rays_o, rays_d, pad)
    tgt = torch.cat([target, target.new_zeros(K, pad, 3)], dim=1).contiguous()
    delta = None
    if z is not None:
        # Given depths (padded with ones, as K5 pads) come with their
        # deltas from torch, the plain versions' deltas, for K4 and K6 alike.
        z = torch.cat([z, z.new_ones(K, pad, S)], dim=1).contiguous()
        delta = deltas(z.reshape(-1, S), d.reshape(-1, 3)).reshape(K, -1, S).contiguous()
    noise = None
    if sigma_noise is not None:
        noise = torch.cat([sigma_noise, sigma_noise.new_zeros(K, pad, S)], dim=1).contiguous()
    bf16 = int(cfg.compute_dtype == torch.bfloat16)
    # The tensor-core route reads its products' weights as fragments only;
    # the CUDA-core walk reads the upstream weights rounded to the dtype.
    # Each buffer is packed once for every scene: (K, n).
    mma = uses_tensor_cores(cfg)
    with pack_span(name + ".pack", given):
        w_fwd = pack_nerf_weights(mlp, cfg)
        n_grad = w_fwd.shape[-1]
        w_fwd = scene_slabs(w_fwd, K)
        w_mma = scene_slabs(pack_mma_weights(mlp, cfg), K) if mma else None
        w_bwd = None if mma else scene_slabs(pack_backward_weights(mlp, cfg), K)
    n_tiles = (R + pad) // tile
    # Blocks per scene, independent of K: a scene's reduction order, and so
    # its loss and gradients, do not depend on the scenes beside it.
    n_blocks = min(n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    ws_floats = lib.tinynerf_fused_nerf_train_workspace_floats(
        tile, seg, cfg.num_freqs, cfg.hidden, cfg.depth, cfg.rgb_hidden, int(shape.general))
    ws = torch.empty(K, n_blocks, ws_floats, dtype=torch.float32, device=dev)
    spill = spill_buffer(cfg, shape, K * n_blocks, dev)
    partials = torch.empty(K, n_blocks, n_grad + 1, dtype=torch.float32, device=dev)
    n_params = n_grad - 3  # the layout's 3 padding floats after sigma's bias
    out = torch.empty(K, n_params + 1, dtype=torch.float32, device=dev)
    dst = scatter_index(tuple(n for n, _ in mlp.named_parameters()), cfg, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    geom = (cfg.num_freqs, cfg.num_freqs_dir, int(cfg.use_viewdirs), cfg.hidden, cfg.depth,
            cfg.skip_at, cfg.rgb_hidden)
    strides = (w_fwd.shape[1], 0 if w_bwd is None else w_bwd.shape[1],
               0 if w_mma is None else w_mma.shape[1])

    def ptr(x):
        return None if x is None else x.data_ptr()

    w_out = z_out = None
    if streamed:
        with span(name + ".launch"):
            err = lib.tinynerf_fused_nerf_train_streamed(
                o.data_ptr(), d.data_ptr(), tgt.data_ptr(), z.data_ptr(), delta.data_ptr(),
                ptr(noise), w_fwd.data_ptr(), ptr(w_bwd), ptr(w_mma), ws.data_ptr(),
                partials.data_ptr(), dst.data_ptr(), out.data_ptr(), R + pad, R, tile, S, seg,
                *geom, 1.0 / (R * 3), int(white_bkgd), bf16, n_blocks, n_grad, K, *strides,
                int(shape.general), ptr(spill), dev.index, stream,
            )
    else:
        if scenes:
            seed_t = _seeds_tensor(seed, K, dev)
        else:
            seed_t = _seed_tensor(0 if seed is None else seed, dev)
        if emit_sampling:
            w_out = torch.empty(K, R + pad, S, dtype=torch.float32, device=dev)
            z_out = torch.empty(K, R + pad, S, dtype=torch.float32, device=dev)
        with span(name + ".launch"):
            err = lib.tinynerf_fused_nerf_train(
                o.data_ptr(), d.data_ptr(), tgt.data_ptr(), ptr(z), ptr(delta), ptr(noise),
                seed_t.data_ptr(), w_fwd.data_ptr(), ptr(w_bwd), ptr(w_mma), ws.data_ptr(),
                partials.data_ptr(),
                dst.data_ptr(), out.data_ptr(), ptr(w_out), ptr(z_out), R + pad, R, tile, S,
                *geom, float(near), (far - near) / (S - 1), 1.0 / (R * 3), int(randomized),
                int(white_bkgd), bf16, n_blocks, n_grad, K, *strides, int(shape.general),
                ptr(spill), dev.index, stream,
            )
    _raise_on(err, "fused_nerf_train_streamed kernel" if streamed else "fused_nerf_train kernel")
    grads = _split_grads(out if scenes else out[0], mlp.parameters())
    loss = out[:, n_params] if scenes else out[0, n_params]
    if emit_sampling:
        if scenes:
            return loss, grads, w_out[:, :R], z_out[:, :R]
        return loss, grads, w_out[0, :R], z_out[0, :R]
    return loss, grads


def check_scenes_launch(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, target, z, sigma_noise,
                        S: int, seg: int) -> NerfShape:
    """check_train_launch for K stacked scenes: (K, R, 3) rays and target,
    (K, R, S) z and sigma_noise, every parameter stacking K scenes, at
    the launched widths (padded_widths'); scene 0's slabs go through
    check_train_launch. Returns the shape."""
    if rays_o.dim() != 3:
        raise ValueError(f"rays_o must be (K, R, 3), got {tuple(rays_o.shape)}")
    K, R = rays_o.shape[:2]
    for name, x, shape in (("rays_d", rays_d, (K, R, 3)), ("target", target, (K, R, 3)),
                           ("z_vals", z, (K, R, S)), ("sigma_noise", sigma_noise, (K, R, S))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if any(p.shape[0] != K for p in mlp.parameters()):
        raise ValueError(f"the MLP must stack {K} scenes on every parameter's first axis")
    return check_train_launch(mlp, cfg, rays_o[0], rays_d[0], target[0],
                              None if z is None else z[0],
                              None if sigma_noise is None else sigma_noise[0], S, seg)


@spanned
def fused_nerf_pass_grads(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seed,
    z_vals: Optional[torch.Tensor] = None,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    white_bkgd: bool = True,
    emit_sampling: bool = False,
    cfg: Optional[NeRFConfig] = None,
    route: Optional[str] = None,
):
    """One fused fwd+bwd NeRF-MLP pass -> (loss, grads aligned to
    mlp.parameters()), plus (weights (R, S), z (R, S)) with emit_sampling.

    z_vals (R, S) gives the depths (the fine pass); None draws them in the
    kernel: the grid near + s*h, jittered in its bins when randomized
    (Philox keyed by the int32 `seed`, an int or a one-element tensor on
    the rays' device). CUDA tensors launch the kernel (or raise) on the
    route of uses_tensor_cores, in the shape of nerf_shape (`route` forces
    one of ROUTES, to compare them); CPU tensors take
    fused_nerf_pass_grads_plain. `cfg` defaults to mlp.cfg."""
    cfg = cfg or mlp.cfg
    S = z_vals.shape[1] if z_vals is not None else n_samples
    if S < 2:
        raise ValueError(f"the kernel needs at least 2 samples per ray, got {S}")
    kw = dict(sigma_noise=sigma_noise, near=near, far=far, white_bkgd=white_bkgd,
              emit_sampling=emit_sampling)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_pass_grads_plain(mlp, rays_o, rays_d, target, seed, z_vals,
                                           n_samples=n_samples, randomized=randomized, cfg=cfg,
                                           **kw)
    mlp_k, cfg_k = padded_widths(mlp, cfg)
    shape = check_train_launch(mlp_k, cfg_k, rays_o, rays_d, target, z_vals, sigma_noise, S, S,
                               route)
    res = launch_pass(mlp_k, cfg_k, rays_o, rays_d, target, shape, S, streamed=False, seg=S,
                      name="fused_nerf_pass_grads", given=mlp, z=z_vals, seed=seed,
                      randomized=randomized and z_vals is None, **kw)
    count_launch(fused_nerf_pass_grads, cfg_k, shape)
    return (res[0], unpad_grads(res[1], cfg, cfg_k), *res[2:])


fused_nerf_pass_grads.launches = 0  # kernel launches since the last reset
# ... of which took the tensor-core walk (bf16 at the tensor-core widths)
fused_nerf_pass_grads.mma_launches = 0
# ... of which trained a stack of scenes in one launch (fused_nerf_pass_grads_scenes)
fused_nerf_pass_grads.scene_launches = 0
# ... of which ran the general walk (nerf_shape), and of those held X in device memory
fused_nerf_pass_grads.general_launches = 0
fused_nerf_pass_grads.spill_launches = 0


def fused_nerf_pass_grads_scenes_plain(mlp: NeRFMLP, rays_o, rays_d, target, seeds,
                                       z_vals=None, *, sigma_noise=None, **kw):
    """fused_nerf_pass_grads_scenes in torch ops: K4's plain version on
    each scene in turn (scene k's weights, slabs and seeds[k]). The CPU
    path and the tests' subject; no main path runs it when a card is
    present."""
    from tinynerf_tpu_torch.models.stacked import per_scene

    return per_scene(fused_nerf_pass_grads_plain, mlp, (rays_o, rays_d, target, seeds, z_vals),
                     dict(sigma_noise=sigma_noise), **kw)


@spanned
def fused_nerf_pass_grads_scenes(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seeds,
    z_vals: Optional[torch.Tensor] = None,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    white_bkgd: bool = True,
    emit_sampling: bool = False,
    cfg: Optional[NeRFConfig] = None,
):
    """One K4 launch for K stacked scenes -> (loss (K,), grads aligned to
    mlp.parameters(), each (K, *shape)), plus (weights, z) (K, R, S) with
    emit_sampling.

    `mlp` holds K NeRF MLPs stacked on a leading axis (multiscene.py);
    rays_o, rays_d, target (K, R, 3); seeds K int32 jitter seeds (a (K,)
    device tensor or ints); z_vals and sigma_noise (K, R, S). Scene k's
    results are bit-identical to fused_nerf_pass_grads on its own weights
    and slabs with seeds[k]. The weights are packed once for all scenes.
    CUDA tensors launch the kernel (or raise; .launches counts one, and
    .scene_launches one); CPU tensors take the plain version, scene by
    scene. Any width: every scene is padded alike (padded_widths)."""
    cfg = cfg or mlp.cfg
    S = z_vals.shape[-1] if z_vals is not None else n_samples
    if S < 2:
        raise ValueError(f"the kernel needs at least 2 samples per ray, got {S}")
    kw = dict(sigma_noise=sigma_noise, near=near, far=far, white_bkgd=white_bkgd,
              emit_sampling=emit_sampling)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_pass_grads_scenes_plain(mlp, rays_o, rays_d, target, seeds, z_vals,
                                                  n_samples=n_samples, randomized=randomized,
                                                  cfg=cfg, **kw)
    mlp_k, cfg_k = padded_widths(mlp, cfg)
    shape = check_scenes_launch(mlp_k, cfg_k, rays_o, rays_d, target, z_vals, sigma_noise, S, S)
    res = launch_pass(mlp_k, cfg_k, rays_o, rays_d, target, shape, S, streamed=False, seg=S,
                      name="fused_nerf_pass_grads_scenes", given=mlp, z=z_vals, seed=seeds,
                      randomized=randomized and z_vals is None, **kw)
    count_launch(fused_nerf_pass_grads, cfg_k, shape, scenes=True)
    return (res[0], unpad_grads(res[1], cfg, cfg_k), *res[2:])


def fine_pass_route(s, cfg: NeRFConfig, n_fine: int, tile_r: int = DEFAULT_TILE_R,
                    sample_block: Optional[int] = None) -> Optional[int]:
    """The JAX package's routing rule for the fine pass
    (tinynerf_tpu/kernels/fused_nerf_train.py:490-518): the sample block
    of the streamed K6, or None for the monolithic K4. An explicit
    sample_block always streams; else the pass streams when depth x
    hidden x min(tile_r, n_rand) x S_union in the compute dtype passes
    STREAM_ACT_BYTES, in the largest block <= 64 that divides the union
    and is a multiple of 8, or where no such block exists in
    default_sample_block's (the port's rule is total)."""
    from tinynerf_tpu_torch.kernels.fused_nerf import default_sample_block
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import DEFAULT_SAMPLE_BLOCK

    s_union = s.n_samples + n_fine
    if sample_block is not None:
        block = min(sample_block, s_union)
        if s_union % block:
            raise ValueError(f"fine union {s_union} must be a multiple of sample_block {block}")
        return block
    itemsize = 2 if cfg.compute_dtype == torch.bfloat16 else 4
    act_bytes = cfg.depth * cfg.hidden * min(tile_r, s.n_rand) * s_union * itemsize
    if act_bytes > STREAM_ACT_BYTES:
        return default_sample_block(s_union, DEFAULT_SAMPLE_BLOCK)
    return None


def _make_nerf_grad_fn(s, cfg: NeRFConfig, n_fine: int, tile_r: int, randomized: bool,
                       sample_block: Optional[int], scenes: bool):
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6

    s_union = s.n_samples + n_fine
    fine_block = fine_pass_route(s, cfg, n_fine, tile_r, sample_block)
    noise_std = s.sigma_noise_std
    k4_pass = fused_nerf_pass_grads_scenes if scenes else fused_nerf_pass_grads
    k6_pass = (k6.fused_nerf_pass_grads_streamed_scenes if scenes
               else k6.fused_nerf_pass_grads_streamed)

    def grad_fn(model: NeRF, ro, rd, target, generators, noise_scale=1.0):
        gens = generators if scenes else [generators]
        noise_c, noise_f, seed = join_scenes([
            draw_step_inputs(gen, ro.shape[-2], (s.n_samples, s_union), noise_std, noise_scale,
                             ro.device)
            for gen in gens], scenes)
        loss_c, g_c, weights, z_c = k4_pass(
            model.coarse, ro, rd, target, seed, n_samples=s.n_samples, near=s.near, far=s.far,
            randomized=randomized, white_bkgd=s.white_bkgd, emit_sampling=True, cfg=cfg,
            sigma_noise=noise_c,
        )
        z_mids = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
        # sample_pdf's u from each scene's own generator, after its other draws.
        z_f = [sample_pdf(z_mids[k] if scenes else z_mids,
                          (weights[k] if scenes else weights)[:, 1:-1], n_fine,
                          randomized=randomized, generator=gen if randomized else None)
               for k, gen in enumerate(gens)]
        z_f = torch.stack(z_f) if scenes else z_f[0]
        z_union = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
        if fine_block is not None:
            loss_f, g_f = k6_pass(
                model.fine, ro, rd, target, z_union, sigma_noise=noise_f,
                white_bkgd=s.white_bkgd, cfg=cfg, sample_block=fine_block,
            )
        else:
            loss_f, g_f = k4_pass(
                model.fine, ro, rd, target, seed, z_union, near=s.near, far=s.far,
                randomized=False, white_bkgd=s.white_bkgd, cfg=cfg, sigma_noise=noise_f,
            )
        for mlp, grads in ((model.coarse, g_c), (model.fine, g_f)):
            for p, g in zip(mlp.parameters(), grads):
                p.grad = g
        return loss_f, {"loss": loss_f, "psnr": mse2psnr(loss_f), "loss_coarse": loss_c}

    return grad_fn


def make_fused_nerf_grad_fn(s, cfg: NeRFConfig, n_fine: int = 64, tile_r: int = DEFAULT_TILE_R,
                            randomized: bool = True, sample_block: Optional[int] = None):
    """The hierarchical (coarse + fine) fused step, the drop-in for
    autograd of models/nerf.make_hierarchical_loss: (model: NeRF, ro, rd,
    target, generator, noise_scale=1.0) -> (fine loss, metrics), writing
    each parameter's .grad.

    The generator draws, in the JAX package's order (:522-538), the
    coarse (R, S) and fine (R, S_union) sigma-noise (only when
    s.sigma_noise_std > 0), then the int32 kernel seed
    (fused_train.draw_step_inputs), then sample_pdf's u. The fine pass
    takes K4 or K6 by fine_pass_route. On CPU tensors the kernels' plain
    versions run."""
    return _make_nerf_grad_fn(s, cfg, n_fine, tile_r, randomized, sample_block, scenes=False)


def make_fused_nerf_grad_fn_scenes(s, cfg: NeRFConfig, n_fine: int = 64,
                                   tile_r: int = DEFAULT_TILE_R, randomized: bool = True,
                                   sample_block: Optional[int] = None):
    """The multi-scene make_fused_nerf_grad_fn: (model of K stacked NeRFs,
    ro, rd, target (K, R, 3), generators (K scene generators),
    noise_scale=1.0) -> (fine loss (K,), metrics of (K,)), writing each
    stacked parameter's .grad. One batched K4 launch runs every scene's
    coarse pass, sample_pdf draws each scene's fine depths from its own
    generator, and one batched launch of K4 or K6 (fine_pass_route, as for
    one scene) runs every fine pass. The same body as
    make_fused_nerf_grad_fn's, so scene k's generator draws what a
    one-scene run's does, in its order."""
    return _make_nerf_grad_fn(s, cfg, n_fine, tile_r, randomized, sample_block, scenes=True)
