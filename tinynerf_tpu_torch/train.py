"""Training driver: `python -m tinynerf_tpu_torch.train --iters 20000 ...`

Port of tinynerf_tpu/train.py:36-738 (TinyNeRF, the full NeRF with the
coarse or the occupancy proposal, the grid family): seed and data, model
and optimizer (training.make_optimizer's levers: the lr schedule, AdamW,
the EMA), resume of params, optimizer and step from the checkpoint, rays
precomputed for every pose (reprojected to NDC space with --ndc, before
the holdout: a forward-facing capture samples t in [0, 1]), an optional
tail or strided holdout, the sparsity prior over the capture's box (the
NDC cube [-1, 1]^3 with --ndc), steps in blocks cut at every
log/preview/checkpoint/eval boundary, a log line and a JSONL record every
log_every, the sigma-death watchdog (a run pinned at the background's
PSNR saves its checkpoint and exits with code 3), held-out evaluations
every eval_every (the raw and EMA weights), preview PNGs, checkpoints
(with the EMA twin <ckpt>.ema.npz and, with ckpt_keep, step-stamped
copies), the final checkpoint and final.png, the final evaluation and
the "[done] ... rays/s" line (evaluation time excluded). The
checkpoint's meta is the JAX driver's (the TinyNeRF subset for --model
tinynerf), so the JAX eval and make_gif read it and the JAX trainer
resumes it.

Gradients go through the fused CUDA train kernels unless
--no-fused-train, which runs the loss (training.loss_fn, or
models/nerf.make_hierarchical_loss for --model nerf) with autograd:
TinyNeRF through K2 (kernels/fused_train.py), the full NeRF through K4
for the coarse pass and K4 or the streamed K6 for the fine pass
(kernels/fused_nerf_train.py). The NeRF's previews and evaluation render
through the hierarchical renderer (K3/K5 with --fused). --proposal
occupancy trains one MLP on n_samples + n_fine depths proposed by a
density grid over the capture's box (ops/occupancy.py; the grid rebuilt
once per block), its gradients through the streamed K6 (or autograd with
--no-fused-train), and renders through the occupancy renderer (K5 with
--fused); it takes --data-parallel, not --sample-parallel. --model grid
(models/grid_nerf.py) trains and renders in eager torch whatever --fused
and --fused-train say, by configuration: the family has no kernel (the
JAX package's XLA path); its scene box is the capture's (the NDC cube
under --ndc), persisted in the meta's `grid` entry; it takes
--data-parallel, and refuses --sample-parallel and --proposal occupancy
as the JAX package does. Instant-NGP at its published sizes (arXiv:2201.05989;
gpubench/configs/instant-ngp.json) is the grid family with
    --model grid --grid-levels 16 --grid-max-res 2048 --grid-table-size 524288
    --grid-dir-encoding sh --grid-density-activation exp --grid-rgb-reads-density
    --lr 0.01 --adam-b2 0.99 --adam-eps 1e-15 --l2-reg 1e-6 --sparse-adam --n-rand 4096
(MaskedAdam: the tables' zero-gradient entries skipped, L2 on the MLP
matrices). Metrics stay on the device inside a block; the
host reads them only at a log point. --profile-dir writes a
torch.profiler Chrome trace of the training loop there
(utils/profiling.trace).

Parallel training (tinynerf_tpu/train.py:53-62, 219-258, 361-381):
--data-parallel (or --distributed) joins the launcher's process group
(parallel/mesh.initialize_distributed; torch.distributed.run sets the
environment), and with more than one rank the steps run through
parallel/train.make_sharded_train_block: the rays sharded over the ranks,
and with --sample-parallel N (--model nerf) each pass's samples over N
of them, through K7 with --fused-train. The fused grad_fn (K2, K4/K6)
serves --data-parallel alone. Rank 0 alone writes the checkpoints,
previews, metrics and the final evaluation; the other ranks wait at a
barrier. Every rank prints a digest of its parameters at the end.

    python -m tinynerf_tpu_torch.train [--model nerf] [--iters N] [--no-fused-train]
    python -m torch.distributed.run --nproc-per-node 2 -m tinynerf_tpu_torch.train \
        --model nerf --data-parallel --sample-parallel 2
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.evaluation import evaluate_views
from tinynerf_tpu_torch.main import _sync
from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays, default_aabb
from tinynerf_tpu_torch.ops.rays import get_rays_for_poses, ndc_rays
from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, grid_form_meta, make_grid_loss
from tinynerf_tpu_torch.models.nerf import NeRF, make_hierarchical_loss
from tinynerf_tpu_torch.render import (
    make_grid_image_renderer,
    make_hierarchical_image_renderer,
    make_image_renderer,
    make_occupancy_image_renderer,
)
from tinynerf_tpu_torch.training import (
    SigmaDeathDetector,
    background_psnr,
    init_train_state,
    make_train_block,
)
from tinynerf_tpu_torch.utils import checkpoint as ckpt_lib
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png
from tinynerf_tpu_torch.utils.profiling import trace


def _kernel_launches() -> dict:
    """The launch count of every kernel wrapper this process imported (a
    function of kernels/ with a `launches` counter), by name, and as
    `<name>.<route>_launches` the counts of its routes where it keeps them
    (the tensor cores, the general kernel, the spill route)."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("tinynerf_tpu_torch.kernels."):
            for attr, fn in vars(mod).items():
                if getattr(fn, "__module__", None) == name and hasattr(fn, "launches"):
                    counts[attr] = fn.launches
                    for route in ("mma_launches", "general_launches", "spill_launches"):
                        if hasattr(fn, route):
                            counts[f"{attr}.{route}"] = getattr(fn, route)
    return counts


def _boundaries(start: int, end: int, *cadences: int):
    """Yield (block_start, block_len) segments cut at every cadence multiple."""
    step = start
    while step < end:
        nxt = min([end] + [((step // c) + 1) * c for c in cadences if c > 0])
        yield step, nxt - step
        step = nxt


def strided_holdout(n_images: int, count: int) -> list:
    """`count` pose indices spread evenly over n_images
    (tinynerf_tpu/train.py:191-197); raises when rounding collapses two."""
    hold = np.unique(np.round(np.linspace(0, n_images - 1, count)).astype(int)).tolist()
    if len(hold) != count:
        raise ValueError(f"strided holdout of {count} from {n_images} poses collapses duplicate "
                         "indices: lower --holdout")
    return hold


def main(cfg: Config = Config()) -> dict:
    if cfg.model not in ("tinynerf", "nerf", "grid"):
        raise ValueError(f"unknown model {cfg.model!r} (tinynerf|nerf|grid)")
    if cfg.proposal not in ("coarse", "occupancy"):
        raise ValueError(f"unknown proposal {cfg.proposal!r} (coarse|occupancy)")
    grid = cfg.model == "grid"
    if grid and cfg.proposal == "occupancy":
        raise ValueError("--proposal occupancy is a nerf-family sampler; the grid model's fine "
                         "levels already concentrate capacity")
    if grid and cfg.sample_parallel > 1:
        raise ValueError("--sample-parallel > 1 is not implemented for --model grid (no "
                         "block-partials path for the gather encoder); grid supports "
                         "--data-parallel ray sharding")
    if cfg.proposal == "occupancy" and cfg.model != "nerf":
        raise ValueError("--proposal occupancy requires --model nerf (the grid proposes samples "
                         "for the single NeRF MLP)")
    nerf = cfg.model == "nerf"
    occupancy = nerf and cfg.proposal == "occupancy"
    t_start = time.time()
    device = torch.device(cfg.device)
    owns_group = False  # this run joined the process group, and leaves it
    if cfg.distributed or cfg.data_parallel:
        from tinynerf_tpu_torch.parallel.mesh import (
            initialize_distributed,
            pick_backend,
            rank_device,
        )

        backend, why = pick_backend(device.type)
        owns_group = not dist.is_initialized()
        if initialize_distributed(backend=backend, device_type=device.type):
            device = rank_device(cfg.device)
            print(f"[distributed] process {dist.get_rank()}/{dist.get_world_size()}, backend "
                  f"{dist.get_backend()} ({why}), device {device}")
        else:
            print("[distributed] no launcher environment (RANK, WORLD_SIZE): single-process run")
        owns_group = owns_group and dist.is_initialized()
    world = dist.get_world_size() if dist.is_initialized() else 1
    is_main = world == 1 or dist.get_rank() == 0
    # Parallelism flag validation: a misconfiguration fails loud, never
    # silently trains another layout than the one requested.
    if cfg.sample_parallel > 1:
        if occupancy:
            raise ValueError(
                "--proposal occupancy does not compose with --sample-parallel (the grid proposal "
                "has no per-pass composite to shard); it does support --data-parallel")
        if cfg.fused_train and not nerf:
            raise ValueError(
                "--fused-train with --sample-parallel > 1 is only implemented for --model nerf "
                "(the block-partials kernels, kernels/fused_partials.py, implement the NeRF MLP). "
                "For tinynerf, drop --sample-parallel to keep the fused kernel or drop "
                "--fused-train to shard the sample axis eagerly."
            )
        if not cfg.data_parallel:
            raise ValueError(
                "--sample-parallel > 1 requires --data-parallel: the sample axis lives on the "
                "('data', 'sample') mesh (without it training would silently run unsharded)"
            )
        if world == 1:
            raise ValueError(
                f"--sample-parallel > 1 needs more than one process (world size {world}): "
                "launch with python -m torch.distributed.run --nproc-per-node N"
            )
    if world > 1 and device.type == "cuda":
        torch.cuda.set_device(device)  # this rank's card
    os.makedirs(cfg.out_dir, exist_ok=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[device] {device} ({name}) torch={torch.__version__}")

    def barrier():
        if world > 1:
            dist.barrier()

    if not is_main:
        barrier()  # rank 0 generates and caches a missing dataset first
    d = ensure_data(cfg.data_path, allow_synthetic=cfg.allow_synthetic, device=device)
    if is_main:
        barrier()
    images = torch.from_numpy(d["images"]).to(device)
    poses = torch.from_numpy(d["poses"]).to(device)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    print(
        f"[data] N={n_images} H={H} W={W} focal={focal:.2f}"
        + (" (synthetic)" if d.get("synthetic") else "")
    )

    settings = cfg.train_settings()
    if cfg.precrop_iters > 0:
        # The crop window needs the images' geometry (training.draw_ray_batch).
        settings = dataclasses.replace(settings, image_hw=(H, W))
        print(f"[train] precrop warmup: central {cfg.precrop_frac:.2f} window for the first "
              f"{cfg.precrop_iters} steps")
    # The effective regularizers, as the JAX driver echoes them.
    print(f"[train] ray_sampling={settings.ray_sampling} "
          f"sigma_noise(std={settings.sigma_noise_std}, "
          f"decay_steps={settings.sigma_noise_decay_steps}, "
          f"floor={settings.sigma_noise_floor}) "
          f"weight_decay={settings.weight_decay} ema_decay={settings.ema_decay}")
    loss = init_fn = None
    if nerf:
        ncfg = cfg.nerf_cfg()
        # The occupancy proposal's model is the fine MLP alone; its loss
        # lives in the block (the grid is rebuilt once per block).
        parts = ("fine",) if occupancy else ("coarse", "fine")
        loss = None if occupancy else make_hierarchical_loss(ncfg, n_fine=cfg.n_fine)

        def init_fn(generator, dev):
            return NeRF(ncfg, generator=generator, device=dev, parts=parts)
    elif grid:
        # The tables' and the MLP's shapes do not depend on the box: the
        # capture's box (below) goes to the loss, the renderer and the meta.
        def init_fn(generator, dev):
            return GridNeRF(cfg.grid_cfg(), generator=generator, device=dev)

    model, optimizer = init_train_state(
        torch.Generator().manual_seed(cfg.seed), settings, device=device, init_fn=init_fn
    )

    start_step = 0
    if cfg.resume and ckpt_lib.latest_exists(cfg.ckpt_path):
        start_step, _ = ckpt_lib.restore_checkpoint(cfg.ckpt_path, model, optimizer)
        print(f"[resume] loaded {cfg.ckpt_path} from step {start_step}")

    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, poses)
    if cfg.ndc:
        # A forward-facing capture: every ray in NDC space (near plane 1.0),
        # before the holdout and any sharding; sampling runs over t in [0, 1]
        # (train_settings() swaps near/far).
        rays_o_all, rays_d_all = ndc_rays(H, W, focal, 1.0, rays_o_all, rays_d_all)
        print("[ndc] rays reprojected to NDC space (sampling t in [0,1])")
    pixels = images.reshape(n_images, H * W, 3)
    # The sparsity prior's and the occupancy grid's box bounds every pose's
    # sample points, the held-out ones included.
    rays_o_full, rays_d_full = rays_o_all, rays_d_all

    n_train = n_images - cfg.holdout
    if cfg.holdout_mode not in ("tail", "strided"):
        raise ValueError(f"holdout_mode={cfg.holdout_mode!r} (expected 'tail'|'strided')")
    holdout_indices = list(range(n_train, n_images))
    if cfg.holdout > 0:
        if n_train < 1:
            raise ValueError(f"--holdout {cfg.holdout} leaves no training pose of {n_images}")
        if cfg.holdout_mode == "strided":
            # Evenly spread over the capture, then reordered so that the
            # held-out poses sit at the tail; the checkpoint's meta keeps
            # their original indices.
            hold = strided_holdout(n_images, cfg.holdout)
            order = torch.tensor([i for i in range(n_images) if i not in hold] + hold,
                                 device=device)
            images, poses = images[order], poses[order]
            rays_o_all, rays_d_all, pixels = rays_o_all[order], rays_d_all[order], pixels[order]
            holdout_indices = hold
            print(f"[eval] strided holdout: original poses {hold}")
        rays_o_all, rays_d_all = rays_o_all[:n_train], rays_d_all[:n_train]
        pixels = pixels[:n_train]
        print(f"[eval] holding out poses {n_train}..{n_images - 1}")
    if cfg.eval_every > 0 and cfg.holdout <= 0:
        raise ValueError("--eval-every > 0 requires --holdout > 0 (nothing held out to evaluate; "
                         "it would silently score training views)")

    # The scene box: the NDC cube under --ndc, else the box of every ray's
    # [near, far] segment.
    scene_aabb = (default_aabb(1.0, device=device) if cfg.ndc
                  else aabb_from_rays(rays_o_full, rays_d_full, cfg.near, cfg.far))
    gcfg = None
    if grid:
        # The encoder normalizes over the box of every reachable sample
        # point, the held-out poses' included.
        gcfg = cfg.grid_cfg(aabb=scene_aabb)
        loss = make_grid_loss(gcfg)
        box = scene_aabb.cpu().numpy()
        print(f"[model] grid: levels={gcfg.level_resolutions()} "
              f"dense={sum(gcfg.level_is_dense())}/{gcfg.n_levels} "
              f"aabb=[{box[0].round(2)}, {box[1].round(2)}] "
              f"directions={gcfg.dir_encoding} sigma={gcfg.density_activation} "
              f"params={sum(p.numel() for p in model.parameters())}")
        print("[train] grid family: eager torch, no kernel: the JAX package's XLA path (--fused "
              "and --fused-train do not apply)")
    extra_grad_fn = None
    if cfg.sigma_sparsity > 0:
        from tinynerf_tpu_torch.ops.regularizers import make_sparsity_grad_fn

        extra_grad_fn = make_sparsity_grad_fn(
            settings, cfg.model, nerf_cfg=gcfg if grid else ncfg if nerf else None,
            lam=cfg.sigma_sparsity,
            n_points=cfg.sigma_sparsity_points, aabb=scene_aabb)
        print(f"[train] free-space sparsity prior: lam={cfg.sigma_sparsity} over "
              f"{cfg.sigma_sparsity_points} pts/step")

    grad_fn = None
    on_card = device.type == "cuda"
    if occupancy:
        # One MLP takes the whole quadrature budget, n_samples + n_fine
        # depths from the grid.
        occ_settings = dataclasses.replace(settings, n_samples=cfg.n_samples + cfg.n_fine)
        if cfg.fused_train:
            where = "CUDA kernel" if on_card else "its plain version on the CPU"
            print(f"[train] occupancy proposal + the streamed fused kernel K6 ({where}; grid "
                  "rebuilt once per block)")
        else:
            print("[train] occupancy proposal (grid rebuilt once per block)")
    elif cfg.fused_train and cfg.sample_parallel <= 1 and not grid:
        route = "CUDA kernel" if on_card else "its plain version on the CPU"
        if nerf:
            from tinynerf_tpu_torch.kernels.fused_nerf_train import (
                fine_pass_route,
                make_fused_nerf_grad_fn,
                uses_tensor_cores,
                walk_route,
            )

            grad_fn = make_fused_nerf_grad_fn(settings, ncfg, n_fine=cfg.n_fine)
            block = fine_pass_route(settings, ncfg, cfg.n_fine)
            s_union = cfg.n_samples + cfg.n_fine
            fine = "K4" if block is None else f"streamed K6, sample block {block}"
            coarse = "K4"
            if on_card:
                coarse += f" ({walk_route(ncfg, cfg.n_samples, cfg.n_samples)})"
                fine += f" ({walk_route(ncfg, s_union, block or s_union)})"
            walk = f" (the {'tensor' if uses_tensor_cores(ncfg) else 'CUDA'}-core walk)"
            route = (f"{'CUDA kernels' if on_card else 'their plain versions on the CPU'}: "
                     f"coarse pass {coarse}, fine pass {fine}{walk if on_card else ''}")
        else:
            from tinynerf_tpu_torch.kernels.fused_train import k2_route, make_fused_grad_fn

            grad_fn = make_fused_grad_fn(settings)
            if on_card:
                route += f" (K2: {k2_route(settings.model_cfg, settings.n_samples)})"
        print(f"[train] fused fwd+bwd train route: {route}")

    eff_near, eff_far = (0.0, 1.0) if cfg.ndc else (cfg.near, cfg.far)
    if occupancy:
        renderer = make_occupancy_image_renderer(
            H=H, W=W, focal=focal, chunk=min(cfg.chunk, 4096),
            n_samples=cfg.n_samples + cfg.n_fine, near=eff_near, far=eff_far, nerf_cfg=ncfg,
            use_fused=cfg.fused, ndc=cfg.ndc, aabb=scene_aabb,
        )
    elif grid:
        renderer = make_grid_image_renderer(
            H=H, W=W, focal=focal, grid_cfg=gcfg, chunk=cfg.chunk, n_samples=cfg.n_samples,
            near=eff_near, far=eff_far, ndc=cfg.ndc,
        )
    elif nerf:
        renderer = make_hierarchical_image_renderer(
            H=H, W=W, focal=focal, chunk=min(cfg.chunk, 4096), n_coarse=cfg.n_samples,
            n_fine=cfg.n_fine, near=eff_near, far=eff_far, nerf_cfg=ncfg, use_fused=cfg.fused,
            ndc=cfg.ndc,
        )
    else:
        renderer = make_image_renderer(
            H=H, W=W, focal=focal, chunk=cfg.chunk, n_samples=cfg.n_samples,
            near=eff_near, far=eff_far, num_freqs=cfg.num_freqs,
            model_cfg=cfg.model_cfg(), use_fused=cfg.fused, ndc=cfg.ndc,
        )
    if nerf or grid:
        mcfg = {
            "hidden": cfg.hidden, "depth": cfg.nerf_depth, "skip_at": cfg.nerf_skip_at,
            "num_freqs": cfg.num_freqs, "num_freqs_dir": cfg.num_freqs_dir,
            "rgb_hidden": cfg.rgb_hidden, "n_fine": cfg.n_fine, "ndc": cfg.ndc,
            "proposal": cfg.proposal,
            # The grid's box: a renderer must rebuild the sampler over it.
            **({"occ_aabb": scene_aabb.cpu().tolist()} if occupancy else {}),
            # The grid family's shapes and the box its tables were trained in.
            **({"grid": {"levels": cfg.grid_levels, "features": cfg.grid_features,
                         "base_res": cfg.grid_base_res, "max_res": cfg.grid_max_res,
                         "table_size": cfg.grid_table_size, "hidden": cfg.grid_hidden,
                         "aabb": list(gcfg.aabb), **grid_form_meta(gcfg)}} if grid else {}),
        }
    else:
        mcfg = {"hidden": cfg.hidden, "depth": cfg.depth, "skip_at": cfg.skip_at,
                "num_freqs": cfg.num_freqs, "ndc": cfg.ndc}

    meta = {
        "in_dim": cfg.model_cfg().in_dim,
        "model": cfg.model,
        **(
            {"holdout": {"count": cfg.holdout, "mode": cfg.holdout_mode,
                         "indices": holdout_indices}}
            if cfg.holdout > 0 else {}
        ),
        "cfg": mcfg,
    }

    def save_ckpt(step: int):
        if is_main:
            if optimizer.ema is not None:
                # The Polyak twin: params + step + meta, no optimizer state,
                # which eval and make_gif read (--ema).
                ckpt_lib.save_params(cfg.ckpt_path + ".ema.npz", model, step, meta=meta,
                                     params=optimizer.ema)
            if cfg.ckpt_keep > 0:
                ckpt_lib.save_checkpoint_rotating(cfg.ckpt_path, model, optimizer, step,
                                                  meta=meta, keep=cfg.ckpt_keep)
            else:
                ckpt_lib.save_checkpoint(cfg.ckpt_path, model, optimizer, step, meta=meta)
        barrier()

    ema_model = None

    def evaluate(idx):
        """evaluate_views on the poses idx with the raw weights, and with the
        EMA weights when the optimizer keeps them (else None)."""
        nonlocal ema_model
        res = evaluate_views(renderer, model, images, poses, idx)
        if optimizer.ema is None:
            return res, None
        if ema_model is None:
            ema_model = copy.deepcopy(model)
        with torch.no_grad():
            for p, e in zip(ema_model.parameters(), optimizer.ema):
                p.copy_(e)
        return res, evaluate_views(renderer, ema_model, images, poses, idx)

    death = None
    if cfg.death_check:
        bg_psnr = background_psnr(pixels, white_bkgd=settings.white_bkgd)
        death = SigmaDeathDetector(bg_psnr, margin=cfg.death_margin, window=cfg.death_window,
                                   grace=cfg.death_grace)
        if death.enabled and is_main:
            print(f"[train] sigma-death watchdog: background floor {bg_psnr:.2f} dB (aborts if "
                  f"train PSNR pins within {cfg.death_margin} dB of it for {cfg.death_window} "
                  f"log points after step {cfg.death_grace})")

    if occupancy:
        from tinynerf_tpu_torch.ops.occupancy import make_occupancy_train_block

        occ_mesh = None
        if cfg.data_parallel and world > 1:
            from tinynerf_tpu_torch.parallel.mesh import make_mesh

            occ_mesh = make_mesh()
            print(f"[train] mesh: data {occ_mesh.n_data} x sample 1 over {world} ranks")

        def block_factory(n):
            return make_occupancy_train_block(occ_settings, n, ncfg, fused=cfg.fused_train,
                                              aabb=scene_aabb, mesh=occ_mesh,
                                              extra_grad_fn=extra_grad_fn)
    elif cfg.data_parallel and world > 1:
        from tinynerf_tpu_torch.parallel.mesh import make_mesh
        from tinynerf_tpu_torch.parallel.train import make_sharded_train_block

        mesh = make_mesh(sample_parallel=cfg.sample_parallel)
        if nerf and cfg.sample_parallel > 1:
            # The sharded hierarchical loss; with --fused-train each rank's
            # passes run K7 (kernels/fused_partials.py).
            if cfg.fused_train:
                print("[train] fused block-partials kernels (K7) on the sample mesh")

            def block_factory(n):
                return make_sharded_train_block(settings, n, mesh, nerf_cfg=ncfg,
                                                n_fine=cfg.n_fine, fused_kernels=cfg.fused_train,
                                                extra_grad_fn=extra_grad_fn)
        else:
            def block_factory(n):
                return make_sharded_train_block(settings, n, mesh, loss=loss, grad_fn=grad_fn,
                                                extra_grad_fn=extra_grad_fn)
        print(f"[train] mesh: data {mesh.n_data} x sample {mesh.n_sample} over {world} ranks")
    else:
        def block_factory(n):
            return make_train_block(settings, n, loss=loss, grad_fn=grad_fn,
                                    extra_grad_fn=extra_grad_fn)

    blocks = {}  # block_size -> block function
    last = {}
    metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path and is_main else None
    eval_secs = 0.0  # in-loop held-out evaluations, excluded from the rays/s denominator
    # --profile-dir: a torch.profiler trace of the training loop, started and
    # stopped where the JAX trainer starts and stops its jax.profiler trace.
    profiler = contextlib.ExitStack()
    profiler.enter_context(trace(cfg.profile_dir))
    try:
        _sync(device)
        t0 = time.time()
        for block_start, block_len in _boundaries(
            start_step, cfg.iters, cfg.log_every, cfg.preview_every, cfg.ckpt_every,
            cfg.eval_every,
        ):
            if block_len not in blocks:
                blocks[block_len] = block_factory(block_len)
            metrics = blocks[block_len](
                model, optimizer, cfg.seed, block_start, rays_o_all, rays_d_all, pixels
            )
            step_end = block_start + block_len

            if step_end % cfg.log_every == 0 or step_end == cfg.iters:
                last = {"loss": float(metrics["loss"][-1]), "psnr": float(metrics["psnr"][-1])}
                if is_main:
                    print(f"[train] step {step_end}/{cfg.iters} loss {last['loss']:.6f} "
                          f"psnr {last['psnr']:.2f}", flush=True)
                if metrics_f:
                    metrics_f.write(json.dumps({"step": step_end, **last}) + "\n")
                    metrics_f.flush()
                if death is not None and death.update(step_end, last["psnr"]):
                    save_ckpt(step_end)
                    if metrics_f:
                        metrics_f.write(json.dumps({
                            "step": step_end, "sigma_death": True,
                            "bg_psnr": round(death.bg_psnr, 3),
                            "pinned_since": death.first_pinned_step}) + "\n")
                        metrics_f.flush()
                    if is_main:
                        print(
                            f"\n[SIGMA DEATH] train PSNR pinned within {cfg.death_margin} dB of "
                            f"the background-only floor ({death.bg_psnr:.2f} dB) for "
                            f"{cfg.death_window} consecutive log points (since step "
                            f"{death.first_pinned_step}): the render is background-constant -- "
                            "raw sigma has collapsed below the ReLU, gradients are zero, and "
                            "the run cannot recover. Rescue levers: --precrop-iters 500 "
                            "(center-crop warmup), --sigma-noise-std/--sigma-noise-decay-steps "
                            "sized to the scene, --ray-sampling image, or --model grid. Aborting "
                            f"instead of burning the remaining {cfg.iters - step_end} steps "
                            "(checkpoint saved; --no-death-check disables).", flush=True)
                    raise SystemExit(3)

            if cfg.eval_every > 0 and step_end % cfg.eval_every == 0 and step_end != cfg.iters:
                # The held-out learning curve (the final evaluation covers
                # the last step).
                if is_main:
                    t_ev = time.time()
                    ev, ev_ema = evaluate(list(range(n_train, n_images)))
                    eval_secs += time.time() - t_ev
                    print(f"[eval] step {step_end} held-out PSNR mean {ev['psnr_mean']:.2f} dB"
                          + (f", EMA {ev_ema['psnr_mean']:.2f} dB" if ev_ema else ""), flush=True)
                    if metrics_f:
                        metrics_f.write(json.dumps({
                            "step": step_end, "eval": ev, "kind": "held-out",
                            **({"eval_ema": ev_ema} if ev_ema else {})}) + "\n")
                        metrics_f.flush()
                barrier()

            if step_end % cfg.preview_every == 0:
                # The reference's (step % N)+1 preview pose over the poses
                # actually trained on; an explicit --preview-pose may name
                # any pose, held-out ones included.
                if cfg.preview_pose is None:
                    pose_idx = ((step_end - 1) % n_train + 1) % n_train
                else:
                    pose_idx = cfg.preview_pose % n_images
                if is_main:
                    img = renderer(model, poses[pose_idx])
                    write_png(f"{cfg.out_dir}/preview_{step_end:06d}.png", img.cpu().numpy())
                barrier()

            if step_end % cfg.ckpt_every == 0:
                save_ckpt(step_end)
        _sync(device)
        dt = time.time() - t0 - eval_secs
    finally:
        profiler.close()
        if metrics_f:
            metrics_f.close()

    save_ckpt(cfg.iters)
    eval_res = eval_res_ema = None
    if is_main:
        img = renderer(model, poses[-1])
        write_png(f"{cfg.out_dir}/final.png", img.cpu().numpy())

        # Novel-view PSNR: held-out poses when available, else a spread of
        # training views.
        if cfg.holdout > 0:
            eval_idx, eval_kind = list(range(n_train, n_images)), "held-out"
        else:
            eval_idx = list(range(0, n_images, max(1, n_images // 8)))[:8]
            eval_kind = "train-view"
        eval_res, eval_res_ema = evaluate(eval_idx)
        print(
            f"[eval] {eval_kind} PSNR over {len(eval_idx)} views: "
            f"mean {eval_res['psnr_mean']:.2f} dB "
            f"(min {eval_res['psnr_min']:.2f}, max {eval_res['psnr_max']:.2f})"
        )
        if eval_res_ema is not None:
            print(f"[eval] {eval_kind} PSNR (EMA weights): mean "
                  f"{eval_res_ema['psnr_mean']:.2f} dB")
        if cfg.metrics_path:
            with open(cfg.metrics_path, "a") as f:
                f.write(json.dumps({"step": cfg.iters, "eval": eval_res, "kind": eval_kind,
                                    "final": True,
                                    **({"eval_ema": eval_res_ema} if eval_res_ema else {})})
                        + "\n")
    if world > 1:
        def digest(tensors):
            h = hashlib.sha256()
            for t in tensors:
                h.update(t.detach().cpu().numpy().tobytes())
            return h.hexdigest()

        ema = "" if optimizer.ema is None else f", EMA digest {digest(optimizer.ema)}"
        print(f"[distributed] rank {dist.get_rank()}/{world} parameter digest "
              f"{digest(model.parameters())}{ema}, kernel launches "
              f"{json.dumps(_kernel_launches())}", flush=True)
        barrier()
    if owns_group:
        dist.destroy_process_group()

    trained_steps = cfg.iters - start_step
    rays_per_sec = (trained_steps * cfg.n_rand / dt) if dt > 0 and trained_steps > 0 else 0.0
    if is_main:
        print(
            f"[done] {cfg.iters} iters in {(time.time() - t_start) / 60:.2f} min "
            f"(train loop {dt:.1f}s, {rays_per_sec:,.0f} rays/s) | "
            f"saved {cfg.ckpt_path} and {cfg.out_dir}/final.png"
        )
    return {
        "final_psnr": last.get("psnr"),
        "eval": eval_res,
        "eval_ema": eval_res_ema,
        "rays_per_sec": rays_per_sec,
        "model": model,
        "optimizer": optimizer,
    }


if __name__ == "__main__":
    main(cli(Config,
             description="Train TinyNeRF, the full NeRF or the grid family (PyTorch + CUDA)"))
