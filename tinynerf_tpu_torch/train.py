"""Training driver: `python -m tinynerf_tpu_torch.train --iters 20000 ...`

Port of the TinyNeRF and full-NeRF (coarse proposal) branches of
tinynerf_tpu/train.py:36-738: seed and data, model and Adam, resume of
params, optimizer and step from the checkpoint, rays precomputed for
every pose, an optional tail holdout, steps in blocks cut at every
log/preview/checkpoint boundary, a log line and a JSONL record every
log_every, preview PNGs, checkpoints, the final checkpoint and
final.png, the final evaluation and the "[done] ... rays/s" line. The
checkpoint's meta is the JAX driver's (the TinyNeRF subset for
--model tinynerf), so the JAX eval and make_gif read it and the JAX
trainer resumes it.

Gradients go through the fused CUDA train kernels unless
--no-fused-train, which runs the loss (training.loss_fn, or
models/nerf.make_hierarchical_loss for --model nerf) with autograd:
TinyNeRF through K2 (kernels/fused_train.py), the full NeRF through K4
for the coarse pass and K4 or the streamed K6 for the fine pass
(kernels/fused_nerf_train.py). The NeRF's previews and evaluation render
through the hierarchical renderer (K3/K5 with --fused). Metrics stay on
the device inside a block; the host reads them only at a log point.

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

import hashlib
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.evaluation import evaluate_views
from tinynerf_tpu_torch.main import _sync
from tinynerf_tpu_torch.ops.rays import get_rays_for_poses
from tinynerf_tpu_torch.models.nerf import NeRF, make_hierarchical_loss
from tinynerf_tpu_torch.render import make_hierarchical_image_renderer, make_image_renderer
from tinynerf_tpu_torch.training import init_train_state, make_train_block
from tinynerf_tpu_torch.utils import checkpoint as ckpt_lib
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png


def _kernel_launches() -> dict:
    """The launch count of every kernel wrapper this process imported (a
    function of kernels/ with a `launches` counter), by name, and as
    `<name>.mma_launches` the count of its tensor-core launches where it
    keeps one."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("tinynerf_tpu_torch.kernels."):
            for attr, fn in vars(mod).items():
                if getattr(fn, "__module__", None) == name and hasattr(fn, "launches"):
                    counts[attr] = fn.launches
                    if hasattr(fn, "mma_launches"):
                        counts[f"{attr}.mma_launches"] = fn.mma_launches
    return counts


def _boundaries(start: int, end: int, *cadences: int):
    """Yield (block_start, block_len) segments cut at every cadence multiple."""
    step = start
    while step < end:
        nxt = min([end] + [((step // c) + 1) * c for c in cadences if c > 0])
        yield step, nxt - step
        step = nxt


def main(cfg: Config = Config()) -> dict:
    if cfg.model not in ("tinynerf", "nerf"):
        raise NotImplementedError(
            f"training --model {cfg.model} is not ported yet (ROADMAP.md, queue 1, item 12)"
        )
    if cfg.proposal not in ("coarse", "occupancy"):
        raise ValueError(f"unknown proposal {cfg.proposal!r} (coarse|occupancy)")
    if cfg.proposal == "occupancy":
        if cfg.model != "nerf":
            raise ValueError("--proposal occupancy requires --model nerf")
        raise NotImplementedError(
            "the occupancy proposal is not ported yet (ROADMAP.md, queue 1, item 11)"
        )
    nerf = cfg.model == "nerf"
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
    print(f"[train] sigma_noise(std={settings.sigma_noise_std})")
    loss = init_fn = None
    if nerf:
        ncfg = cfg.nerf_cfg()
        loss = make_hierarchical_loss(ncfg, n_fine=cfg.n_fine)

        def init_fn(generator, dev):
            return NeRF(ncfg, generator=generator, device=dev)

    model, optimizer = init_train_state(
        torch.Generator().manual_seed(cfg.seed), settings, device=device, init_fn=init_fn
    )

    start_step = 0
    if cfg.resume and ckpt_lib.latest_exists(cfg.ckpt_path):
        start_step, _ = ckpt_lib.restore_checkpoint(cfg.ckpt_path, model, optimizer)
        print(f"[resume] loaded {cfg.ckpt_path} from step {start_step}")

    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, poses)
    pixels = images.reshape(n_images, H * W, 3)

    n_train = n_images - cfg.holdout
    holdout_indices = list(range(n_train, n_images))
    if cfg.holdout > 0:
        if n_train < 1:
            raise ValueError(f"--holdout {cfg.holdout} leaves no training pose of {n_images}")
        rays_o_all, rays_d_all = rays_o_all[:n_train], rays_d_all[:n_train]
        pixels = pixels[:n_train]
        print(f"[eval] holding out poses {n_train}..{n_images - 1}")

    grad_fn = None
    if cfg.fused_train and cfg.sample_parallel <= 1:
        on_card = device.type == "cuda"
        route = "CUDA kernel" if on_card else "its plain version on the CPU"
        if nerf:
            from tinynerf_tpu_torch.kernels.fused_nerf_train import (
                fine_pass_route,
                make_fused_nerf_grad_fn,
            )

            grad_fn = make_fused_nerf_grad_fn(settings, ncfg, n_fine=cfg.n_fine)
            block = fine_pass_route(settings, ncfg, cfg.n_fine)
            fine = "K4" if block is None else f"streamed K6, sample block {block}"
            route = (f"{'CUDA kernels' if on_card else 'their plain versions on the CPU'}: "
                     f"coarse pass K4, fine pass {fine}")
        else:
            from tinynerf_tpu_torch.kernels.fused_train import make_fused_grad_fn

            grad_fn = make_fused_grad_fn(settings)
        print(f"[train] fused fwd+bwd train route: {route}")

    if nerf:
        renderer = make_hierarchical_image_renderer(
            H=H, W=W, focal=focal, chunk=min(cfg.chunk, 4096), n_coarse=cfg.n_samples,
            n_fine=cfg.n_fine, near=cfg.near, far=cfg.far, nerf_cfg=ncfg, use_fused=cfg.fused,
        )
        mcfg = {
            "hidden": cfg.hidden, "depth": cfg.nerf_depth, "skip_at": cfg.nerf_skip_at,
            "num_freqs": cfg.num_freqs, "num_freqs_dir": cfg.num_freqs_dir,
            "rgb_hidden": cfg.rgb_hidden, "n_fine": cfg.n_fine, "ndc": False,
            "proposal": cfg.proposal,
        }
    else:
        renderer = make_image_renderer(
            H=H, W=W, focal=focal, chunk=cfg.chunk, n_samples=cfg.n_samples,
            near=cfg.near, far=cfg.far, num_freqs=cfg.num_freqs,
            model_cfg=cfg.model_cfg(), use_fused=cfg.fused,
        )
        mcfg = {"hidden": cfg.hidden, "depth": cfg.depth, "skip_at": cfg.skip_at,
                "num_freqs": cfg.num_freqs, "ndc": False}

    meta = {
        "in_dim": cfg.model_cfg().in_dim,
        "model": cfg.model,
        **(
            {"holdout": {"count": cfg.holdout, "mode": "tail", "indices": holdout_indices}}
            if cfg.holdout > 0 else {}
        ),
        "cfg": mcfg,
    }

    def save_ckpt(step: int):
        if is_main:
            ckpt_lib.save_checkpoint(cfg.ckpt_path, model, optimizer, step, meta=meta)
        barrier()

    if cfg.data_parallel and world > 1:
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
                                                n_fine=cfg.n_fine, fused_kernels=cfg.fused_train)
        else:
            def block_factory(n):
                return make_sharded_train_block(settings, n, mesh, loss=loss, grad_fn=grad_fn)
        print(f"[train] mesh: data {mesh.n_data} x sample {mesh.n_sample} over {world} ranks")
    else:
        def block_factory(n):
            return make_train_block(settings, n, loss=loss, grad_fn=grad_fn)

    blocks = {}  # block_size -> block function
    last = {}
    metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path and is_main else None
    try:
        _sync(device)
        t0 = time.time()
        for block_start, block_len in _boundaries(
            start_step, cfg.iters, cfg.log_every, cfg.preview_every, cfg.ckpt_every
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
        dt = time.time() - t0
    finally:
        if metrics_f:
            metrics_f.close()

    save_ckpt(cfg.iters)
    eval_res = None
    if is_main:
        img = renderer(model, poses[-1])
        write_png(f"{cfg.out_dir}/final.png", img.cpu().numpy())

        # Novel-view PSNR: held-out poses when available, else a spread of
        # training views.
        if cfg.holdout > 0:
            eval_idx, eval_kind = holdout_indices, "held-out"
        else:
            eval_idx = list(range(0, n_images, max(1, n_images // 8)))[:8]
            eval_kind = "train-view"
        eval_res = evaluate_views(renderer, model, images, poses, eval_idx)
        print(
            f"[eval] {eval_kind} PSNR over {len(eval_idx)} views: "
            f"mean {eval_res['psnr_mean']:.2f} dB "
            f"(min {eval_res['psnr_min']:.2f}, max {eval_res['psnr_max']:.2f})"
        )
        if cfg.metrics_path:
            with open(cfg.metrics_path, "a") as f:
                f.write(json.dumps({"step": cfg.iters, "eval": eval_res, "kind": eval_kind,
                                    "final": True}) + "\n")
    if world > 1:
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        print(f"[distributed] rank {dist.get_rank()}/{world} parameter digest "
              f"{digest.hexdigest()}, kernel launches {json.dumps(_kernel_launches())}", flush=True)
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
        "rays_per_sec": rays_per_sec,
        "model": model,
    }


if __name__ == "__main__":
    main(cli(Config, description="Train TinyNeRF or the full NeRF (PyTorch + CUDA)"))
