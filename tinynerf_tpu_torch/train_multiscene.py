"""Multi-scene batched training driver (BASELINE config 5):
`python -m tinynerf_tpu_torch.train_multiscene --scenes 8 --size 400`

Port of tinynerf_tpu/train_multiscene.py:36-193. Trains K independent
TinyNeRFs (or, with --model nerf, hierarchical NeRFs with view
directions) in lockstep, one per seeded synthetic scene at the requested
resolution (default 400x400, 16 poses; generate_synthetic_dataset(seed=k)
cached as data/multiscene/scene_{k:03d}_{size}.npz), through
multiscene.py. Reports the scenes' mean and min train PSNR every
log_every steps and the aggregate rays/s, then writes one batched
checkpoint (meta {"scenes", "size", "model": "<model>-multiscene"}, the
JAX package's layout: every leaf with the leading scene axis) and a
preview of each of the first four scenes.

One documented divergence, as in config.py: `fused_train` defaults to
True here (--no-fused-train for the eager autograd step). The fused step
trains every scene of a step in one launch of the train kernels, whose
grids carry the scene axis: K2 for the TinyNeRF, K4 for both NeRF passes
at hidden 128 and K4 coarse + the streamed K6 fine at the flagship
widths (fine_pass_route, the JAX package's rule). Previews render
through K1 (TinyNeRF) or the hierarchical renderer (K3, K5 for large
unions).

Under `python -m torch.distributed.run --nproc-per-node N` each rank
trains K/N of the scenes (N must divide K) with no collective in the
update; the logged PSNRs and the checkpoint are gathered to rank 0.

    python -m tinynerf_tpu_torch.train_multiscene --scenes 8 --size 400
    python -m tinynerf_tpu_torch.train_multiscene --model nerf [--hidden 256 --n-fine 128]
    python -m torch.distributed.run --nproc-per-node 2 -m tinynerf_tpu_torch.train_multiscene
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tinynerf_tpu_torch.main import _sync
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, make_hierarchical_loss
from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.multiscene import (
    gather_scenes,
    gather_state,
    init_multiscene_state,
    local_scenes,
    make_multiscene_train_block,
    scene_params,
)
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.ops.rays import get_rays_for_poses
from tinynerf_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    pick_backend,
    rank_device,
)
from tinynerf_tpu_torch.render import make_hierarchical_image_renderer, make_image_renderer
from tinynerf_tpu_torch.training import TrainSettings
from tinynerf_tpu_torch.utils import checkpoint as ckpt_lib
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png


@dataclass
class MultiSceneConfig:
    scenes: int = 8
    size: int = 400  # image H = W
    poses_per_scene: int = 16
    iters: int = 2000
    n_rand: int = 1024  # rays per scene per step
    n_samples: int = 64
    lr: float = 5e-4
    near: float = 2.0
    far: float = 6.0
    num_freqs: int = 10
    hidden: int = 128
    log_every: int = 100
    seed: int = 0
    out_dir: str = "outputs/multiscene"
    ckpt_path: str = "checkpoints/multiscene.npz"
    data_dir: str = "data/multiscene"
    preview: bool = True
    model: str = "tinynerf"  # "tinynerf" | "nerf" (hierarchical+viewdirs)
    n_fine: int = 64  # fine samples per ray (nerf model)
    fused_train: bool = True  # one fused train-kernel launch a step for every scene
    n_devices: Optional[int] = None  # the process group's ranks (None: all; else must match)
    device: str = "cuda"


def _load_or_make_scene(cfg: MultiSceneConfig, k: int, device) -> dict:
    """Scene k: its cache file, else generate_synthetic_dataset(seed=k)
    rendered on `device` and cached."""
    from tinynerf_tpu_torch.data import load_tiny_nerf_npz
    from tinynerf_tpu_torch.synthetic import generate_synthetic_dataset

    path = f"{cfg.data_dir}/scene_{k:03d}_{cfg.size}.npz"
    if os.path.exists(path):
        return load_tiny_nerf_npz(path)
    d = generate_synthetic_dataset(n_poses=cfg.poses_per_scene, h=cfg.size, w=cfg.size, seed=k,
                                   device=device)
    os.makedirs(cfg.data_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, images=d["images"], poses=d["poses"], focal=d["focal"])
    os.replace(tmp, path)
    return d


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main(cfg: MultiSceneConfig) -> dict:
    if cfg.model not in ("tinynerf", "nerf"):
        raise ValueError(f"unknown model {cfg.model!r} (tinynerf|nerf)")
    device = torch.device(cfg.device)
    owns_group = not dist.is_initialized()
    backend, why = pick_backend(device.type)
    if initialize_distributed(backend=backend, device_type=device.type):
        device = rank_device(cfg.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    owns_group = owns_group and dist.is_initialized()
    if not dist.is_initialized() and (cfg.n_devices or 1) != 1:
        raise ValueError(f"--n-devices {cfg.n_devices} needs that many ranks: launch with "
                         f"python -m torch.distributed.run --nproc-per-node {cfg.n_devices}")
    mesh = make_mesh(n_devices=cfg.n_devices)
    world, rank = mesh.n_data, mesh.rank
    is_main = rank == 0
    scene_ids = local_scenes(cfg.scenes, mesh)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[mesh] {world} rank(s){f' ({backend}: {why})' if world > 1 else ''}; rank {rank} "
          f"trains scenes {scene_ids[0]}-{scene_ids[-1]} on {device} ({name})", flush=True)
    os.makedirs(cfg.out_dir, exist_ok=True)

    print(f"[data] generating/loading {len(scene_ids)} scenes at {cfg.size}x{cfg.size}",
          flush=True)
    t0 = time.time()
    scenes = [_load_or_make_scene(cfg, k, device) for k in scene_ids]
    H = W = cfg.size
    focal = float(scenes[0]["focal"])
    images = torch.from_numpy(np.stack([s["images"] for s in scenes])).to(device)  # (K,N,H,W,3)
    poses = torch.from_numpy(np.stack([s["poses"] for s in scenes])).to(device)  # (K,N,4,4)
    print(f"[data] ready in {time.time() - t0:.1f}s; images {tuple(images.shape)}", flush=True)
    rays = [get_rays_for_poses(H, W, focal, ps) for ps in poses]
    rays_o = torch.stack([r[0] for r in rays])
    rays_d = torch.stack([r[1] for r in rays])
    pixels = images.reshape(len(scene_ids), cfg.poses_per_scene, H * W, 3)
    del rays, images

    s = TrainSettings(
        n_rand=cfg.n_rand, n_samples=cfg.n_samples, near=cfg.near, far=cfg.far,
        num_freqs=cfg.num_freqs, lr=cfg.lr,
        # --hidden applies to both model families.
        model_cfg=TinyNeRFConfig(in_dim=encoding_dim(cfg.num_freqs), hidden=cfg.hidden),
    )
    loss = init_fn = ncfg = None
    if cfg.model == "nerf":
        ncfg = NeRFConfig(num_freqs=cfg.num_freqs, hidden=cfg.hidden)
        loss = make_hierarchical_loss(ncfg, n_fine=cfg.n_fine)

        def init_fn(generator, dev):
            return NeRF(ncfg, generator=generator, device=dev)

    model, optimizer = init_multiscene_state(cfg.seed, cfg.scenes, s, device=device,
                                             init_fn=init_fn, mesh=mesh)
    grad_fn = None
    if cfg.fused_train:
        if cfg.model == "nerf":
            from tinynerf_tpu_torch.kernels.fused_nerf_train import make_fused_nerf_grad_fn_scenes

            grad_fn = make_fused_nerf_grad_fn_scenes(s, ncfg, n_fine=cfg.n_fine)
            route = ""
        else:
            from tinynerf_tpu_torch.kernels.fused_train import k2_route, make_fused_grad_fn_scenes

            grad_fn = make_fused_grad_fn_scenes(s)
            route = f" (K2: {k2_route(s.model_cfg, s.n_samples)})" if device.type == "cuda" else ""
        print(f"[train] fused train kernel enabled: one launch a step for every scene{route}",
              flush=True)

    step_seed = cfg.seed + 1  # the JAX driver's PRNGKey(seed + 1) for the steps
    t0 = time.time()
    last, first_psnr = {}, None
    for b in range(0, cfg.iters, cfg.log_every):
        n = min(cfg.log_every, cfg.iters - b)
        block = make_multiscene_train_block(s, n, cfg.scenes, mesh, loss=loss, grad_fn=grad_fn)
        m = block(model, optimizer, step_seed, b, rays_o, rays_d, pixels)
        psnr = gather_scenes(m["psnr"][[0, -1]].T.contiguous(), mesh).cpu().numpy()  # (K, 2)
        if first_psnr is None:
            first_psnr = psnr[:, 0]
        last = {"psnr_mean": float(psnr[:, 1].mean()), "psnr_min": float(psnr[:, 1].min())}
        if is_main:
            print(f"[train] step {b + n}/{cfg.iters} x{cfg.scenes} scenes: psnr mean "
                  f"{last['psnr_mean']:.2f} min {last['psnr_min']:.2f}", flush=True)
    _sync(device)
    dt = time.time() - t0
    total_rays = cfg.iters * cfg.n_rand * cfg.scenes
    if is_main:
        print(f"[done] {cfg.iters} iters x {cfg.scenes} scenes in {dt:.1f}s "
              f"({total_rays / dt:,.0f} rays/s aggregate)", flush=True)

    full, full_opt = gather_state(model, optimizer, mesh)
    if world > 1:
        print(f"[distributed] rank {rank}/{world} parameter digest "
              f"{_digest(full.parameters())}", flush=True)
    if is_main:
        ckpt_lib.save_checkpoint(
            cfg.ckpt_path, full, full_opt, cfg.iters,
            meta={"scenes": cfg.scenes, "size": cfg.size, "model": f"{cfg.model}-multiscene"},
            scenes=True,
        )
    if cfg.preview and is_main:
        if cfg.model == "nerf":
            renderer = make_hierarchical_image_renderer(
                H=H, W=W, focal=focal, chunk=4096, n_coarse=cfg.n_samples, n_fine=cfg.n_fine,
                near=cfg.near, far=cfg.far, nerf_cfg=ncfg, use_fused=True,
            )
        else:
            renderer = make_image_renderer(
                H=H, W=W, focal=focal, chunk=8192, n_samples=cfg.n_samples, near=cfg.near,
                far=cfg.far, num_freqs=cfg.num_freqs, model_cfg=s.model_cfg, use_fused=True,
            )
        n_prev = min(cfg.scenes, 4)
        for k in range(n_prev):
            pose = (poses[scene_ids.index(k)] if k in scene_ids else
                    torch.from_numpy(_load_or_make_scene(cfg, k, device)["poses"]).to(device))[0]
            img = renderer(scene_params(full, k), pose)
            write_png(f"{cfg.out_dir}/scene_{k:03d}.png", img.cpu().numpy())
        print(f"[preview] wrote {n_prev} previews to {cfg.out_dir}", flush=True)
    if world > 1:
        dist.barrier()
    if owns_group:
        dist.destroy_process_group()
    return {"rays_per_sec": total_rays / dt, **last, "psnr_first": first_psnr.tolist(),
            "psnr_last": psnr[:, 1].tolist(), "model": full, "optimizer": full_opt}


if __name__ == "__main__":
    main(cli(MultiSceneConfig, description="Batched multi-scene TinyNeRF training (PyTorch + CUDA)"))
