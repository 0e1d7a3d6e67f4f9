"""Multi-scene batched training: K independent NeRFs advance in lockstep.

Port of tinynerf_tpu/multiscene.py:31-123 (BASELINE config 5's
capability). The JAX package vmaps the step over a leading scene axis
inside a lax.scan and shards that axis over the mesh's 'data' axis with
no collective in the update. Here:

- the state is one module whose parameters carry the leading scene axis,
  with the single-scene module's class and names (models/stacked.py), and
  one TrainOptimizer over it (Adam and AdamW are elementwise and the lr
  schedule runs on the one shared count, so this is K optimizers in
  lockstep; the decay mask skips the scene axis);
- scene k (its global index) initialises from a generator seeded with
  scene_seed(seed, k) and draws each step from
  step_generator(scene_seed(seed, k), step): the draws, the jitter seeds
  and sample_pdf's u come from each scene's own generator, outside any
  vmap, so a K-scene run reproduces K single-scene runs (make_train_block
  with seed scene_seed(seed, k)) on their own data;
- the gradient: a fused grad_fn (kernels/fused_train.py::
  make_fused_grad_fn_scenes, kernels/fused_nerf_train.py::
  make_fused_nerf_grad_fn_scenes) trains every scene in one launch of K2,
  or of K4 (and K6) per pass, whose grids carry the scene axis; the eager
  path runs the loss of each scene on its slices of the stacked leaves
  (torch.func.functional_call), sums the losses and takes one backward;
- under torch.distributed each rank is one device of the ('data',) mesh
  (parallel/mesh.py) and trains scenes rank*K/world .. (rank+1)*K/world - 1
  with no collective; a scene count the world does not divide raises
  ValueError.

Metrics come back per local scene, (block, K_local); the driver
(train_multiscene.py) gathers them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tinynerf_tpu_torch.models.stacked import scene_module, scene_state, stack_models, with_params
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF
from tinynerf_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, gather, make_mesh, mesh_axes
from tinynerf_tpu_torch.training import (
    TrainOptimizer,
    TrainSettings,
    draw_ray_batch,
    loss_fn,
    mix_seed,
    noise_scale,
    settings_optimizer,
    step_generator,
)
from tinynerf_tpu_torch.utils.profiling import span


def scene_seed(seed: int, k: int) -> int:
    """Scene k's seed (31 bits, as training.step_generator takes it),
    the counterpart of the JAX package's fold_in(key, k)."""
    return mix_seed(seed, k) & 0x7FFFFFFF


def local_scenes(n_scenes: int, mesh: Optional[Mesh] = None) -> list:
    """The global indices of this rank's scenes: rank*K/world ..
    (rank+1)*K/world - 1 on a ('data',) mesh. Raises ValueError for a
    mesh with a sample axis or a scene count the mesh does not divide."""
    mesh = mesh or make_mesh()
    n_data, n_sample = mesh_axes(mesh)
    if n_sample != 1:
        raise ValueError("multi-scene training uses a 1-D ('data',) mesh")
    if n_scenes % n_data:
        raise ValueError(f"n_scenes={n_scenes} not divisible by mesh size {n_data}")
    k_loc = n_scenes // n_data
    return [mesh.data_idx * k_loc + i for i in range(k_loc)]


def init_multiscene_state(seed: int, n_scenes: int, s: TrainSettings, device=None, init_fn=None,
                          mesh: Optional[Mesh] = None):
    """(model, optimizer) with a leading scene axis: this rank's scenes
    (local_scenes; all n_scenes without a process group), scene k drawn on
    the CPU from torch.Generator().manual_seed(scene_seed(seed, k)), then
    moved to `device`. init_fn(generator, device) -> model overrides the
    TinyNeRF (e.g. a models/nerf.NeRF, the hierarchical pair)."""
    one = init_fn or (lambda gen, dev: TinyNeRF(s.model_cfg, generator=gen, device=dev))
    models = [one(torch.Generator().manual_seed(scene_seed(seed, k)), None)
              for k in local_scenes(n_scenes, mesh)]
    model = stack_models(models).to(device)
    return model, settings_optimizer(model.parameters(), s, batch_dims=1)


class _SceneLoss(nn.Module):
    """loss(model, ...) as a module's forward, so that functional_call can
    run it on one scene's slices of the stacked parameters."""

    def __init__(self, model: nn.Module, loss):
        super().__init__()
        self.model = model
        self.loss = loss

    def forward(self, *args, **kwargs):
        return self.loss(self.model, *args, **kwargs)


def eager_scene_grads(model: nn.Module, loss, ro, rd, target, generators: Sequence, s,
                      noise_scale: float = 1.0):
    """Autograd of the summed per-scene losses into the stacked leaves'
    .grad: scene k's `loss` (training.loss_fn's signature) runs on its
    slices (models/stacked.scene_state) and its own generator; one
    backward. -> metrics of (K,) tensors."""
    wrapper = _SceneLoss(model, loss)
    total, ms = 0.0, []
    with torch.enable_grad():
        for k, gen in enumerate(generators):
            params = {f"model.{n}": p for n, p in scene_state(model, k).items()}
            value, m = torch.func.functional_call(
                wrapper, params, (ro[k], rd[k], target[k], gen, s), {"noise_scale": noise_scale})
            total = total + value
            ms.append(m)
        total.backward()
    return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}


def make_multiscene_train_block(s: TrainSettings, block_size: int, n_scenes: int,
                                mesh: Optional[Mesh] = None, loss=None, grad_fn=None):
    """`block_size` steps of this rank's scenes: (model, optimizer, seed,
    step0, rays_o, rays_d, pixels) -> metrics with shape (block, K_local)
    (device tensors), model and optimizer updated in place.

    rays_o, rays_d, pixels: (K_local, N_images, H*W, 3), this rank's
    scenes in order. `loss` is any training.loss_fn-like loss (default the
    TinyNeRF's; models/nerf.make_hierarchical_loss for the NeRF); grad_fn
    (model, ro, rd, target (K, R, 3), generators, noise_scale=1.0) ->
    (loss (K,), metrics), writing the stacked .grad, replaces autograd
    (the fused kernels' make_fused_grad_fn_scenes,
    make_fused_nerf_grad_fn_scenes). Raises ValueError when the mesh does
    not divide n_scenes or has a sample axis."""
    scene_ids = local_scenes(n_scenes, mesh)
    loss = loss or loss_fn

    def step_body(model, optimizer, seed, step, rays_o, rays_d, pixels):
        if rays_o.shape[0] != len(scene_ids):
            raise ValueError(f"{rays_o.shape[0]} scenes of rays for this rank's "
                             f"{len(scene_ids)} scenes")
        dev = rays_o.device
        with span("step"):
            with span("step.draw"):
                gens = [step_generator(scene_seed(seed, g), step, dev) for g in scene_ids]
                batch = [draw_ray_batch(s, gen, step, rays_o[k], rays_d[k], pixels[k])
                         for k, gen in enumerate(gens)]
                ro, rd, target = (torch.stack(t) for t in zip(*batch))
            scale = noise_scale(s, step)
            optimizer.zero_grad(set_to_none=True)
            with span("step.grad"):
                if grad_fn is not None:
                    _, metrics = grad_fn(model, ro, rd, target, gens, noise_scale=scale)
                else:
                    metrics = eager_scene_grads(model, loss, ro, rd, target, gens, s,
                                                noise_scale=scale)
            with span("step.optimizer"):
                optimizer.step()
        return metrics

    def block(model, optimizer, seed, step0, rays_o, rays_d, pixels):
        ms = [step_body(model, optimizer, seed, step0 + i, rays_o, rays_d, pixels)
              for i in range(block_size)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return block


def scene_params(model: nn.Module, k: int) -> nn.Module:
    """Scene k of the stacked model (a local index) as an ordinary
    single-scene TinyNeRF or NeRF holding its weights: what the renderers
    take."""
    return scene_module(model, k)


def gather_scenes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (K_local, ...) tensor -> (K, ...) in global scene
    order, on every rank (x itself on one rank)."""
    if mesh.n_data == 1:
        return x
    g = gather(x.contiguous(), mesh, DATA_AXIS)
    return g.reshape(-1, *x.shape[1:])


def gather_state(model: nn.Module, optimizer: TrainOptimizer, mesh: Mesh):
    """(model, optimizer) of every rank's scenes, in global scene order, on
    every rank: the stacked parameters, Adam's moments and count, and the
    EMA gathered over the mesh's 'data' axis (the same objects on one
    rank). For the batched checkpoint."""
    if mesh.n_data == 1:
        return model, optimizer
    full = with_params(model, {n: gather_scenes(p.detach(), mesh)
                               for n, p in model.named_parameters()})
    opt = TrainOptimizer(full.parameters(), optimizer.lr, optimizer.decay_steps,
                         optimizer.decay_factor, optimizer.weight_decay, optimizer.lr_floor,
                         optimizer.ema_decay, batch_dims=1)
    for p, q in zip(model.parameters(), full.parameters()):
        st = optimizer.state.get(p)
        if st:
            opt.state[q] = {"step": st["step"].clone(),
                            "exp_avg": gather_scenes(st["exp_avg"], mesh),
                            "exp_avg_sq": gather_scenes(st["exp_avg_sq"], mesh)}
    if optimizer.ema is not None:
        opt.ema = [gather_scenes(e, mesh) for e in optimizer.ema]
    return full, opt
