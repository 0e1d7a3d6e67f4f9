"""The system under test for configurations of family "grid": the port's
multiresolution hash-grid NeRF (models/grid_nerf.py) in its Instant-NGP
form, through the entry points `train --model grid` uses.

train: training.init_train_state with the grid model and the settings'
optimizer (MaskedAdam: the tables' zero-gradient entries skipped, L2 on
the MLP matrices), models/grid_nerf.make_grid_loss over the box of every
training ray's [near, far] segment (ops/occupancy.aabb_from_rays), and
training.make_train_block with autograd of the loss, one image a step.
The family has no K1-K7 launch. The encoding's two entry points,
grid_nerf.encode_levels (the gather and blend) and encode_levels_bwd (the
scatter-add into the tables), run inside spans `gpubench.grid_encode`
and `gpubench.grid_encode_bwd` while a profiler records, so
core/trace.py files their device time under those names.

The work a step: the two MLPs' products (forward, the weight gradients
and the input gradients down to the tables) and the encoding's two
passes, each bound by its bytes: the points, the tables and the features
in float32, each read or written once.
"""

from __future__ import annotations

import torch

from gpubench.reference import grid as reference
from gpubench.systems.nerf import faulty_grad_fn
from tinynerf_tpu_torch import training
from tinynerf_tpu_torch.models import grid_nerf
from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, GridNeRFConfig, make_grid_loss
from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays

KERNELS = {"train": (), "render": ()}
ENCODE_SPANS = {"encode_levels": "gpubench.grid_encode",
                "encode_levels_bwd": "gpubench.grid_encode_bwd"}


def model_cfg(cfg: dict, box=None) -> GridNeRFConfig:
    kw = {} if box is None else {"aabb": tuple(float(v) for v in box.reshape(6).tolist())}
    return GridNeRFConfig(
        n_levels=cfg["n_levels"], features=cfg["features"], base_res=cfg["base_res"],
        max_res=cfg["max_res"], table_size=cfg["table_size"], hidden=cfg["hidden"],
        geo_features=cfg["density_outputs"] - 1, dir_encoding=cfg["dir_encoding"],
        density_activation=cfg["density_activation"],
        rgb_reads_density=cfg["rgb_reads_density"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]), **kw)


def settings(cfg: dict, traffic: dict) -> training.TrainSettings:
    return training.TrainSettings(
        n_rand=traffic["rays_per_scene"], n_samples=cfg["n_samples"], near=cfg["near"],
        far=cfg["far"], lr=cfg["lr"], white_bkgd=cfg["white_bkgd"], ray_sampling="image",
        adam_b2=cfg["adam_b2"], adam_eps=cfg["adam_eps"], l2_reg=cfg["l2_reg"],
        sparse_adam=cfg["sparse_adam"])


def wrap_encode() -> None:
    """Put each encode entry point of the port in its `gpubench.` span
    while a profiler records (once a process)."""
    for name, span in ENCODE_SPANS.items():
        fn = getattr(grid_nerf, name)
        if getattr(fn, "_gpubench_span", None):
            continue

        def wrapped(*args, _fn=fn, _span=span):
            if not torch._C._autograd._profiler_enabled():
                return _fn(*args)
            with torch.profiler.record_function(_span):
                return _fn(*args)

        wrapped._gpubench_span = span
        setattr(grid_nerf, name, wrapped)


def loss_grad_fn(loss, s):
    """Autograd of the loss as a grad_fn, for the planted faults only (the
    timed path takes the loss itself)."""
    def grad_fn(model, ro, rd, target, gen, noise_scale=1.0):
        with torch.enable_grad():
            value, metrics = loss(model, ro, rd, target, gen, s, noise_scale=noise_scale)
            value.backward()
        return value, metrics

    return grad_fn


class Train:
    def __init__(self, cfg: dict, traffic: dict, W: dict, data: dict, seed: int, device,
                 fault: str = ""):
        if traffic["scenes"] != 1:
            raise ValueError("the grid family trains one scene")
        s = settings(cfg, traffic)
        ro, rd, px = (data[n][0] for n in ("rays_o", "rays_d", "pixels"))
        box = aabb_from_rays(ro, rd, cfg["near"], cfg["far"], margin=cfg["aabb_margin"])
        gcfg = model_cfg(cfg, box)
        self.model, self.optimizer = training.init_train_state(
            torch.Generator().manual_seed(seed), s, device=device,
            init_fn=lambda gen, dev: GridNeRF(gcfg, generator=gen, device=dev))
        self.model.load_state_dict({k: v.clone() for k, v in W.items()})
        loss = make_grid_loss(gcfg)
        grad_fn = faulty_grad_fn(loss_grad_fn(loss, s), fault) if fault else None
        self.block = training.make_train_block(s, traffic["block_steps"], loss=loss,
                                               grad_fn=grad_fn)
        self.data = [ro, rd, px]
        self.seed = seed
        wrap_encode()

    def run(self, step0: int) -> dict:
        return self.block(self.model, self.optimizer, self.seed, step0, *self.data)

    @staticmethod
    def losses(metrics: dict) -> list:
        """[[loss] per step]."""
        return metrics["loss"].reshape(-1, 1).tolist()

    @staticmethod
    def counters() -> dict:
        return {}


def expected_launches(cfg: dict, traffic: dict, kind: str, units: int) -> dict:
    return {}


def points(cfg: dict, traffic: dict) -> int:
    """Sample points a step."""
    return traffic["scenes"] * traffic["rays_per_scene"] * cfg["n_samples"]


def encode_pass(cfg: dict, n_points: int) -> tuple:
    """(FLOPs, bytes) of one pass of the encoding, forward or backward:
    the blend's multiply-adds (8 corners x features x levels a point), and
    the points (3 floats), every table entry and the features (levels x
    features floats a point) in float32, each read or written once."""
    width = cfg["n_levels"] * cfg["features"]
    flops = 2 * 8 * width * n_points
    nbytes = 4 * (3 * n_points + sum(reference.table_sizes(cfg)) * cfg["features"]
                  + width * n_points)
    return flops, nbytes


def unit_work(cfg: dict, traffic: dict, kind: str) -> dict:
    """{"flops": the MLPs' FLOPs of one step (forward, weight gradients
    and input gradients down to the tables: 3 x the forward's MACs x 2 a
    point), "kernels": the encoding's two passes}."""
    n = points(cfg, traffic)
    enc = encode_pass(cfg, n)
    return {"flops": 2 * 3 * reference.macs_per_point(cfg) * n,
            "kernels": {"grid_encode": [enc], "grid_encode_bwd": [enc]}}
