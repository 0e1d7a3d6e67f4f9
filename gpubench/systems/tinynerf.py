"""The system under test for configurations of family "tinynerf": the
port's TinyNeRF through the entry points its trainers and renderer use.

train: multiscene.make_multiscene_train_block with the fused scene-axis
gradient (one K2 launch a step for every scene), Adam over the stacked
scenes, one image a scene a step. render: render.make_image_renderer with
use_fused (K1), chunk by chunk.
"""

from __future__ import annotations

import torch

from gpubench.core import work
from gpubench.core.scenes import focal
from gpubench.reference import tinynerf as reference
from gpubench.systems.nerf import faulty_grad_fn
from tinynerf_tpu_torch import multiscene, training
from tinynerf_tpu_torch import render as port_render
from tinynerf_tpu_torch.kernels import fused_render, fused_train
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig

KERNELS = {"train": ("K2",), "render": ("K1",)}


def model_cfg(cfg: dict) -> TinyNeRFConfig:
    return TinyNeRFConfig(in_dim=3 + 6 * cfg["num_freqs"], hidden=cfg["hidden"],
                          depth=cfg["depth"], skip_at=cfg["skip_at"],
                          compute_dtype=getattr(torch, cfg["compute_dtype"]))


def settings(cfg: dict, traffic: dict) -> training.TrainSettings:
    return training.TrainSettings(n_rand=traffic["rays_per_scene"], n_samples=cfg["n_samples"],
                                  near=cfg["near"], far=cfg["far"], num_freqs=cfg["num_freqs"],
                                  lr=cfg["lr"], white_bkgd=cfg["white_bkgd"], ray_sampling="image",
                                  model_cfg=model_cfg(cfg))


class Train:
    def __init__(self, cfg: dict, traffic: dict, W: dict, data: dict, seed: int, device,
                 fault: str = ""):
        s = settings(cfg, traffic)
        k = traffic["scenes"]
        self.model, self.optimizer = multiscene.init_multiscene_state(seed, k, s, device=device)
        self.model.load_state_dict({n: (v if k > 1 else v[None]).clone() for n, v in W.items()})
        grad_fn = fused_train.make_fused_grad_fn_scenes(s)
        self.block = multiscene.make_multiscene_train_block(
            s, traffic["block_steps"], k, grad_fn=faulty_grad_fn(grad_fn, fault))
        self.data = [data[n] for n in ("rays_o", "rays_d", "pixels")]
        self.seed = seed

    def run(self, step0: int) -> dict:
        return self.block(self.model, self.optimizer, self.seed, step0, *self.data)

    @staticmethod
    def losses(metrics: dict) -> list:
        """[[loss of each scene] per step]."""
        return metrics["loss"].tolist()

    @staticmethod
    def counters() -> dict:
        return {"K2": fused_train.fused_loss_grads}


class Render:
    def __init__(self, cfg: dict, traffic: dict, W: dict, device):
        size = traffic["size"]
        tcfg = model_cfg(cfg)
        self.model = TinyNeRF(tcfg, device=device)
        self.model.load_state_dict({k: v.clone() for k, v in W.items()})
        self.fn = port_render.make_image_renderer(
            H=size, W=size, focal=focal(size), chunk=cfg["render_chunk"],
            n_samples=cfg["n_samples"], near=cfg["near"], far=cfg["far"],
            num_freqs=cfg["num_freqs"], white_bkgd=cfg["white_bkgd"], model_cfg=tcfg,
            use_fused=True)

    def view(self, pose: torch.Tensor) -> torch.Tensor:
        return self.fn(self.model, pose)

    @staticmethod
    def counters() -> dict:
        return {"K1": fused_render.fused_render_rays}


def expected_launches(cfg: dict, traffic: dict, kind: str, units: int) -> dict:
    if kind == "train":
        return {"K2": units}
    return {"K1": work.ceil_div(traffic["size"] ** 2, cfg["render_chunk"]) * units}


def unit_work(cfg: dict, traffic: dict, kind: str) -> dict:
    shapes = reference.layer_shapes(cfg)
    s = cfg["n_samples"]
    if kind == "train":
        k, r = traffic["scenes"], traffic["rays_per_scene"]
        one = work.train_pass(shapes, cfg["hidden"], r, s, depths_in=False, sampling_out=False)
        return {"flops": k * one[0], "kernels": {"K2": [(k * one[0], k * one[1])]}}
    k1 = work.render_pass(shapes, traffic["size"] ** 2, s, weights_out=False)
    return {"flops": k1[0], "kernels": {"K1": [k1]}}
