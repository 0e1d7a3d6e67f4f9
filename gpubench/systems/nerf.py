"""The system under test for configurations of family "nerf": the port's
full NeRF (coarse and fine MLPs) through the entry points its trainer and
its renderers use.

train: training.make_train_block with the hierarchical loss and the fused
gradient (K4 the coarse pass, K4 or K6 the fine pass by the port's own
rule), Adam, one image a step; with several scenes in the mix,
multiscene.make_multiscene_train_block with the scene-axis gradient (one
launch a pass for every scene) and Adam over the stacked scenes. render:
render.make_hierarchical_image_renderer with use_fused (K3 both passes),
chunk by chunk.
"""

from __future__ import annotations

import torch

from gpubench.core import work
from gpubench.core.scenes import focal
from gpubench.reference import nerf as reference
from tinynerf_tpu_torch import multiscene, training
from tinynerf_tpu_torch import render as port_render
from tinynerf_tpu_torch.kernels import fused_nerf, fused_nerf_stream, fused_nerf_train
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, make_hierarchical_loss

KERNELS = {"train": ("K4", "K6"), "render": ("K3",)}


def model_cfg(cfg: dict) -> NeRFConfig:
    return NeRFConfig(num_freqs=cfg["num_freqs"], num_freqs_dir=cfg["num_freqs_dir"],
                      hidden=cfg["hidden"], depth=cfg["depth"], skip_at=cfg["skip_at"],
                      rgb_hidden=cfg["rgb_hidden"], use_viewdirs=True,
                      compute_dtype=getattr(torch, cfg["compute_dtype"]))


def build_model(cfg: dict, W: dict, device) -> NeRF:
    model = NeRF(model_cfg(cfg), device=device)
    model.load_state_dict({k: v.clone() for k, v in W.items()})
    return model


def settings(cfg: dict, traffic: dict) -> training.TrainSettings:
    return training.TrainSettings(n_rand=traffic["rays_per_scene"], n_samples=cfg["n_samples"],
                                  near=cfg["near"], far=cfg["far"], num_freqs=cfg["num_freqs"],
                                  lr=cfg["lr"], white_bkgd=cfg["white_bkgd"], ray_sampling="image")


class Train:
    def __init__(self, cfg: dict, traffic: dict, W: dict, data: dict, seed: int, device,
                 fault: str = ""):
        s = settings(cfg, traffic)
        ncfg = model_cfg(cfg)
        k, steps = traffic["scenes"], traffic["block_steps"]
        loss = make_hierarchical_loss(ncfg, n_fine=cfg["n_fine"])
        if k == 1:
            self.model = build_model(cfg, W, device)
            self.optimizer = training.settings_optimizer(self.model.parameters(), s)
            grad_fn = fused_nerf_train.make_fused_nerf_grad_fn(s, ncfg, n_fine=cfg["n_fine"])
            self.block = training.make_train_block(s, steps, loss=loss,
                                                   grad_fn=faulty_grad_fn(grad_fn, fault))
            self.data = [data[n][0] for n in ("rays_o", "rays_d", "pixels")]
        else:
            self.model, self.optimizer = multiscene.init_multiscene_state(
                seed, k, s, device=device,
                init_fn=lambda gen, dev: NeRF(ncfg, generator=gen, device=dev))
            self.model.load_state_dict({n: v.clone() for n, v in W.items()})
            grad_fn = fused_nerf_train.make_fused_nerf_grad_fn_scenes(s, ncfg,
                                                                     n_fine=cfg["n_fine"])
            self.block = multiscene.make_multiscene_train_block(
                s, steps, k, loss=loss, grad_fn=faulty_grad_fn(grad_fn, fault))
            self.data = [data[n] for n in ("rays_o", "rays_d", "pixels")]
        self.seed = seed

    def run(self, step0: int) -> dict:
        return self.block(self.model, self.optimizer, self.seed, step0, *self.data)

    @staticmethod
    def losses(metrics: dict) -> list:
        """[[coarse, fine] of each scene, per step] of a block's metrics."""
        both = torch.stack([metrics["loss_coarse"], metrics["loss"]], dim=-1)
        return both.reshape(both.shape[0], -1).tolist()

    @staticmethod
    def counters() -> dict:
        return {"K4": fused_nerf_train.fused_nerf_pass_grads,
                "K6": fused_nerf_stream.fused_nerf_pass_grads_streamed}


def faulty_grad_fn(grad_fn, fault: str):
    """The fused gradient, or with a planted fault for the harness's own
    tests: half of the batch left out (the mean over the rest), or every
    gradient doubled where it is written (a mean's divisor lost)."""
    if fault == "half_batch":
        def half(model, ro, rd, target, gens, noise_scale=1.0):
            h = ro.shape[-2] // 2
            return grad_fn(model, ro[..., :h, :].contiguous(), rd[..., :h, :].contiguous(),
                           target[..., :h, :].contiguous(), gens, noise_scale=noise_scale)
        return half
    if fault == "altered":
        def altered(model, *args, **kw):
            out = grad_fn(model, *args, **kw)
            for p in model.parameters():
                p.grad = p.grad * 2.0
            return out
        return altered
    return grad_fn


class Render:
    def __init__(self, cfg: dict, traffic: dict, W: dict, device):
        size = traffic["size"]
        self.model = build_model(cfg, W, device)
        self.fn = port_render.make_hierarchical_image_renderer(
            H=size, W=size, focal=focal(size), chunk=cfg["render_chunk"],
            n_coarse=cfg["n_samples"], n_fine=cfg["n_fine"], near=cfg["near"], far=cfg["far"],
            white_bkgd=cfg["white_bkgd"], nerf_cfg=model_cfg(cfg), use_fused=True)

    def view(self, pose: torch.Tensor) -> torch.Tensor:
        return self.fn(self.model, pose)

    @staticmethod
    def counters() -> dict:
        return {"K3": fused_nerf.fused_nerf_render_rays}


def expected_launches(cfg: dict, traffic: dict, kind: str, units: int) -> dict:
    """Launches of each kernel in `units` steps or views on the route the
    configuration names."""
    if kind == "train":
        return {"K4": units, "K6": units}
    chunks = work.ceil_div(traffic["size"] ** 2, cfg["render_chunk"])
    return {"K3": 2 * chunks * units}


def unit_work(cfg: dict, traffic: dict, kind: str) -> dict:
    """{"flops": FLOPs of one step or view, "kernels": {K: [(FLOPs, bytes) of
    each launch]}}."""
    shapes = reference.layer_shapes(cfg)
    h, sc, sf = cfg["hidden"], cfg["n_samples"], cfg["n_samples"] + cfg["n_fine"]
    if kind == "train":
        k, r = traffic["scenes"], traffic["rays_per_scene"]
        k4 = work.train_pass(shapes, h, r, sc, depths_in=False, sampling_out=True)
        k6 = work.train_pass(shapes, h, r, sf, depths_in=True, sampling_out=False)
        k4, k6 = (k * k4[0], k * k4[1]), (k * k6[0], k * k6[1])
        return {"flops": k4[0] + k6[0], "kernels": {"K4": [k4], "K6": [k6]}}
    r = traffic["size"] ** 2
    c = work.render_pass(shapes, r, sc, weights_out=True)
    f = work.render_pass(shapes, r, sf, weights_out=False)
    f = (f[0], f[1] + 4 * r * sf)
    return {"flops": c[0] + f[0], "kernels": {"K3": [c, f]}}
