"""The loop of a training mix (kind "train"): one training object built
at set-up, driven through its first block from the seed, then blocks of
steps for the window, a sync after each; the check follows the first
three steps with the reference.

The mix's sizes: scenes, views_per_scene, size (pixels a side),
rays_per_scene (a step), block_steps.
"""

from __future__ import annotations

import time

import torch

from gpubench.core import cell as C
from gpubench.core import check, scenes

B1 = 0.9  # Adam's first-moment decay: the first gradient is exp_avg / (1 - B1)
FAULTS = ("half_batch", "altered")


def centre_rays(ro: torch.Tensor, rd: torch.Tensor, n: int = 4096):
    """About n of the rays (..., R, 3), evenly spaced: where the density is
    centred."""
    step = max(1, ro.shape[-2] // n)
    return ro[..., ::step, :], rd[..., ::step, :]


def inputs(ref, cfg: dict, traffic: dict, seed: int, dev) -> tuple:
    """(data, weights, the training seed): the scenes, the weights with
    their density centred on each scene's first view's rays."""
    k = traffic["scenes"]
    data = scenes.training_scenes([C.sub_seed(seed, 100 + i) for i in range(k)],
                                  traffic["views_per_scene"], traffic["size"], dev)
    gen = torch.Generator(device=dev).manual_seed(C.sub_seed(seed, 1))
    W0 = ref.init_weights(cfg, gen, dev, n_scenes=k)
    ro, rd = centre_rays(data["rays_o"][:, 0], data["rays_d"][:, 0])
    ref.centre_density(W0, ro if k > 1 else ro[0], rd if k > 1 else rd[0], cfg)
    return data, W0, C.sub_seed(seed, 2)


def run(opts, cfg, traffic, system, dev, clock) -> dict:
    ref = system.reference
    k = traffic["scenes"]
    steps = traffic["block_steps"]
    kernels = system.KERNELS["train"]
    builder = C.prebuild(kernels, dev)
    data, W0, train_seed = inputs(ref, cfg, traffic, opts.seed, dev)
    C.sync(dev)
    clock.mark("inputs")
    if builder is not None:
        builder.join()
    clock.mark("build")
    prog = system.Train(cfg, traffic, W0, data, train_seed, dev, fault=opts.fault)
    params = dict(prog.model.named_parameters())
    base = prog.optimizer.base
    if opts.fault == "frozen":
        base.step = lambda *a, **kw: None
    seen = {"n": 0}

    def capture(optimizer, args, kwargs):
        seen["n"] += 1
        if seen["n"] == 1:
            seen["grad1"] = {n: optimizer.state[p]["exp_avg"] / (1 - B1) for n, p in params.items()}
        if seen["n"] == 3:
            seen["after3"] = {n: p.detach().clone() for n, p in params.items()}

    hook = base.register_step_post_hook(capture)
    C.sync(dev)
    clock.mark("program")
    t_unit = time.perf_counter()
    first = prog.run(0)
    C.sync(dev)
    t_unit = time.perf_counter() - t_unit
    hook.remove()
    grad1 = seen.get("grad1") or {n: torch.zeros_like(p) for n, p in params.items()}
    after3 = seen.get("after3") or {n: p.detach().clone() for n, p in params.items()}
    prog_result = {"losses": prog.losses(first)[:3], "grad1": grad1,
                   "change": {n: after3[n] - W0[n].reshape(after3[n].shape) for n in params}}
    counters = prog.counters()
    clock.mark("first_block")
    setup_s = clock.total()

    C.reset_counters(counters)
    losses = []
    n_main = [1 << 30]

    def unit(i):
        m = prog.run(steps * (i + 1))
        C.sync(dev)
        if len(losses) < n_main[0]:
            losses.append(m["loss"])

    seconds, units = C.window(opts.seconds, unit)
    n_main[0] = units
    n_steps = units * steps
    peak, readings = C.finish(dev, counters,
                              system.expected_launches(cfg, traffic, "train", n_steps),
                              C.route_of(cfg, traffic))
    summary = C.traced(dev, kernels, t_unit, unit, units) if opts.trace else None
    lost = torch.stack(losses).reshape(n_steps, -1)
    failed = int((~torch.isfinite(lost)).any(dim=1).sum())
    del prog, params, base, first, losses, lost, counters, unit
    C.free(dev)

    ref_result = ref.train_steps(W0, data, cfg, train_seed, 3, traffic["rays_per_scene"],
                                 prec=cfg["compute_dtype"])
    numbers, worst = check.train_readings(prog_result, ref_result, k)
    readings.update(numbers)
    return {"kind": "train", "attempted": n_steps, "failed": failed, "readings": readings,
            "peak": peak, "trace": summary, "work": system.unit_work(cfg, traffic, "train"),
            "steps_per_unit": steps,
            "window": {"seconds": seconds, "units": units, "worst_leaf": worst},
            "measured": {"setup_s": setup_s,
                         "train_rays_per_s": n_steps * k * traffic["rays_per_scene"] / seconds}}


def control(ref, cfg, traffic, seed, dev) -> dict:
    """The check's numbers of the control (the reference in float8) and of
    each planted fault, against the reference, on this seed's inputs."""
    k = traffic["scenes"]
    data, W0, train_seed = inputs(ref, cfg, traffic, seed, dev)
    args = (W0, data, cfg, train_seed, 3, traffic["rays_per_scene"])
    prec = cfg["compute_dtype"]
    base = ref.train_steps(*args, prec=prec)
    res = {"fp8": check.train_readings(ref.train_steps(*args, prec="fp8"), base, k)[0]}
    for fault in FAULTS:
        res[fault] = check.train_readings(ref.train_steps(*args, prec=prec, fault=fault),
                                          base, k)[0]
    return res
