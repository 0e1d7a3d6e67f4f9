"""The loop of a rendering mix (kind "render"): views one at a time in a
closed loop, each finished on the host, cycling over a spiral of poses;
the check renders a sample of the window's views, drawn from the seed,
again with the reference.

The mix's sizes: size (pixels a side), hemisphere_poses (the pose the
spiral circles is one of them, by the seed), spiral_frames, spiral_radius.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.core import cell as C
from gpubench.core import check, scenes
from gpubench.loops.train import centre_rays

FAULTS = ("half_batch", "altered")


def spiral(traffic: dict, seed: int, dev) -> torch.Tensor:
    hemi = scenes.hemisphere_poses(traffic["hemisphere_poses"])
    c2w = hemi[np.random.RandomState(C.sub_seed(seed, 3)).randint(len(hemi))]
    return torch.from_numpy(scenes.spiral_poses(c2w, traffic["spiral_frames"],
                                                traffic["spiral_radius"])).to(dev)


def inputs(ref, cfg: dict, traffic: dict, seed: int, dev) -> tuple:
    """(poses, weights): the spiral, the weights with their density
    centred on the first view's rays."""
    poses = spiral(traffic, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(C.sub_seed(seed, 1))
    W = ref.init_weights(cfg, gen, dev)
    size = traffic["size"]
    ref.centre_density(W, *centre_rays(*scenes.pinhole_rays(size, scenes.focal(size), poses[0])),
                       cfg)
    return poses, W


@torch.no_grad()
def reference_image(ref, W, pose, cfg, size, prec=None, chunk=8192):
    """The reference's view (size, size, 3), in the configuration's
    precision unless `prec` names another."""
    prec = prec or cfg["compute_dtype"]
    ro, rd = scenes.pinhole_rays(size, scenes.focal(size), pose)
    img = torch.cat([ref.render_rays(W, ro[c:c + chunk], rd[c:c + chunk], cfg, prec)
                     for c in range(0, ro.shape[0], chunk)])
    return img.clamp(0.0, 1.0).reshape(size, size, 3)


def faulty_view(img: torch.Tensor, fault: str) -> torch.Tensor:
    """The harness's own tests: half of a view's rays left out (the
    background in their place), or a band of a view altered."""
    if fault == "half_batch":
        img = img.clone()
        img[img.shape[0] // 2:] = 1.0
    elif fault == "altered":
        img = img.clone()
        band = max(1, img.shape[1] // 8)
        img[:, :band] = (img[:, :band] + 0.25).clamp(0, 1)
    return img


def run(opts, cfg, traffic, system, dev, clock) -> dict:
    ref = system.reference
    size = traffic["size"]
    kernels = system.KERNELS["render"]
    builder = C.prebuild(kernels, dev)
    poses, W = inputs(ref, cfg, traffic, opts.seed, dev)
    C.sync(dev)
    clock.mark("inputs")
    if builder is not None:
        builder.join()
    clock.mark("build")
    prog = system.Render(cfg, traffic, W, dev)
    C.sync(dev)
    clock.mark("program")
    prog.view(poses[0]).cpu()
    t_unit = time.perf_counter()
    prog.view(poses[1]).cpu()
    t_unit = time.perf_counter() - t_unit
    counters = prog.counters()
    clock.mark("first_views")
    setup_s = clock.total()

    C.reset_counters(counters)
    rng = np.random.RandomState(C.sub_seed(opts.seed, 4))
    keep, latency, bad = [], [], [0]
    n_keep = cfg["check_views"]
    main = [True]

    def unit(i):
        t = time.perf_counter()
        img = faulty_view(prog.view(poses[i % len(poses)]), opts.fault).cpu()
        if main[0]:
            latency.append(time.perf_counter() - t)
            bad[0] += int(not np.isfinite(img.numpy()).all())
            if len(keep) < n_keep:
                keep.append((i, img))
            else:
                j = rng.randint(0, i + 1)
                if j < n_keep:
                    keep[j] = (i, img)

    seconds, views = C.window(opts.seconds, unit)
    main[0] = False
    peak, readings = C.finish(dev, counters,
                              system.expected_launches(cfg, traffic, "render", views),
                              C.route_of(cfg, traffic))
    summary = C.traced(dev, kernels, t_unit, unit, views) if opts.trace else None
    del prog, counters, unit
    C.free(dev)
    pairs = [(img.to(dev), reference_image(ref, W, poses[i % len(poses)], cfg, size))
             for i, img in keep]
    readings.update(check.image_readings(pairs))
    lat = np.array(latency) * 1e3
    return {"kind": "render", "attempted": views, "failed": bad[0], "readings": readings,
            "peak": peak, "trace": summary, "work": system.unit_work(cfg, traffic, "render"),
            "steps_per_unit": 1,
            "window": {"seconds": seconds, "units": views,
                       "latency_ms": [float(np.min(lat)), float(np.median(lat)),
                                      float(np.max(lat)), float(np.sum(lat))]},
            "measured": {"setup_s": setup_s, "image_ms": seconds / views * 1e3,
                         "image_ms_p90": float(np.percentile(lat, 90))}}


def control(ref, cfg, traffic, seed, dev) -> dict:
    """The check's numbers of the control (the reference in float8) and of
    each planted fault, against the reference, on this seed's views."""
    poses, W = inputs(ref, cfg, traffic, seed, dev)
    views = np.random.RandomState(C.sub_seed(seed, 4)).choice(len(poses), cfg["check_views"],
                                                              replace=False)
    base = [reference_image(ref, W, poses[i], cfg, traffic["size"]) for i in views]
    low = [reference_image(ref, W, poses[i], cfg, traffic["size"], prec="fp8") for i in views]
    res = {"fp8": check.image_readings(list(zip(low, base)))}
    for fault in FAULTS:
        res[fault] = check.image_readings([(faulty_view(b, fault), b) for b in base])
    return res
