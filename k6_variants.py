"""The bf16 tensor-core training walk of K6 and K4, the bf16 tensor-core
render kernel K3, and the TinyNeRF kernels K1 (render) and K2 (train) on
the tensor cores, built from altered copies of tinynerf_tpu_torch/csrc/,
on a CUDA card. A development tool: nothing of the package imports it.

Each variant is a copy of csrc/ with one or more texts replaced, built by
nvcc into build/k6_variants/<variant>/ (one nvcc each, all together), and
run in place of K6 on the flagship fine union (2048 rays x 192 samples,
block 64, hidden 256, bf16) and of K4 on the flagship coarse pass (2048
rays x 64 samples jittered in the kernel, weights and depths out, as
chip_smoke.py phase 21 times it), or (the render variants, built from
fused_nerf.cu) in place of K3 on the flagship fine pass (4096 rays x 192
given depths, bf16, as chip_smoke.py phase 15 times it), or (built from
fused_render.cu and fused_train.cu) in place of K1 on 8192 rays x 64
samples and of K2 on a 2048-ray step of 64 jittered samples, the
reference recipe's TinyNeRF 4 x 128 in bf16 (as chip_smoke.py phases 5
and 10 time them). Two kinds:

- ablations switch one part of the walk, or of K3, off. A part's share of
  a kernel's time is the full kernel's time less the variant's. Their
  gradients and renders are wrong; only their times are read. K3's parts:
  the tensor-core products (trunk and rgb_in), the sigma and rgb heads,
  the encoding, the composite; what they leave is the rest (points,
  direction encoding, barriers). K1's and K2's: their tensor-core
  products (K1 the trunk's forward; K2 all three: the forward and
  upstream tiles and the weight gradients).
- faults are the wrong gradients this walk's design could compute: a
  k-step of points dropped from the weight gradients, the bias row
  counted twice, an earlier launch's partial row added where the first
  chunk writes. Each is held against the plain version beside the sound
  kernel (K6 on the flagship union and on its first 257 rays, K4 on the
  2048 rays' grid depths; the same three in K2, on its 2048 rays' grid
  depths, since K2 sums its weight gradients with the same
  mma_weight_grad) with chip_smoke.py's bf16 gates: loss rel. <
  1e-3, per-leaf cosine > 0.98, and each trunk and rgb_in leaf's scale
  <g, ref> / <ref, ref> within MMA_SCALE of 1. A gate that passes a fault
  does not see it. The worst leaf's ||err|| / ||ref|| is printed beside
  them.

    python k6_variants.py          # from the root of the repo

Prints the card's name and power limit, one line per variant, then one
JSON object of the times and errors.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import MMA_SCALE, card_line, leaf_errors, mma_scale_error

WALK, MMA, MLP, RENDER = "nerf_train_walk.cuh", "mma_bf16.cuh", "nerf_mlp.cuh", "fused_nerf.cu"
TRAIN = "fused_train.cu"
# name -> [(file, text, replacement)]: each text must occur in the file;
# every occurrence is replaced (the one-round kernels' and the general
# kernels' copies of a product alike).
ABLATIONS = {
    "weight gradients": [(MMA, "  constexpr int MT = kGradMTiles;\n",
                          "  constexpr int MT = kGradMTiles;\n  if (true) return;\n")],
    "partial-row reads": [(MMA, "    if (!first) {", "    if (false) {")],
    "upstream products": [(MMA, "n_red, W, n_cols / 8", "0, W, n_cols / 8")],
    "forward products": [(MMA, "mma_rows<MT, NT>(acc, X + in_col, ld, m0, n_in, W",
                          "mma_rows<MT, NT>(acc, X + in_col, ld, m0, 0, W")],
    "workspace stores": [(MMA, "    if (store != nullptr)\n", "    if (false)\n")],
    "workspace reloads": [(WALK, "  const int n4 = n / 4;\n", "  const int n4 = n / 4;\n  return;\n")],
    "head gradients": [(WALK, "item < RH * 3 + 3 + H + 1; item += nt", "item < 0; item += nt")],
    "sigma head forward": [(MLP, "for (int k = j; k < n; k += 4)", "for (int k = j; k < 0; k += 4)")],
    "encoding": [(WALK, "      encode_bands<kTilePoints>(X, ld, H, pts, L, bf16);\n", "")],
    "per-ray gradients": [(WALK, "        segment_grads(b);\n", "")],
}
ABLATIONS["all three products"] = (ABLATIONS["weight gradients"] + ABLATIONS["upstream products"]
                                   + ABLATIONS["forward products"])
# K3's parts, each switched off in a copy of fused_nerf.cu's kMma kernel.
RENDER_ABLATIONS = {
    "products": [(MMA, "mma_rows<MT, NT>(acc, X + in_col, ld, m0, n_in, W",
                  "mma_rows<MT, NT>(acc, X + in_col, ld, m0, 0, W")],
    "sigma and rgb heads": [(MLP, "for (int k = j; k < n; k += 4)", "for (int k = j; k < 0; k += 4)"),
                            (RENDER, "for (int k = 0; k < a.rgb_hidden; ++k)",
                             "for (int k = 0; k < 0; ++k)")],
    "encoding": [(RENDER, "      encode_bands<kTilePoints>(X, ld, H, pts, a.num_freqs, bf16);\n", "")],
    "composite": [(RENDER, "for (int sl = 0; sl < SEG; ++sl) {", "for (int sl = 0; sl < 0; ++sl) {")],
}
# K1's trunk products (mma_dense_relu, as K3's); K2's three products: the
# forward and upstream warp tiles and the weight gradients.
TINY_RENDER_ABLATIONS = {"products": RENDER_ABLATIONS["products"]}
TINY_TRAIN_ABLATIONS = {
    "all three products": [(TRAIN, "m0, a.n, Bp, hidden / 8", "m0, 0, Bp, hidden / 8")]
    + ABLATIONS["weight gradients"]}
FAULTS = {
    "k-step of points dropped": [(MMA, "for (int ks = 0; ks < kMmaChunkPoints / 16; ++ks)",
                                  "for (int ks = 1; ks < kMmaChunkPoints / 16; ++ks)")],
    "bias row twice": [(MMA, "(m + 8 * h == in.n ? 1.f : 0.f)", "(m + 8 * h == in.n ? 2.f : 0.f)")],
    "stale partial row added": [(MMA, "    if (!first) {", "    if (true) {")],
}


def build_variant(name: str, source: str, edits: list, out_dir: Path) -> Path:
    """csrc/ with `edits` applied, csrc/<source>.cu compiled to
    out_dir/<slug>/lib.so."""
    from tinynerf_tpu_torch.kernels import _build

    d = out_dir / name.replace(" ", "_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d / "csrc")
    for fname, old, new in edits:
        path = d / "csrc" / fname
        text = path.read_text()
        if text.count(old) < 1:
            raise RuntimeError(f"variant {name!r}: {fname} does not hold {old!r}")
        path.write_text(text.replace(old, new))
    lib = d / "lib.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(d / "csrc" / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    return lib


def main() -> dict:
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.kernels import _build
    from tinynerf_tpu_torch.kernels import fused_nerf as fnr
    from tinynerf_tpu_torch.kernels import fused_nerf_train as fnt
    from tinynerf_tpu_torch.kernels import fused_render as fre
    from tinynerf_tpu_torch.kernels import fused_train as ftr
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
    )
    from tinynerf_tpu_torch.models.nerf import NeRF
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF

    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    # name -> (source, edits); each source's variants carry its prefix.
    prefix = {"fused_nerf_train": "", "fused_nerf": "K3 ", "fused_render": "K1 ",
              "fused_train": "K2 "}
    parts = {"fused_nerf_train": {**ABLATIONS, **FAULTS}, "fused_nerf": RENDER_ABLATIONS,
             "fused_render": TINY_RENDER_ABLATIONS, "fused_train": {**TINY_TRAIN_ABLATIONS, **FAULTS}}
    variants = {f"{prefix[src]}{n}": (src, e)
                for src, edits in parts.items() for n, e in {"full": [], **edits}.items()}
    out_dir = _build.BUILD_DIR.parent / "k6_variants"
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda kv: build_variant(kv[0], *kv[1], out_dir),
                                           variants.items())))

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    R, S = 2048, 192
    ro = (torch.randn(R, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 4.0])).to(dev)
    rd = torch.randn(R, 3, generator=g).to(dev)
    tgt = torch.rand(R, 3, generator=g).to(dev)
    z = torch.sort(torch.rand(R, S, generator=g) * 4.0 + 2.0, dim=1).values.to(dev)
    model = NeRF(Config(model="nerf", hidden=256, bf16=True).nerf_cfg(),
                 generator=torch.Generator().manual_seed(0), device=dev)

    seed = torch.tensor([3], dtype=torch.int32, device=dev)  # on the device, as the train step's
    # K3's flagship fine pass: 4096 rays (a render chunk) x 192 given depths.
    ro3 = (torch.randn(2 * R, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 4.0])).to(dev)
    rd3 = torch.randn(2 * R, 3, generator=g).to(dev)
    z3 = torch.sort(torch.rand(2 * R, S, generator=g) * 4.0 + 2.0, dim=1).values.to(dev)
    # K1 and K2 at the reference recipe (TinyNeRF 4 x 128, L=10, bf16).
    tiny = TinyNeRF(Config().model_cfg(), generator=torch.Generator().manual_seed(0), device=dev)
    ro1 = (torch.randn(4 * R, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 4.0])).to(dev)
    rd1 = torch.randn(4 * R, 3, generator=g).to(dev)
    timed = {
        "fused_render": {"K1": lambda: fre.fused_render_rays(tiny, ro1, rd1, n_samples=64)},
        "fused_train": {"K2": lambda: ftr.fused_loss_grads(tiny, ro, rd, tgt, seed, n_samples=64)},
        "fused_nerf_train": {
            "K6": lambda: fused_nerf_pass_grads_streamed(model.fine, ro, rd, tgt, z,
                                                         sample_block=64),
            "K4": lambda: fused_nerf_pass_grads(model.coarse, ro, rd, tgt, seed, n_samples=64,
                                                emit_sampling=True)},
        "fused_nerf": {
            "K3": lambda: fnr.fused_nerf_render_rays(model.fine, ro3, rd3, z3)},
    }

    def ms(fn, iters=3):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    names = [n for n, _ in model.fine.named_parameters()]
    tiny_names = [n for n, _ in tiny.named_parameters()]
    # source -> case -> (kernel, its plain version, the leaves' names) on
    # each case's inputs
    grid = dict(n_samples=64, randomized=False)
    cases = {
        "fused_nerf_train": {
            **{f"K6, {n} rays": (
                lambda n=n: fused_nerf_pass_grads_streamed(model.fine, ro[:n], rd[:n], tgt[:n],
                                                           z[:n], sample_block=64),
                lambda n=n: fused_nerf_pass_grads_streamed_plain(model.fine, ro[:n], rd[:n],
                                                                 tgt[:n], z[:n], sample_block=64),
                names)
               for n in (R, 257)},
            f"K4, {R} rays": (
                lambda: fused_nerf_pass_grads(model.coarse, ro, rd, tgt, 0, **grid),
                lambda: fused_nerf_pass_grads_plain(model.coarse, ro, rd, tgt, 0, **grid), names)},
        "fused_train": {
            f"K2, {R} rays": (
                lambda: ftr.fused_loss_grads(tiny, ro, rd, tgt, 0, **grid),
                lambda: ftr.fused_loss_grads_plain(tiny, ro, rd, tgt, 0, **grid), tiny_names)},
    }
    refs = {case: plain() for by_case in cases.values() for case, (_, plain, _) in by_case.items()}

    def errors(source, case):
        kernel, _, names = cases[source][case]
        kernel()  # an earlier launch
        loss, grads = kernel()
        want_loss, want = refs[case]
        err = {"loss_rel": abs(float(loss) - float(want_loss)) / float(want_loss),
               **leaf_errors(grads, want), "mma_scale_err": mma_scale_error(names, grads, want)}
        rel_norm = [float((g - w).norm() / w.norm()) for g, w in zip(grads, want)]
        err["worst_rel_norm_leaf"] = names[max(range(len(names)), key=rel_norm.__getitem__)]
        err["gates"] = {"loss": err["loss_rel"] < 1e-3, "cosine": err["min_cosine"] > 0.98,
                        "scale": err["mma_scale_err"] < MMA_SCALE}
        return err

    def clear():
        _build.load.cache_clear()
        for mod in (fnr, fnt, fre, ftr):
            mod._lib.cache_clear()

    times, errs = {}, {}
    build = _build.build
    try:
        for rnd in range(2):  # two rounds over every variant; the minimum time is kept
            for name, (source, _) in variants.items():
                clear()
                _build.build = lambda n, s=source, lib=libs[name]: lib if n == s else build(n)
                part = name[len(prefix[source]):]
                if part not in FAULTS:
                    for kernel, f in timed[source].items():
                        times.setdefault((kernel, name), []).append(ms(f))
                if rnd == 0 and (part == "full" or part in FAULTS):
                    for case in cases.get(source, {}):
                        errs[f"{name}, {case}"] = errors(source, case)
    finally:
        _build.build = build
        clear()
    best = {k: min(v) for k, v in times.items()}
    for kernel, shape, prefix, parts in (("K6", "2048 x 192", "", ABLATIONS),
                                         ("K4", "2048 x 64", "", ABLATIONS),
                                         ("K3", "4096 x 192", "K3 ", RENDER_ABLATIONS),
                                         ("K1", "8192 x 64", "K1 ", TINY_RENDER_ABLATIONS),
                                         ("K2", "2048 x 64", "K2 ", TINY_TRAIN_ABLATIONS)):
        full = best[kernel, f"{prefix}full"]
        print(f"[k6_variants] {card}: {kernel} bf16 {shape}: {full:.4f} ms "
              f"(runs {times[kernel, f'{prefix}full']})")
        for part in parts:
            t = best[kernel, prefix + part]
            print(f"[k6_variants] {card}: {kernel} without {part}: {t:.4f} ms, its share "
                  f"{full - t:.4f} ms (runs {times[kernel, prefix + part]})")
    for name, err in errs.items():
        print(f"[k6_variants] {name.replace('full', 'sound kernel')} against the plain version: "
              f"{json.dumps(err)}")
    result = {"ms": {f"{k} {name}": t for (k, name), t in best.items()}, "errors": errs}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
