"""Instant-NGP's published form of the grid family, on the CPU at a small
size (L = 4, T = 2^10, N_max 64), against the benchmark's plain reference
(gpubench/reference/grid.py), no JAX:

- the spherical-harmonics basis against its closed form;
- the field (hash encoding, SH, exp density, the colour MLP on all 16
  density outputs) in float32 and bfloat16, and a rendered chunk;
- the encode Function's tables' gradients bit-identical to autograd's of
  the gather on the default configuration;
- MaskedAdam: zero-gradient table entries keep value and moments, the
  rest and the MLP as the reference's Adam, L2 on the matrices only;
- three steps of training.make_train_block against train_steps;
- the spans grid.encode, grid.encode.bwd and the counter grid_points;
- the defaults: the grid family's configuration and the optimizer that
  make_optimizer builds are what they were.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from gpubench.reference import grid as ref
from tinynerf_tpu_torch import training
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models import grid_nerf
from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, GridNeRFConfig, render_rays_grid
from tinynerf_tpu_torch.ops.encoding import sh_encoding
from tinynerf_tpu_torch.utils import profiling

CFG = {"n_levels": 4, "features": 2, "table_size": 1 << 10, "base_res": 16, "max_res": 64,
       "hidden": 64, "density_outputs": 16, "n_samples": 16, "near": 2.0, "far": 6.0,
       "white_bkgd": True, "lr": 0.01, "adam_b1": 0.9, "adam_b2": 0.99, "adam_eps": 1e-15,
       "l2_reg": 1e-6, "aabb_margin": 0.05}
N_RAYS = 256


@pytest.fixture(autouse=True)
def _grad_on():
    """Autograd on (tests/test_torch_parity.py turns it off for its
    worker), empty span totals."""
    profiling.reset_spans()
    with torch.enable_grad():
        yield
    profiling.reset_spans()


def model_cfg(box=None, dtype=torch.float32) -> GridNeRFConfig:
    kw = {} if box is None else {"aabb": tuple(box.reshape(6).tolist())}
    return GridNeRFConfig(n_levels=CFG["n_levels"], features=CFG["features"],
                          base_res=CFG["base_res"], max_res=CFG["max_res"],
                          table_size=CFG["table_size"], hidden=CFG["hidden"], geo_features=15,
                          dir_encoding="sh", density_activation="exp", rgb_reads_density=True,
                          compute_dtype=dtype, **kw)


def rays(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ro = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1) * 4.0
    target = torch.randn(n, 3, generator=g) * 0.3
    rd = torch.nn.functional.normalize(target - ro, dim=-1)
    return ro, rd


def weights(seed: int = 0) -> dict:
    """The reference's weights with the tables drawn wide (+-0.5), so that
    the features matter."""
    W = ref.init_weights(CFG, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k in W:
        if k.startswith("tables."):
            W[k] = torch.rand(W[k].shape, generator=g) - 0.5
    return W


def model(W: dict, box, dtype=torch.float32) -> GridNeRF:
    m = GridNeRF(model_cfg(box, dtype))
    m.load_state_dict({k: v.clone() for k, v in W.items()})
    return m


def test_sh_basis_is_the_closed_form():
    """Orthonormal over the sphere (a 200 x 400 midpoint quadrature), the
    first two bands as their textbook closed form, and the reference's."""
    th = (torch.arange(200, dtype=torch.float64) + 0.5) * math.pi / 200
    ph = torch.arange(400, dtype=torch.float64) * 2 * math.pi / 400
    t, p = torch.meshgrid(th, ph, indexing="ij")
    d = torch.stack([t.sin() * p.cos(), t.sin() * p.sin(), t.cos()], dim=-1).reshape(-1, 3)
    Y = sh_encoding(d).double()
    w = (t.sin() * (math.pi / 200) * (2 * math.pi / 400)).reshape(-1, 1)
    assert ((Y * w).T @ Y - torch.eye(16, dtype=torch.float64)).abs().max() < 1e-4
    x, y, z = d.float().unbind(-1)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    closed = torch.stack([torch.full_like(x, 0.5 / math.sqrt(math.pi)), -c1 * y, c1 * z, -c1 * x,
                          0.5 * math.sqrt(5.0 / math.pi) * (1.5 * z * z - 0.5)], dim=-1)
    torch.testing.assert_close(sh_encoding(d)[:, [0, 1, 2, 3, 6]], closed, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sh_encoding(d.float()), ref.sh(d.float()), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype, prec, tol", [(torch.float32, "float32", 2e-5),
                                              (torch.bfloat16, "bfloat16", 3e-2)])
def test_field_matches_the_reference(dtype, prec, tol):
    """float32 tightly; bfloat16 within 3e-2 of the reference's bf16
    operands with float32 sums (the port rounds each product and bias sum
    to bf16 as well)."""
    ro, rd = rays(N_RAYS, 1)
    box = ref.box_of(ro, rd, CFG)
    W = weights()
    pts = ro + rd * (2.0 + 4.0 * torch.rand(N_RAYS, 1, generator=torch.Generator().manual_seed(2)))
    with torch.no_grad():
        rgb, sigma = model(W, box, dtype)(pts, rd)
        rgb_r, sigma_r = ref.field(W, pts, rd, CFG, box, prec)
    torch.testing.assert_close(rgb, rgb_r, rtol=tol, atol=tol)
    torch.testing.assert_close(torch.log(sigma), torch.log(sigma_r), rtol=tol, atol=tol)


def test_a_rendered_chunk_matches_the_reference():
    ro, rd = rays(N_RAYS, 3)
    box = ref.box_of(ro, rd, CFG)
    W = weights(5)
    cfg = model_cfg(box)
    with torch.no_grad():
        comp = render_rays_grid(model(W, box), ro, rd, None, cfg=cfg, n_samples=CFG["n_samples"],
                                near=2.0, far=6.0)[0]
        want = ref.render_rays(W, ro, rd, CFG, "float32", box=box)
    torch.testing.assert_close(comp, want, rtol=1e-5, atol=1e-5)


def autograd_encode(tables, pts, cfg):
    """The encoding as autograd sees it without the Function: the gather
    table[ids] and the blend (the grid family before the Function)."""
    lo, hi = grid_nerf._box(tuple(float(v) for v in cfg.aabb), pts.device)
    u = torch.clamp((pts.float() - lo) / (hi - lo), 0.0, 1.0)
    outs = []
    for l, (res, dense) in enumerate(zip(cfg.level_resolutions(), cfg.level_is_dense())):
        lin, w = grid_nerf.level_ids(u, res, dense, cfg.table_size)
        outs.append(torch.sum(w[..., None] * tables[f"l{l}"][lin], dim=1))
    return torch.cat(outs, dim=-1)


@pytest.mark.parametrize("cfg", [GridNeRFConfig(), model_cfg()], ids=["default", "published"])
def test_encode_function_gradients_are_autograds_bit_for_bit(cfg):
    """On one CPU thread: several threads' index_put_(accumulate=True) add
    in the order the threads reach an entry, autograd's own as well."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        check_encode_function(cfg, torch.device("cpu"), 4096)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's sorted index_put_ is checked there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [GridNeRFConfig(), model_cfg()], ids=["default", "published"])
def test_encode_function_gradients_are_autograds_bit_for_bit_on_card(cuda_device, cfg):
    """The card sorts the ids and sums each entry's run of duplicates in
    the stable sort's order: one index_put_ over the tables laid end to
    end gives every entry the sum a level's own gives."""
    check_encode_function(cfg, cuda_device, 1 << 18)


def check_encode_function(cfg, device, n):
    m = GridNeRF(cfg, generator=torch.Generator().manual_seed(4), device=device)
    with torch.no_grad():
        for t in m.tables.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(6)) * 2 - 1)
    g = torch.Generator().manual_seed(7)
    pts = (torch.rand(n, 3, generator=g) * 9.0 - 4.5).to(device)  # some outside the box
    up = torch.randn(n, cfg.n_levels * cfg.features, generator=g).to(device)
    got = []
    for fn in (autograd_encode, grid_nerf.grid_encode):
        m.zero_grad(set_to_none=True)
        feats = fn(m.tables, pts, cfg)
        feats.backward(up)
        got.append((feats.detach(), [t.grad for t in m.tables.values()]))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


def test_masked_adam_skips_zero_gradient_entries_and_decays_matrices_only():
    g = torch.Generator().manual_seed(8)
    W = {"tables.l0": torch.randn(64, 2, generator=g),
         "mlp.geo0.weight": torch.randn(8, 4, generator=g),
         "mlp.geo0.bias": torch.randn(8, generator=g)}
    params = {k: torch.nn.Parameter(v.clone()) for k, v in W.items()}
    s = training.TrainSettings(lr=CFG["lr"], adam_b2=0.99, adam_eps=1e-15, l2_reg=1e-6,
                               sparse_adam=True)
    opt = training.settings_optimizer(params.values(), s, sparse=[params["tables.l0"]])
    assert isinstance(opt.base, training.MaskedAdam)
    ref_W, state = {k: v.clone() for k, v in W.items()}, {}
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in W.items()}
        grads["tables.l0"][8 * step:8 * step + 24] = 0.0
        before = {k: opt.state[params["tables.l0"]][k].clone()
                  for k in ("exp_avg", "exp_avg_sq")} if opt.state else None
        p0 = params["tables.l0"].detach().clone()
        for k, p in params.items():
            p.grad = grads[k].clone()
        opt.step()
        ref.adam_step(ref_W, grads, state, CFG)
        still = grads["tables.l0"] == 0
        assert torch.equal(params["tables.l0"].detach()[still], p0[still])
        if before is not None:
            for k in before:
                assert torch.equal(opt.state[params["tables.l0"]][k][still], before[k][still])
        for k, p in params.items():
            torch.testing.assert_close(p.detach(), ref_W[k], rtol=1e-5, atol=1e-6)
    st = opt.state[params["tables.l0"]]
    assert st["entry_step"].min() == 0 and st["entry_step"].max() == 3
    # L2 on the matrix alone: its first moment holds 0.1 (g + 1e-6 w) summed over the steps
    assert opt.base.param_groups[1]["l2"] == 1e-6 and opt.base.param_groups[0]["l2"] == 0.0


def test_masked_adam_restored_without_entry_counts_counts_the_touched_entries():
    p = torch.nn.Parameter(torch.zeros(6, 2))
    opt = training.MaskedAdam([{"params": [p], "skip_zero": True}], lr=0.01)
    v = torch.zeros(6, 2)
    v[:3] = 1.0
    opt.state[p] = {"step": torch.tensor(5.0), "exp_avg": torch.zeros(6, 2), "exp_avg_sq": v}
    p.grad = torch.ones(6, 2)
    opt.step()
    assert opt.state[p]["entry_step"][:3].eq(6).all() and opt.state[p]["entry_step"][3:].eq(1).all()


def test_three_steps_of_the_train_block_match_train_steps():
    """make_train_block with make_grid_loss and MaskedAdam (float32
    products) against the reference's three steps: losses, the first
    gradient (exp_avg / (1 - b1)) and the change."""
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays

    g = torch.Generator().manual_seed(11)
    n_img, hw = 3, 64
    ro, rd = rays(n_img * hw, 12)
    data = {"rays_o": ro.reshape(1, n_img, hw, 3), "rays_d": rd.reshape(1, n_img, hw, 3),
            "pixels": torch.rand(1, n_img, hw, 3, generator=g)}
    W0 = weights(13)
    box = aabb_from_rays(data["rays_o"][0], data["rays_d"][0], 2.0, 6.0, margin=0.05)
    torch.testing.assert_close(box, ref.box_of(ro, rd, CFG), rtol=0, atol=0)
    s = training.TrainSettings(n_rand=32, n_samples=CFG["n_samples"], lr=CFG["lr"], adam_b2=0.99,
                               adam_eps=1e-15, l2_reg=1e-6, sparse_adam=True)
    cfg = model_cfg(box)
    m, opt = training.init_train_state(torch.Generator().manual_seed(0), s,
                                       init_fn=lambda gen, dev: GridNeRF(cfg, generator=gen))
    m.load_state_dict({k: v.clone() for k, v in W0.items()})
    seen = {}

    def hook(o, *_):
        if "grad1" not in seen:
            seen["grad1"] = {n: o.state[p]["exp_avg"] / 0.1 for n, p in m.named_parameters()}

    opt.base.register_step_post_hook(hook)
    block = training.make_train_block(s, 3, loss=grid_nerf.make_grid_loss(cfg))
    out = block(m, opt, 21, 0, *(data[k][0] for k in ("rays_o", "rays_d", "pixels")))
    want = ref.train_steps(W0, data, CFG, 21, 3, 32, prec="float32")
    torch.testing.assert_close(out["loss"], torch.tensor([l[0] for l in want["losses"]]),
                               rtol=1e-5, atol=0)
    for n, p in m.named_parameters():
        torch.testing.assert_close(seen["grad1"][n], want["grad1"][n], rtol=1e-4, atol=1e-9)
        torch.testing.assert_close(p.detach() - W0[n], want["change"][n], rtol=1e-3, atol=1e-6)


def test_encode_spans_and_counter_record_under_a_profiler_and_not_off():
    m = GridNeRF(model_cfg(), generator=torch.Generator().manual_seed(0))
    pts = torch.rand(100, 3) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn(100, 3), dim=-1)
    m(pts, d)[0].sum().backward()
    assert profiling.spans() == {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("step.grad"):
            m(pts, d)[0].sum().backward()
    got = profiling.spans()
    assert got[("grid.encode", "step.grad")]["count"] == 1
    assert got[("grid_points", "grid.encode")]["count"] == 100
    assert got[("grid.encode.bwd", "step.grad")]["count"] == 1
    names = {e.name for e in prof.events()}
    assert {"grid.encode", "grid.encode.bwd"} <= names


def test_the_sigma_noise_keeps_the_cpu_stream():
    """make_grid_loss draws the noise from the step's generator and scales
    it where the rays are: on the CPU the generator's own numbers."""
    z = torch.randn((8,), generator=torch.Generator().manual_seed(3))
    assert grid_nerf.to_rays_device(z, torch.device("cpu")) is z
    seen = {}
    cfg = model_cfg()
    m = GridNeRF(cfg, generator=torch.Generator().manual_seed(0))
    orig = m.forward

    def spy(pts, dirs, c=None, sigma_noise=None):
        seen["noise"] = sigma_noise
        return orig(pts, dirs, c, sigma_noise=sigma_noise)

    m.forward = spy
    s = training.TrainSettings(n_rand=4, n_samples=2, sigma_noise_std=0.5)
    ro, rd = rays(4, 1)
    grid_nerf.make_grid_loss(cfg)(m, ro, rd, torch.rand(4, 3), torch.Generator().manual_seed(9),
                                  s, noise_scale=0.5)
    want = (0.5 * 0.5) * torch.randn((8,), generator=torch.Generator().manual_seed(9))
    assert torch.equal(seen["noise"], want)


def test_defaults_are_unchanged():
    """The grid family's defaults and the optimizer make_optimizer builds
    without the new fields are what they were."""
    c = GridNeRFConfig()
    assert (c.n_levels, c.features, c.base_res, c.max_res, c.table_size, c.hidden,
            c.geo_features, c.num_freqs_dir) == (8, 2, 16, 128, 1 << 17, 64, 15, 4)
    assert (c.dir_encoding, c.density_activation, c.rgb_reads_density) == ("fourier", "relu",
                                                                           False)
    assert grid_nerf.grid_form_meta(c) == {}
    m = GridNeRF(c, generator=torch.Generator().manual_seed(0))
    assert m.mlp["rgb0"].in_features == 15 + 27
    s = training.TrainSettings()
    assert (s.adam_b2, s.adam_eps, s.l2_reg, s.sparse_adam) == (0.999, 1e-8, 0.0, False)
    p = [torch.nn.Parameter(torch.zeros(3, 2)), torch.nn.Parameter(torch.zeros(2))]
    opt = training.settings_optimizer(p, s)
    assert type(opt.base) is torch.optim.Adam
    d = opt.base.defaults
    assert (d["lr"], d["betas"], d["eps"], d["weight_decay"], d["amsgrad"]) == (
        5e-4, (0.9, 0.999), 1e-8, 0, False)
    opt = training.settings_optimizer(p, dataclasses.replace(s, weight_decay=0.1))
    assert type(opt.base) is torch.optim.AdamW
    assert [g["weight_decay"] for g in opt.base.param_groups] == [0.1, 0.0]
    with pytest.raises(ValueError):
        training.settings_optimizer(p, dataclasses.replace(s, weight_decay=0.1, l2_reg=1e-6))


def test_the_published_flags_reach_the_model_and_the_optimizer():
    c = Config(model="grid", grid_levels=16, grid_max_res=2048, grid_table_size=1 << 19,
               grid_dir_encoding="sh", grid_density_activation="exp",
               grid_rgb_reads_density=True, lr=0.01, adam_b2=0.99, adam_eps=1e-15, l2_reg=1e-6,
               sparse_adam=True, n_rand=4096)
    g = c.grid_cfg()
    assert g.level_resolutions()[:6] == (16, 22, 31, 42, 58, 81)
    assert sum(g.level_is_dense()) == 5 and sum(g.level_table_sizes()) == 6_101_902
    m = GridNeRF(g, device="meta")
    assert sum(p.numel() for p in m.parameters()) == 12_213_423
    assert sum(p.numel() for p in m.mlp.parameters()) == 9_619
    s = c.train_settings()
    assert (s.adam_b2, s.adam_eps, s.l2_reg, s.sparse_adam, s.n_rand) == (0.99, 1e-15, 1e-6, True,
                                                                          4096)
    meta = grid_nerf.grid_form_meta(g)
    assert meta == {"dir_encoding": "sh", "density_activation": "exp", "rgb_reads_density": True}
    assert ref.n_params({**CFG, "n_levels": 16, "max_res": 2048, "table_size": 1 << 19}) == \
        12_213_423
