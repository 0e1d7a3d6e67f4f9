"""No wait for the device inside a kernel wrapper, a view or a training
step: each K1-K7 wrapper call (and the scene-axis ones), one view of each
render recipe that runs them and one block of each training recipe that
runs them, under torch.cuda.set_sync_debug_mode("error"), which raises on
any synchronising call (a copy from pageable host memory included); each
one's outputs bit-identical to the same call with the padding rows and
int seeds built on the host and copied to the device, as the wrappers
built them before they were filled in on the device. A profiler trace of
one view of each benchmark render recipe holds no cudaStreamSynchronize,
cudaDeviceSynchronize or copy between host and device (cudaMemcpy*)
inside `view`: only the copies from device to device that torch.sort
makes, which wait for nothing.

Skips without a CUDA device. This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda_sync.py
"""

import contextlib
import importlib

import pytest
import torch

from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, NeRFMLP
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig

# The modules that bind pad_rays, pad_rows and the functions that make the seeds.
PAD_SITES = ("kernels.fused_nerf", "kernels.fused_nerf_stream", "kernels.fused_nerf_train",
             "kernels.fused_partials", "kernels.fused_render", "render", "parallel.render")
ROW_SITES = ("kernels.fused_nerf", "kernels.fused_nerf_stream", "kernels.fused_nerf_train",
             "kernels.fused_partials", "kernels.fused_train")
SEED_SITES = ("kernels.fused_train", "kernels.fused_nerf_train")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")

TINY = TinyNeRFConfig()  # the TinyNeRF recipe: 4 x 128, L = 10, bf16
FLAGSHIP = NeRFConfig(hidden=256, rgb_hidden=128)  # the NeRF paper's 8 x 256, bf16
SEEDS = (5, 9, 13)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _module(name):
    return importlib.import_module(f"tinynerf_tpu_torch.{name}")


def _host_pad_rays(rays_o, rays_d, pad: int):
    lead = rays_o.shape[:-2]
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=rays_d.device)
    return (torch.cat([rays_o, rays_o.new_zeros(*lead, pad, 3)], dim=-2).contiguous(),
            torch.cat([rays_d, unit_z.expand(*lead, pad, 3)], dim=-2).contiguous())


def _copied_pad_rows(x, pad, fill=0.0):
    return torch.cat([x, x.new_full((*x.shape[:-2], pad, x.shape[-1]), fill)], dim=-2).contiguous()


def _host_seed_tensor(seed, device):
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(torch.int32).contiguous()
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _host_seeds_tensor(seeds, n_scenes, device):
    if isinstance(seeds, torch.Tensor):
        return seeds.reshape(n_scenes).to(torch.int32).contiguous()
    return torch.tensor([int(x) for x in seeds], dtype=torch.int32, device=device)


def _host_default_aabb(half_extent=3.0, device=None):
    return torch.tensor([[-half_extent] * 3, [half_extent] * 3], dtype=torch.float32,
                        device=device)


def _host_linspace(start, stop, num, device=None):
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


@contextlib.contextmanager
def host_built_values(calls):
    """The values built on the host and copied to the device, as before:
    every padding row, int seed, occupancy box and segment edge; and every
    other padding a copy, even of no rows. Counts each call in calls[0]."""
    def counted(fn):
        def wrapped(*args, **kwargs):
            calls[0] += 1
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as m:
        for name in PAD_SITES:
            m.setattr(_module(name), "pad_rays", counted(_host_pad_rays))
        for name in ROW_SITES:
            m.setattr(_module(name), "pad_rows", _copied_pad_rows)
        for name in SEED_SITES:
            m.setattr(_module(name), "_seed_tensor", counted(_host_seed_tensor))
            m.setattr(_module(name), "_seeds_tensor", counted(_host_seeds_tensor))
        occ = _module("ops.occupancy")
        m.setattr(occ, "default_aabb", counted(_host_default_aabb))
        m.setattr(occ, "linspace", counted(_host_linspace))
        yield


@contextlib.contextmanager
def no_sync():
    """Raise on any call that waits for the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


def check_waits_for_nothing(setup, run):
    """run(setup()) with the host-built values, then run(setup()) again
    (setup outside) under no_sync: the same tensors bit for bit."""
    calls = [0]
    with host_built_values(calls):
        want = [t.detach().clone() for t in _flat(run(setup()))]
    assert calls[0] > 0, "the reference built nothing on the host"
    state = setup()
    with no_sync():
        got = _flat(run(state))
    got = [t.detach().clone() for t in got]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _rays(*lead, seed, device):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(*lead, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 4.0])
    rd = torch.randn(*lead, 3, generator=g)
    rd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True) * 0.5
    rd[..., 2] -= 1.0  # towards the origin
    target = torch.rand(*lead, 3, generator=g)
    return ro.to(device), rd.to(device), target.to(device)


def _depths(*lead, S, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.sort(2.0 + 4.0 * torch.rand(*lead, S, generator=g), dim=-1).values.to(device)


def _stack(make, device):
    from tinynerf_tpu_torch.models.stacked import stack_models

    return stack_models([make(torch.Generator().manual_seed(s), device) for s in SEEDS])


def _tiny(device, seed=2):
    return TinyNeRF(TINY, generator=torch.Generator().manual_seed(seed), device=device)


def _mlp(device, seed=3):
    return NeRFMLP(FLAGSHIP, generator=torch.Generator().manual_seed(seed), device=device)


def _wrapper_case(name, n, device):
    """(setup, run) of one wrapper call on n rays (a scene axis of 3)."""
    from tinynerf_tpu_torch.kernels import fused_nerf, fused_nerf_stream, fused_nerf_train
    from tinynerf_tpu_torch.kernels import fused_partials, fused_render, fused_train

    K = len(SEEDS)
    if name == "K1":
        return (lambda: (_tiny(device), *_rays(n, seed=1, device=device)[:2]),
                lambda a: fused_render.fused_render_rays(*a, n_samples=64))
    if name == "K2":  # an int seed
        return (lambda: (_tiny(device), *_rays(n, seed=2, device=device)),
                lambda a: fused_train.fused_loss_grads(*a, 7, n_samples=64))
    if name == "K2-scenes":  # a list of int seeds
        return (lambda: (_stack(lambda g, d: TinyNeRF(TINY, generator=g, device=d), device),
                         *_rays(K, n, seed=3, device=device)),
                lambda a: fused_train.fused_loss_grads_scenes(*a, list(SEEDS), n_samples=64))
    if name == "K3-coarse":
        return (lambda: (_mlp(device), *_rays(n, seed=4, device=device)[:2]),
                lambda a: fused_nerf.fused_nerf_render_rays(*a, n_samples=64,
                                                            return_weights=True))
    if name == "K3-fine":
        return (lambda: (_mlp(device), *_rays(n, seed=5, device=device)[:2],
                         _depths(n, S=192, seed=5, device=device)),
                lambda a: fused_nerf.fused_nerf_render_rays(*a))
    if name == "K5":
        return (lambda: (_mlp(device), *_rays(n, seed=6, device=device)[:2],
                         _depths(n, S=512, seed=6, device=device)),
                lambda a: fused_nerf_stream.fused_nerf_render_rays_streamed(*a, sample_block=64))
    if name == "K4":  # an int seed, depths drawn in the kernel
        return (lambda: (_mlp(device), *_rays(n, seed=7, device=device)),
                lambda a: fused_nerf_train.fused_nerf_pass_grads(*a, 11, n_samples=64,
                                                                 emit_sampling=True))
    if name == "K4-scenes":
        return (lambda: (_stack(lambda g, d: NeRFMLP(FLAGSHIP, generator=g, device=d), device),
                         *_rays(K, n, seed=8, device=device)),
                lambda a: fused_nerf_train.fused_nerf_pass_grads_scenes(
                    *a, list(SEEDS), n_samples=64, emit_sampling=True))
    if name == "K6":
        return (lambda: (_mlp(device), *_rays(n, seed=9, device=device),
                         _depths(n, S=192, seed=9, device=device)),
                lambda a: fused_nerf_stream.fused_nerf_pass_grads_streamed(*a, sample_block=64))
    if name == "K6-scenes":
        return (lambda: (_stack(lambda g, d: NeRFMLP(FLAGSHIP, generator=g, device=d), device),
                         *_rays(K, n, seed=10, device=device),
                         _depths(K, n, S=192, seed=10, device=device)),
                lambda a: fused_nerf_stream.fused_nerf_pass_grads_streamed_scenes(
                    *a, sample_block=64))
    if name == "K7":  # forward and backward
        from tinynerf_tpu_torch.ops.volume import global_deltas

        def setup():
            mlp = _mlp(device)
            ro, rd, _ = _rays(n, seed=11, device=device)
            z_union = _depths(n, S=192, seed=11, device=device)
            deltas = global_deltas(z_union, rd)
            g = torch.Generator(device=device).manual_seed(11)
            noise = 0.5 * torch.randn(n, 96, generator=g, device=device)
            cot = [torch.randn(*shape, generator=g, device=device) / n
                   for shape in ((n, 3), (n,), (n,), (n,), (n, 96))]
            return (mlp, ro, rd, z_union[:, 96:].contiguous(), deltas[:, 96:].contiguous(),
                    noise, cot)

        def run(a):
            mlp, *inputs, cot = a
            fn = fused_partials.make_fused_block_partials_fn(FLAGSHIP, emit_weights=True,
                                                             sample_block=48)
            partials, w = fn(mlp, *inputs)
            outs = [partials[k] for k in ("C", "A", "T", "D")] + [w]
            return outs, torch.autograd.grad(outs, list(mlp.parameters()), grad_outputs=cot)

        return setup, run
    raise ValueError(name)


WRAPPERS = ("K1", "K2", "K2-scenes", "K3-coarse", "K3-fine", "K5", "K4", "K4-scenes", "K6",
            "K6-scenes", "K7")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 2048])  # padding rays in every tile size; none
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_call_waits_for_nothing_on_card(cuda_device, name, n):
    with torch.enable_grad():  # K7's backward
        check_waits_for_nothing(*_wrapper_case(name, n, cuda_device))


def _renderer(recipe, H, W):
    from tinynerf_tpu_torch import render

    kw = dict(H=H, W=W, focal=1.2 * W, use_fused=True)
    if recipe == "tinynerf":  # K1 a chunk
        return render.make_image_renderer(chunk=8192, n_samples=64, model_cfg=TINY, **kw), _tiny
    if recipe == "nerf":  # K3 twice a chunk
        return (render.make_hierarchical_image_renderer(chunk=4096, n_coarse=64, n_fine=128,
                                                        nerf_cfg=FLAGSHIP, **kw),
                lambda d: NeRF(FLAGSHIP, generator=torch.Generator().manual_seed(4), device=d))
    if recipe == "nerf-streamed":  # K3 coarse, K5 fine (a union of 512)
        return (render.make_hierarchical_image_renderer(chunk=1024, n_coarse=64, n_fine=448,
                                                        nerf_cfg=FLAGSHIP, **kw),
                lambda d: NeRF(FLAGSHIP, generator=torch.Generator().manual_seed(4), device=d))
    if recipe == "occupancy":  # the density grid, then K5 a chunk
        return (render.make_occupancy_image_renderer(chunk=1024, n_samples=192,
                                                     nerf_cfg=FLAGSHIP, **kw),
                lambda d: NeRF(FLAGSHIP, parts=("fine",),
                               generator=torch.Generator().manual_seed(5), device=d))
    raise ValueError(recipe)


def _pose(device):
    """A camera at z = 4 looking down -z, at the origin."""
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    return pose.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["tinynerf", "nerf", "nerf-streamed", "occupancy"])
def test_view_waits_for_nothing_on_card(cuda_device, recipe):
    """One view of 100 x 90 rays: the view's own padding and the chunks'."""
    fn, make = _renderer(recipe, 100, 90)
    check_waits_for_nothing(lambda: (make(cuda_device), _pose(cuda_device)),
                            lambda a: fn(*a))


def _train_case(recipe, device):
    """(setup, run) of a block of 2 steps of a training recipe: 300 rays a
    step (a scene), so every pass pads."""
    import dataclasses

    from tinynerf_tpu_torch import multiscene, training
    from tinynerf_tpu_torch.kernels import fused_nerf_train, fused_train

    s = training.TrainSettings(n_rand=300, n_samples=64, model_cfg=TINY)
    K = len(SEEDS)

    def data(*lead):
        ro, rd, px = _rays(*lead, 4, 512, seed=20, device=device)
        return ro, rd, px

    def nerf(parts=("coarse", "fine")):
        return lambda g, d: NeRF(FLAGSHIP, parts=parts, generator=g, device=d)

    if recipe == "tinynerf":
        block = training.make_train_block(s, 2, grad_fn=fused_train.make_fused_grad_fn(s))

        def setup():
            model = _tiny(device)
            return model, training.settings_optimizer(model.parameters(), s), 3, 0, *data()
    elif recipe == "tinynerf-scenes":
        block = multiscene.make_multiscene_train_block(
            s, 2, K, grad_fn=fused_train.make_fused_grad_fn_scenes(s))

        def setup():
            return (*multiscene.init_multiscene_state(3, K, s, device=device), 3, 0, *data(K))
    elif recipe in ("nerf", "nerf-fine-k4"):
        n_fine = 128 if recipe == "nerf" else 16  # the fine pass on K6; on K4
        grad_fn = fused_nerf_train.make_fused_nerf_grad_fn(s, FLAGSHIP, n_fine=n_fine)
        block = training.make_train_block(s, 2, grad_fn=grad_fn)

        def setup():
            model = nerf()(torch.Generator().manual_seed(6), device)
            return model, training.settings_optimizer(model.parameters(), s), 3, 0, *data()
    elif recipe == "nerf-scenes":
        block = multiscene.make_multiscene_train_block(
            s, 2, K, grad_fn=fused_nerf_train.make_fused_nerf_grad_fn_scenes(s, FLAGSHIP,
                                                                             n_fine=128))

        def setup():
            return (*multiscene.init_multiscene_state(3, K, s, device=device, init_fn=nerf()),
                    3, 0, *data(K))
    elif recipe == "nerf-sharded":  # K7 on a world of one
        from tinynerf_tpu_torch.parallel.mesh import make_mesh
        from tinynerf_tpu_torch.parallel.train import make_sharded_train_block

        block = make_sharded_train_block(s, 2, make_mesh(), nerf_cfg=FLAGSHIP, n_fine=128,
                                         fused_kernels=True)

        def setup():
            model = nerf()(torch.Generator().manual_seed(6), device)
            return model, training.settings_optimizer(model.parameters(), s), 3, 0, *data()
    elif recipe == "occupancy":  # the grid, then K6 on its depths
        from tinynerf_tpu_torch.ops.occupancy import make_occupancy_train_block

        s = dataclasses.replace(s, n_samples=192)
        block = make_occupancy_train_block(s, 2, FLAGSHIP, fused=True)

        def setup():
            model = nerf(("fine",))(torch.Generator().manual_seed(6), device)
            return model, training.settings_optimizer(model.parameters(), s), 3, 0, *data()
    else:
        raise ValueError(recipe)

    def run(a):
        model = a[0]
        return block(*a), [p.detach() for p in model.parameters()]

    return setup, run


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["tinynerf", "tinynerf-scenes", "nerf", "nerf-fine-k4",
                                    "nerf-scenes", "nerf-sharded", "occupancy"])
def test_training_block_waits_for_nothing_on_card(cuda_device, recipe):
    """Two steps: draws, both passes, sample_pdf, Adam; the parameters and
    the metrics after them."""
    with torch.enable_grad():
        check_waits_for_nothing(*_train_case(recipe, cuda_device))


def traced_waits(fn, *args) -> dict:
    """{runtime call: count} of the calls that wait for the device or copy
    (WAITS) inside the `view` span of one traced fn(*args), after an
    untraced warm-up call; a copy is named with its device event's name
    (its kind: HtoD, DtoH, DtoD)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kind = {e.id: e.name for e in events if e.device_type == cuda and e.name.startswith("Memcpy")}
    views = [e for e in events if e.name == "view" and e.device_type != cuda]
    assert len(views) == 1
    t0, t1 = views[0].time_range.start, views[0].time_range.end
    out = {}
    for e in events:
        if e.device_type != cuda and e.name.startswith(WAITS) and t0 <= e.time_range.start <= t1:
            name = f"{e.name} ({kind[e.id]})" if e.id in kind else e.name
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["tinynerf", "nerf"])
def test_a_traced_view_holds_no_copy_or_sync_on_card(cuda_device, recipe):
    """One 400 x 400 view of each benchmark render recipe (K1 on chunks of
    8192 rays; K3 twice on chunks of 4096) under the profiler: no wait and
    no copy to or from the host."""
    fn, make = _renderer(recipe, 400, 400)
    waits = traced_waits(fn, make(cuda_device), _pose(cuda_device))
    print(recipe, waits)
    assert {k: n for k, n in waits.items() if "Memcpy DtoD" not in k} == {}
