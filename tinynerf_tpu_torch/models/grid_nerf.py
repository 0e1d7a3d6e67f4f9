"""Multi-resolution grid-encoded NeRF (Instant-NGP-style), the third
model family.

Port of tinynerf_tpu/models/grid_nerf.py. A pyramid of n_levels feature
tables (features per level), resolutions on a geometric ladder
base_res -> max_res; a level whose (R+1)^3 corners fit table_size is
dense (exact, collision-free), a finer one reads an xor-prime spatial
hash modulo table_size. A point is normalized to [0, 1]^3 by the scene
box (aabb, clamped), each level blends its cell's 8 corners trilinearly,
and the concatenated features feed a geometry MLP (feat -> hidden -> 1
sigma + geo_features) and a colour MLP ((geo_features + direction
encoding) -> hidden -> hidden -> 3). One stratified pass is composited
by ops/volume.py.

The JAX package runs the family in XLA by design, with no Pallas
kernel; the port runs the encoding on the card in kernels of its own
(csrc/grid_encode.cu, kernels/grid_encode.py) and the rest in eager
torch, on whatever device holds the model. The JAX package's three gather
strategies (encode_impl loop | cat | cat_pib) are numerically identical;
the port has one. encode_impl is accepted and ignored, so the JAX
package's configurations parse.

Parameter names: GridNeRF holds `tables` (an nn.ParameterDict of l0 ...
l{n-1}, each (T_l, features)) and `mlp` (geo0, geo1, rgb0, rgb1, rgb2,
nn.Linear, weight (out, in)). The JAX tree is {'tables': {'l0': ...},
'mlp': {'geo0': {'w', 'b'}, ...}} with w as (in, out);
grid_params_from_jax / grid_params_to_jax convert.

The MLP's layers cast the input, the weight and the bias to
compute_dtype and add the bias in that dtype (the JAX _dense_layer):
in bf16 the product and the sum are each rounded to bf16.
Interpolation and compositing run in float32.

Instant-NGP's published form (Mueller et al. 2022, arXiv:2201.05989)
takes three fields, each off by default (the JAX package's model):
dir_encoding="sh" (the view direction on the 16 real spherical
harmonics of degree < 4, ops/encoding.sh_encoding, instead of the
Fourier bands), density_activation="exp" (the first density output is
log-space density, sigma = exp(raw)) and rgb_reads_density=True (the
colour MLP reads all 1 + geo_features density outputs, the raw density
among them). Its flags: config.py, train.py.

The encoding is an autograd Function (_GridEncode) over two entry
points: encode_levels, the gather and trilinear blend of every level,
and encode_levels_bwd, every table's gradient. The forward keeps only
the normalized points; the backward recomputes each corner's id and
weight from them. On a CUDA device both are the kernels of
kernels/grid_encode.py (one launch forward; keys, a stable radix sort and
a sum of each entry's run in the sorted order backward, no float
atomics); on the CPU their plain versions, encode_levels_plain (every
level's ids at once, one gather from the tables laid end to end, one
blend) and encode_levels_bwd_plain (index_put_(accumulate=True), which
sums each entry's corners in a fixed order: on the card it sorts the ids
first, on the CPU a call a level on one thread's order). Both routes give
the sums autograd's IndexBackward of a level's gather makes, so the
tables' gradients are bit-identical to autograd's of the per-level gather
at two or more features a level, on the CPU and on the card
(tests/test_torch_port_instant_ngp.py), and two runs from one seed are
bit-identical. F.embedding's CUDA backward is not: on an H100,
tests/test_torch_port_cuda.py's grid case saw two backward passes
differ. The points take no gradient. Spans (utils/profiling.py):
grid.encode around the forward, with the counters grid_points (points
encoded, from the shape) and, on the card, grid_kernel_launches, and
grid.encode.bwd around the backward (grid_kernel_launches again), which
runs on autograd's device thread on the card while the caller waits in
backward(), so it nests under the caller's open span.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinynerf_tpu_torch.kernels.grid_encode import grid_encode_bwd, grid_encode_fwd
from tinynerf_tpu_torch.ops.encoding import SH_DIM, encoding_dim, positional_encoding, sh_encoding
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render
from tinynerf_tpu_torch.utils.profiling import count, span

# The paper's spatial-hash primes (pi_1 = 1 keeps x-major locality).
_HASH_PRIMES = (1, 2654435761, 805459861)

# Corner offsets of the unit cube (8, 3), corner c = (bit 2, bit 1, bit 0).
_CORNERS = np.stack([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class GridNeRFConfig:
    """The JAX package's GridNeRFConfig: same fields, defaults and helpers;
    compute_dtype is a torch dtype."""

    n_levels: int = 8
    features: int = 2  # per-level feature width
    base_res: int = 16  # coarsest grid resolution
    max_res: int = 128  # finest grid resolution
    table_size: int = 1 << 17  # hashed-level budget (entries per level)
    hidden: int = 64  # MLP width (both branches)
    geo_features: int = 15  # latent geometry features fed to colour
    num_freqs_dir: int = 4  # Fourier bands for view directions
    # Scene bounds (lo_xyz, hi_xyz); the driver derives them from the
    # capture and persists them in checkpoint meta.
    aabb: Tuple[float, float, float, float, float, float] = (-4.0, -4.0, -4.0, 4.0, 4.0, 4.0)
    compute_dtype: torch.dtype = torch.bfloat16  # MLP matmul dtype; params stay f32
    encode_impl: str = "loop"  # accepted for the JAX package's flags; the port has one gather
    dir_encoding: str = "fourier"  # "fourier" (num_freqs_dir bands) | "sh" (degree < 4)
    density_activation: str = "relu"  # sigma = relu(raw) | "exp": exp(raw), log-space density
    rgb_reads_density: bool = False  # colour reads all 1 + geo_features outputs, not geo_features

    def __post_init__(self):
        if self.dir_encoding not in ("fourier", "sh"):
            raise ValueError(f"dir_encoding={self.dir_encoding!r} (expected 'fourier'|'sh')")
        if self.density_activation not in ("relu", "exp"):
            raise ValueError(
                f"density_activation={self.density_activation!r} (expected 'relu'|'exp')")

    def dir_dim(self) -> int:
        return SH_DIM if self.dir_encoding == "sh" else encoding_dim(self.num_freqs_dir)

    def rgb_in_dim(self) -> int:
        return self.geo_features + int(self.rgb_reads_density) + self.dir_dim()

    def level_resolutions(self) -> Tuple[int, ...]:
        """Geometric ladder base_res -> max_res over n_levels (Python's
        round on the JAX package's float expression)."""
        if self.n_levels == 1:
            return (self.base_res,)
        g = (self.max_res / self.base_res) ** (1.0 / (self.n_levels - 1))
        return tuple(int(round(self.base_res * g**l)) for l in range(self.n_levels))

    def level_table_sizes(self) -> Tuple[int, ...]:
        """Entries per level: dense (R+1)^3 when it fits, else hashed."""
        return tuple(min((r + 1) ** 3, self.table_size) for r in self.level_resolutions())

    def level_is_dense(self) -> Tuple[bool, ...]:
        return tuple((r + 1) ** 3 <= self.table_size for r in self.level_resolutions())


class GridNeRF(nn.Module):
    """World points (N, 3) and unit view directions (N, 3) -> (rgb (N, 3),
    sigma (N,))."""

    def __init__(
        self,
        cfg: GridNeRFConfig = GridNeRFConfig(),
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterDict({
            f"l{l}": nn.Parameter(torch.empty(t, cfg.features))
            for l, t in enumerate(cfg.level_table_sizes())
        })
        feat_dim = cfg.n_levels * cfg.features
        h = cfg.hidden
        self.mlp = nn.ModuleDict({
            "geo0": nn.Linear(feat_dim, h, device="meta"),
            "geo1": nn.Linear(h, 1 + cfg.geo_features, device="meta"),
            "rgb0": nn.Linear(cfg.rgb_in_dim(), h, device="meta"),
            "rgb1": nn.Linear(h, h, device="meta"),
            "rgb2": nn.Linear(h, 3, device="meta"),
        })
        self.mlp.to_empty(device="cpu")
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Tables ~ U(-1e-4, 1e-4) (near zero: the model starts as an empty
        field); every MLP weight and bias ~ U(-1/sqrt(fan_in),
        1/sqrt(fan_in)); drawn on the CPU from `generator`, tables first."""
        for table in self.tables.values():
            u = torch.rand(table.shape, generator=generator, dtype=torch.float32)
            table.copy_((u * 2.0 - 1.0) * 1e-4)
        for lin in self.mlp.values():
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_((u * 2.0 - 1.0) * bound)

    def sparse_parameters(self) -> list:
        """The tables: the parameters whose untouched entries get exactly
        zero gradient (training.MaskedAdam skips them)."""
        return list(self.tables.values())

    def forward(
        self,
        pts: torch.Tensor,
        dirs: torch.Tensor,
        cfg: Optional[GridNeRFConfig] = None,
        sigma_noise: Optional[torch.Tensor] = None,
    ):
        """apply_grid_nerf (tinynerf_tpu/models/grid_nerf.py:230-261): `cfg`
        overrides the module's own (its box and compute dtype); sigma =
        relu(raw + sigma_noise) (or exp of it), the noise reshaped to (N,)."""
        cfg = cfg or self.cfg
        dt = cfg.compute_dtype
        feat = grid_encode(self.tables, pts, cfg)
        mlp = self.mlp
        h = torch.relu(_dense(feat, mlp["geo0"], dt))
        geo = _dense(h, mlp["geo1"], dt).float()
        sigma_raw = geo[:, 0]
        if sigma_noise is not None:
            sigma_raw = sigma_raw + sigma_noise.reshape(sigma_raw.shape)
        sigma = torch.exp(sigma_raw) if cfg.density_activation == "exp" else torch.relu(sigma_raw)
        if cfg.dir_encoding == "sh":
            denc = sh_encoding(dirs)
        else:
            denc = positional_encoding(dirs.float(), num_freqs=cfg.num_freqs_dir)
        c = torch.cat([geo if cfg.rgb_reads_density else geo[:, 1:], denc], dim=-1)
        c = torch.relu(_dense(c, mlp["rgb0"], dt))
        c = torch.relu(_dense(c, mlp["rgb1"], dt))
        rgb = torch.sigmoid(_dense(c, mlp["rgb2"], dt).float())
        return rgb, sigma


def _dense(h: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """h @ w + b with the input, the weight and the bias cast to dt, the
    bias added in dt (the JAX package's _dense_layer)."""
    return F.linear(h.to(dt), layer.weight.to(dt)) + layer.bias.to(dt)


# Made once per box and device, so that an encode copies nothing from the
# host (a blocking copy on CUDA). Read-only.
@functools.lru_cache(maxsize=16)
def _box(aabb: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(aabb, dtype=torch.float32).reshape(2, 3).to(device)


@functools.lru_cache(maxsize=4)
def _corner_offsets(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_CORNERS).to(device)


@functools.lru_cache(maxsize=16)
def _ladder(resolutions: tuple, device: torch.device) -> tuple:
    """(res as float32, res - 1, res + 1), each (G, 1, 1), of G levels:
    made once per ladder and device, so an encode copies nothing from the
    host. Read-only."""
    r = torch.tensor(resolutions, dtype=torch.int64).reshape(-1, 1, 1).to(device)
    return r.to(torch.float32), r - 1, r + 1


def levels_ids(u: torch.Tensor, resolutions: tuple, dense: bool, table_size: int):
    """Corner ids and trilinear weights of normalized points u in [0, 1]^3
    on G levels of one kind (all dense or all hashed) -> (lin (G, N, 8)
    int64, w (G, N, 8) float32), the levels side by side in one set of ops.

    The cell and its fraction are taken in float32 in the JAX order (a
    point moved across a cell face reads other corners). The hash is the
    JAX package's uint32 arithmetic done exactly in int64: with m =
    table_size - 1 < 2^32, (x mod 2^32) & m == x & m and & distributes
    over ^, so each product is masked before the xor; id * prime < 2^63
    for any resolution below 2^31."""
    corners = _corner_offsets(u.device)  # (8, 3)
    res, res_max, side = _ladder(tuple(resolutions), u.device)
    xs = u * res  # (G, N, 3) corner coordinates in [0, res]
    i0 = torch.minimum(torch.floor(xs).to(torch.int64), res_max)  # u == 1 in the last cell
    f = xs - i0.to(torch.float32)  # in [0, 1]
    ids = i0[:, :, None, :] + corners  # (G, N, 8, 3)
    if dense:
        lin = (ids[..., 0] * side + ids[..., 1]) * side + ids[..., 2]
    else:
        m = table_size - 1
        lin = ((ids[..., 0] * _HASH_PRIMES[0]) & m) ^ ((ids[..., 1] * _HASH_PRIMES[1]) & m) \
            ^ ((ids[..., 2] * _HASH_PRIMES[2]) & m)
    # Per-axis factor f where the corner's bit is set, else 1 - f; their
    # product in axis order.
    fac = torch.where(corners.bool(), f[:, :, None, :], 1.0 - f[:, :, None, :])  # (G, N, 8, 3)
    w = fac[..., 0] * fac[..., 1] * fac[..., 2]
    return lin, w


def level_ids(u: torch.Tensor, res: int, dense: bool, table_size: int):
    """levels_ids of one level -> (lin (N, 8) int64, w (N, 8) float32)."""
    lin, w = levels_ids(u, (res,), dense, table_size)
    return lin[0], w[0]


@functools.lru_cache(maxsize=16)
def _level_offsets(sizes: tuple, device: torch.device) -> torch.Tensor:
    """(L, 1, 1) int64: each level's first entry in the tables laid end to
    end. Made once per ladder and device; read-only."""
    starts = [sum(sizes[:l]) for l in range(len(sizes))]
    return torch.tensor(starts, dtype=torch.int64).reshape(-1, 1, 1).to(device)


def corner_ids(u: torch.Tensor, cfg: GridNeRFConfig, sizes):
    """Every level's corner ids in the tables laid end to end (n_levels,
    N, 8) and their weights (n_levels, N, 8). The ladder rises, so its
    dense levels come first: the ids and weights of the dense levels, then
    of the hashed ones, each in one set of ops."""
    res, n_dense = cfg.level_resolutions(), sum(cfg.level_is_dense())
    lins, ws = [], []
    for group, dense in ((res[:n_dense], True), (res[n_dense:], False)):
        if group:
            lin, w = levels_ids(u, group, dense, cfg.table_size)
            lins.append(lin)
            ws.append(w)
    ids = torch.cat(lins) if len(lins) > 1 else lins[0]  # (L, N, 8)
    w = torch.cat(ws) if len(ws) > 1 else ws[0]
    return ids + _level_offsets(tuple(sizes), u.device), w


def encode_levels_plain(tables, u: torch.Tensor, cfg: GridNeRFConfig) -> torch.Tensor:
    """The encoding's forward in torch ops: normalized points u (N, 3) and
    the level tables (a sequence, level order) -> features (N, n_levels *
    features): corner_ids, one gather from the tables laid end to end, one
    blend."""
    ids, w = corner_ids(u, cfg, [t.shape[0] for t in tables])
    corners = torch.cat(list(tables))[ids]  # (L, N, 8, F)
    feats = torch.sum(w[..., None] * corners, dim=2)  # (L, N, F)
    return feats.permute(1, 0, 2).reshape(u.shape[0], -1)


def encode_levels_bwd_plain(grad: torch.Tensor, u: torch.Tensor, cfg: GridNeRFConfig,
                            sizes) -> list:
    """The encoding's backward in torch ops: the features' gradient (N,
    n_levels * features) -> each table's gradient, the ids and weights
    recomputed from u (corner_ids): the corner-weighted gradient of every
    level summed into the tables laid end to end by
    index_put_(accumulate=True), as autograd's IndexBackward of a level's
    gather does, split into the tables. On the card one call does every
    level: it sorts the ids and sums each entry's run of duplicates in the
    stable sort's order, which a level's own call gives too. The CPU adds
    an input past its grain size in parallel, in the order its threads
    reach an entry, so there a call a level keeps autograd's order."""
    ids, w = corner_ids(u, cfg, sizes)
    n, n_levels = grad.shape[0], len(sizes)
    g = grad.reshape(n, n_levels, -1).permute(1, 0, 2)[:, :, None, :] * w[..., None]
    flat = grad.new_zeros((sum(sizes), g.shape[-1]))
    if flat.is_cuda:
        flat.index_put_((ids,), g, accumulate=True)
    else:
        for ids_l, g_l in zip(ids, g):
            flat.index_put_((ids_l,), g_l, accumulate=True)
    return list(flat.split(list(sizes)))


def encode_levels(tables, u: torch.Tensor, cfg: GridNeRFConfig) -> torch.Tensor:
    """The encoding's forward: the gather and blend of every level ->
    features (N, n_levels * features). CPU tensors take the plain version,
    any other the kernel (kernels/grid_encode.py), which raises on what it
    does not take: no fallback."""
    if u.device.type == "cpu":
        return encode_levels_plain(tables, u, cfg)
    return grid_encode_fwd(tables, u, cfg)


def encode_levels_bwd(grad: torch.Tensor, u: torch.Tensor, cfg: GridNeRFConfig, sizes) -> list:
    """The encoding's backward, the whole of it (the zeroing, the keys, the
    sort, the sums and the split): the features' gradient and the forward's
    points -> each table's gradient. CPU tensors take the plain version,
    any other the kernels (kernels/grid_encode.py), which raise on what
    they do not take."""
    if u.device.type == "cpu":
        return encode_levels_bwd_plain(grad, u, cfg, sizes)
    return grid_encode_bwd(grad, u, cfg, sizes)


class _GridEncode(torch.autograd.Function):
    """encode_levels with encode_levels_bwd as its backward, both called
    through the module's globals with positional arguments (the benchmark
    wraps them by name); the forward keeps only the points, and the points
    take no gradient."""

    @staticmethod
    def forward(ctx, u, cfg, *tables):
        ctx.cfg = cfg
        ctx.sizes = [t.shape[0] for t in tables]
        ctx.save_for_backward(u)
        return encode_levels(tables, u, cfg)

    @staticmethod
    def backward(ctx, grad):
        (u,) = ctx.saved_tensors
        with span("grid.encode.bwd"):
            grads = encode_levels_bwd(grad, u, ctx.cfg, ctx.sizes)
        return (None, None, *grads)


def grid_encode(tables, pts: torch.Tensor, cfg: GridNeRFConfig) -> torch.Tensor:
    """(N, 3) world points -> (N, n_levels * features) float32 features.
    `tables` maps l0 ... to (T_l, features). Points are normalized by the
    box and clamped to it (out-of-box points read border cells)."""
    with span("grid.encode"):
        count("grid_points", pts.shape[0])
        lo, hi = _box(tuple(float(v) for v in cfg.aabb), pts.device)
        u = torch.clamp((pts.float() - lo) / (hi - lo), 0.0, 1.0)
        return _GridEncode.apply(u, cfg, *(tables[f"l{l}"] for l in range(cfg.n_levels)))


def render_rays_grid(
    model: GridNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    cfg: GridNeRFConfig,
    n_samples: int,
    near: float,
    far: float,
    white_bkgd: bool = True,
    sigma_noise: Optional[torch.Tensor] = None,
):
    """One stratified pass: sample (jittered from `generator`, or at the
    bin edges without one), encode, composite. Returns (comp_rgb (R, 3),
    depth (R, 1), acc (R, 1), weights (R, S), z_vals (R, S))."""
    n_rays = rays_o.shape[0]
    z_vals, pts = stratified_samples(near, far, n_samples, rays_o, rays_d,
                                     randomized=generator is not None, generator=generator)
    dirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    dirs = dirs[:, None, :].expand(n_rays, n_samples, 3)
    rgb, sigma = model(pts.reshape(-1, 3), dirs.reshape(-1, 3), cfg, sigma_noise=sigma_noise)
    comp, depth, acc, weights = volume_render(rgb.reshape(n_rays, n_samples, 3),
                                              sigma.reshape(n_rays, n_samples), z_vals, rays_d,
                                              white_bkgd=white_bkgd)
    return comp, depth, acc, weights, z_vals


def to_rays_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A draw of the generator's device on the rays' device, without a
    blocking copy: a CPU draw bound for the card goes through pinned
    memory and an asynchronous copy; on one device it is returned as is."""
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_grid_loss(cfg: GridNeRFConfig):
    """-> loss(model, ro, rd, target, generator, s, noise_scale=1.0) ->
    (mse, metrics), the contract of training.loss_fn, so every block
    (levers, data parallel) takes it. The generator draws the sigma-noise
    (only when s.sigma_noise_std > 0), then the stratified jitter; the
    noise is scaled where the rays are (to_rays_device)."""
    from tinynerf_tpu_torch.utils.metrics import mse2psnr

    def loss(model, ro, rd, target, generator, s, noise_scale=1.0):
        noise = None
        if s.sigma_noise_std > 0.0:
            z = torch.randn((ro.shape[0] * s.n_samples,), generator=generator,
                            dtype=torch.float32, device=generator.device)
            noise = (noise_scale * s.sigma_noise_std) * to_rays_device(z, ro.device)
        comp, _, _, _, _ = render_rays_grid(model, ro, rd, generator, cfg=cfg,
                                            n_samples=s.n_samples, near=s.near, far=s.far,
                                            white_bkgd=s.white_bkgd, sigma_noise=noise)
        value = torch.mean((comp - target.float()) ** 2)
        return value, {"loss": value.detach(), "psnr": mse2psnr(value.detach())}

    return loss


# The checkpoint meta's keys of the fields that set Instant-NGP's form,
# written only where they differ from the defaults (the JAX package's).
FORM_FIELDS = ("dir_encoding", "density_activation", "rgb_reads_density")


def grid_form_meta(cfg: GridNeRFConfig) -> Dict[str, Any]:
    """{field: value} of the form fields that differ from the defaults."""
    base = GridNeRFConfig()
    return {f: getattr(cfg, f) for f in FORM_FIELDS if getattr(cfg, f) != getattr(base, f)}


def grid_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX params tree of numpy arrays ({'tables', 'mlp'}, w as (in,
    out)) -> a state_dict for GridNeRF.load_state_dict."""
    out = {f"tables.{k}": torch.from_numpy(np.array(v, dtype=np.float32))
           for k, v in tree["tables"].items()}
    for name, lin in tree["mlp"].items():
        out[f"mlp.{name}.weight"] = torch.from_numpy(np.array(np.asarray(lin["w"], np.float32).T,
                                                              order="C"))
        out[f"mlp.{name}.bias"] = torch.from_numpy(np.array(lin["b"], dtype=np.float32))
    return out


def grid_params_to_jax(model: GridNeRF) -> Dict[str, Any]:
    """Inverse of grid_params_from_jax: a JAX-layout tree of numpy arrays."""
    return grid_state_to_jax(model.state_dict())


def grid_state_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Any per-parameter tensors of a GridNeRF (its state_dict, its Adam
    moments, its EMA) keyed by parameter name -> the JAX-layout tree."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state.items()}
    tables = {k[len("tables."):]: v.copy() for k, v in sd.items() if k.startswith("tables.")}
    names = sorted({k.split(".")[1] for k in sd if k.startswith("mlp.")})
    mlp = {n: {"b": sd[f"mlp.{n}.bias"].copy(), "w": sd[f"mlp.{n}.weight"].T.copy()}
           for n in names}
    return {"mlp": mlp, "tables": tables}
