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
kernel; the port runs it in eager torch on whatever device holds the
model, with no kernel of its own. The JAX package's three gather
strategies (encode_impl loop | cat | cat_pib) are numerically identical;
the port has one, a gather per level (the "loop" strategy), so a chunk's
live set holds one level's ids and features at a time. encode_impl is
accepted and ignored, so the JAX package's configurations parse.

The gather is advanced indexing, table[ids]: its backward is
index_put_(accumulate=True), which sums the corners' gradients into the
tables in a fixed order on both devices (CUDA sorts the ids first), so
two runs from one seed are bit-identical on the card too. F.embedding's
CUDA backward is not: on an H100, tests/test_torch_port_cuda.py's grid
case saw two backward passes differ.

Parameter names: GridNeRF holds `tables` (an nn.ParameterDict of l0 ...
l{n-1}, each (T_l, features)) and `mlp` (geo0, geo1, rgb0, rgb1, rgb2,
nn.Linear, weight (out, in)). The JAX tree is {'tables': {'l0': ...},
'mlp': {'geo0': {'w', 'b'}, ...}} with w as (in, out);
grid_params_from_jax / grid_params_to_jax convert.

The MLP's layers cast the input, the weight and the bias to
compute_dtype and add the bias in that dtype (the JAX _dense_layer):
in bf16 the product and the sum are each rounded to bf16.
Interpolation and compositing run in float32.
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

from tinynerf_tpu_torch.ops.encoding import encoding_dim, positional_encoding
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render

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
        dir_dim = encoding_dim(cfg.num_freqs_dir)
        h = cfg.hidden
        self.mlp = nn.ModuleDict({
            "geo0": nn.Linear(feat_dim, h, device="meta"),
            "geo1": nn.Linear(h, 1 + cfg.geo_features, device="meta"),
            "rgb0": nn.Linear(cfg.geo_features + dir_dim, h, device="meta"),
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

    def forward(
        self,
        pts: torch.Tensor,
        dirs: torch.Tensor,
        cfg: Optional[GridNeRFConfig] = None,
        sigma_noise: Optional[torch.Tensor] = None,
    ):
        """apply_grid_nerf (tinynerf_tpu/models/grid_nerf.py:230-261): `cfg`
        overrides the module's own (its box and compute dtype); sigma =
        relu(raw + sigma_noise), the noise reshaped to (N,)."""
        cfg = cfg or self.cfg
        dt = cfg.compute_dtype
        feat = grid_encode(self.tables, pts, cfg)
        mlp = self.mlp
        h = torch.relu(_dense(feat, mlp["geo0"], dt))
        geo = _dense(h, mlp["geo1"], dt).float()
        sigma_raw = geo[:, 0]
        if sigma_noise is not None:
            sigma_raw = sigma_raw + sigma_noise.reshape(sigma_raw.shape)
        sigma = torch.relu(sigma_raw)
        denc = positional_encoding(dirs.float(), num_freqs=cfg.num_freqs_dir)
        c = torch.cat([geo[:, 1:], denc], dim=-1)
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


def level_ids(u: torch.Tensor, res: int, dense: bool, table_size: int):
    """Per-level corner ids and trilinear weights of normalized points u in
    [0, 1]^3 -> (lin (N, 8) int64, w (N, 8) float32).

    The cell and its fraction are taken in float32 in the JAX order (a
    point moved across a cell face reads other corners). The hash is the
    JAX package's uint32 arithmetic done exactly in int64: with m =
    table_size - 1 < 2^32, (x mod 2^32) & m == x & m and & distributes
    over ^, so each product is masked before the xor; id * prime < 2^63
    for any resolution below 2^31."""
    corners = _corner_offsets(u.device)  # (8, 3)
    xs = u * res  # corner coordinates in [0, res]
    i0 = torch.clamp(torch.floor(xs).to(torch.int64), max=res - 1)  # u == 1 in the last cell
    f = xs - i0.to(torch.float32)  # (N, 3) in [0, 1]
    ids = i0[:, None, :] + corners[None, :, :]  # (N, 8, 3)
    if dense:
        side = res + 1
        lin = (ids[..., 0] * side + ids[..., 1]) * side + ids[..., 2]
    else:
        m = table_size - 1
        lin = ((ids[..., 0] * _HASH_PRIMES[0]) & m) ^ ((ids[..., 1] * _HASH_PRIMES[1]) & m) \
            ^ ((ids[..., 2] * _HASH_PRIMES[2]) & m)
    # Per-axis factor f where the corner's bit is set, else 1 - f; their
    # product in axis order.
    fac = torch.where(corners[None].bool(), f[:, None, :], 1.0 - f[:, None, :])  # (N, 8, 3)
    w = fac[..., 0] * fac[..., 1] * fac[..., 2]
    return lin, w


def grid_encode(tables, pts: torch.Tensor, cfg: GridNeRFConfig) -> torch.Tensor:
    """(N, 3) world points -> (N, n_levels * features) float32 features.
    `tables` maps l0 ... to (T_l, features). Points are normalized by the
    box and clamped to it (out-of-box points read border cells)."""
    lo, hi = _box(tuple(float(v) for v in cfg.aabb), pts.device)
    u = torch.clamp((pts.float() - lo) / (hi - lo), 0.0, 1.0)
    outs = []
    for l, (res, dense) in enumerate(zip(cfg.level_resolutions(), cfg.level_is_dense())):
        lin, w = level_ids(u, res, dense, cfg.table_size)
        feats = tables[f"l{l}"][lin]  # (N, 8, features)
        outs.append(torch.sum(w[..., None] * feats, dim=1))
    return torch.cat(outs, dim=-1)


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


def make_grid_loss(cfg: GridNeRFConfig):
    """-> loss(model, ro, rd, target, generator, s, noise_scale=1.0) ->
    (mse, metrics), the contract of training.loss_fn, so every block
    (levers, data parallel) takes it. The generator draws the sigma-noise
    (only when s.sigma_noise_std > 0), then the stratified jitter."""
    from tinynerf_tpu_torch.utils.metrics import mse2psnr

    def loss(model, ro, rd, target, generator, s, noise_scale=1.0):
        noise = None
        if s.sigma_noise_std > 0.0:
            noise = (noise_scale * s.sigma_noise_std * torch.randn(
                (ro.shape[0] * s.n_samples,), generator=generator, dtype=torch.float32,
                device=generator.device)).to(ro.device)
        comp, _, _, _, _ = render_rays_grid(model, ro, rd, generator, cfg=cfg,
                                            n_samples=s.n_samples, near=s.near, far=s.far,
                                            white_bkgd=s.white_bkgd, sigma_noise=noise)
        value = torch.mean((comp - target.float()) ** 2)
        return value, {"loss": value.detach(), "psnr": mse2psnr(value.detach())}

    return loss


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
