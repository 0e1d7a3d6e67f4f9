"""Full NeRF: view-direction conditioning and split coarse/fine MLPs
with hierarchical resampling.

Port of tinynerf_tpu/models/nerf.py:40-250. Per MLP: a `depth` x
`hidden` ReLU trunk; after the ReLU of layer (skip_at - 1) the encoded
position is concatenated; sigma = ReLU(Linear(hidden, 1)) of the trunk
(view-independent); rgb = Sigmoid(Linear(rgb_hidden, 3)) of
ReLU(Linear(hidden + dir_dim, rgb_hidden)) of [trunk, dir_enc]. At the
flagship width (hidden 256, depth 8, skip 4, L=10, L_dir=4, rgb_hidden
64) one MLP has 511,684 parameters.

Parameter names: NeRFMLP holds layers.{i}, sigma, rgb_in and rgb
(nn.Linear, weight (out, in)); NeRF holds coarse and fine, or with
parts=("fine",) the single MLP of the occupancy proposal
(ops/occupancy.py). The JAX package stores w as (in, out) in a
{'coarse', 'fine'} (or {'fine'}) tree; nerf_params_from_jax /
nerf_params_to_jax convert.

Matmul inputs are rounded to compute_dtype and products accumulate in
float32 (models/tinynerf.dense).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from tinynerf_tpu_torch.models.tinynerf import dense
from tinynerf_tpu_torch.ops.encoding import encoding_dim, positional_encoding
from tinynerf_tpu_torch.ops.sampling import sample_pdf, stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    num_freqs: int = 10  # position encoding bands
    num_freqs_dir: int = 4  # view-direction encoding bands
    hidden: int = 128
    depth: int = 8
    skip_at: int = 4
    rgb_hidden: int = 64
    use_viewdirs: bool = True
    compute_dtype: torch.dtype = torch.bfloat16  # matmul input dtype; params stay f32

    @property
    def in_dim(self) -> int:
        return encoding_dim(self.num_freqs)

    @property
    def dir_dim(self) -> int:
        return encoding_dim(self.num_freqs_dir) if self.use_viewdirs else 0


def nerf_layer_in_dims(cfg: NeRFConfig) -> list:
    """Input width of each trunk layer (the layer after the skip sees
    hidden + in_dim inputs)."""
    dims, last = [], cfg.in_dim
    for i in range(cfg.depth):
        dims.append(last)
        last = cfg.hidden + cfg.in_dim if i == cfg.skip_at - 1 else cfg.hidden
    return dims


class NeRFMLP(nn.Module):
    """Encoded positions (N, in_dim) and directions (N, dir_dim) ->
    (rgb (N, 3), sigma (N, 1))."""

    def __init__(
        self,
        cfg: NeRFConfig = NeRFConfig(),
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.layers = nn.ModuleList(
            nn.Linear(n_in, h, device="meta") for n_in in nerf_layer_in_dims(cfg)
        )
        self.sigma = nn.Linear(h, 1, device="meta")
        self.rgb_in = nn.Linear(h + cfg.dir_dim, cfg.rgb_hidden, device="meta")
        self.rgb = nn.Linear(cfg.rgb_hidden, 3, device="meta")
        self.to_empty(device="cpu")
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and
        bias, drawn on the CPU from `generator`."""
        for lin in [*self.layers, self.sigma, self.rgb_in, self.rgb]:
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_((u * 2.0 - 1.0) * bound)

    def forward(
        self,
        x_enc: torch.Tensor,
        d_enc: Optional[torch.Tensor],
        cfg: Optional[NeRFConfig] = None,
        sigma_noise: Optional[torch.Tensor] = None,
    ):
        """sigma_noise (N, 1) is added to the raw density before its ReLU
        (tinynerf_tpu/models/nerf.py:90-120)."""
        cfg = cfg or self.cfg
        dt = cfg.compute_dtype
        h = x_enc
        for i, layer in enumerate(self.layers):
            h = torch.relu(dense(h, layer, dt))
            if i == cfg.skip_at - 1:
                h = torch.cat([h, x_enc.to(h.dtype)], dim=-1)
        sigma_raw = dense(h, self.sigma, dt)
        if sigma_noise is not None:
            sigma_raw = sigma_raw + sigma_noise.to(sigma_raw.dtype)
        sigma = torch.relu(sigma_raw)
        if cfg.use_viewdirs:
            if d_enc is None:
                raise ValueError("use_viewdirs=True requires direction encodings")
            h = torch.cat([h, d_enc.to(h.dtype)], dim=-1)
        h = torch.relu(dense(h, self.rgb_in, dt))
        rgb = torch.sigmoid(dense(h, self.rgb, dt))
        return rgb, sigma


class NeRF(nn.Module):
    """The coarse and fine MLPs, initialised in that order from one
    generator; parts=("fine",) holds the fine MLP alone (the occupancy
    proposal's model, the JAX package's {'fine': mlp})."""

    def __init__(
        self,
        cfg: NeRFConfig = NeRFConfig(),
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
        parts: tuple = ("coarse", "fine"),
    ):
        super().__init__()
        if parts not in (("coarse", "fine"), ("fine",)):
            raise ValueError(f"parts must be ('coarse', 'fine') or ('fine',), got {parts}")
        self.cfg = cfg
        self.parts = parts
        for part in parts:
            setattr(self, part, NeRFMLP(cfg, generator=generator, device=device))


def view_encoding(rays_d: torch.Tensor, cfg: NeRFConfig) -> Optional[torch.Tensor]:
    """Per-ray direction encoding of d/||d|| (R, dir_dim), or None
    without view directions."""
    if not cfg.use_viewdirs:
        return None
    vdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return positional_encoding(vdirs, num_freqs=cfg.num_freqs_dir)


def run_mlp(mlp: NeRFMLP, pts: torch.Tensor, d_enc_ray: Optional[torch.Tensor], cfg: NeRFConfig,
            sigma_noise: Optional[torch.Tensor] = None):
    """(R, S, 3) points -> rgb (R, S, 3), sigma (R, S); sigma_noise
    (R * S, 1) is added to the raw density before its ReLU."""
    n_rays, n_samples = pts.shape[:2]
    x_enc = positional_encoding(pts.reshape(-1, 3), num_freqs=cfg.num_freqs)
    d_enc = None
    if d_enc_ray is not None:
        d_enc = d_enc_ray.repeat_interleave(n_samples, dim=0)
    rgb, sigma = mlp(x_enc, d_enc, cfg, sigma_noise=sigma_noise)
    return rgb.reshape(n_rays, n_samples, 3), sigma.reshape(n_rays, n_samples)


def render_rays_hierarchical(
    params: NeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_coarse: int = 64,
    n_fine: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    randomized: bool = False,
    generator: Optional[torch.Generator] = None,
    sigma_noise_std: float = 0.0,
    sigma_noise_scale=1.0,
    return_aux: bool = False,
):
    """Coarse pass -> inverse-CDF resample -> fine pass on the sorted
    union of depths -> (comp_coarse (R, 3), comp_fine (R, 3)).

    randomized=True (training) draws from `generator`, in the JAX
    package's order (tinynerf_tpu/models/nerf.py:155-163): the coarse and
    the fine sigma-noise (N(0, std) * sigma_noise_scale, pre-ReLU, only
    when sigma_noise_std > 0), then the stratified jitter, then
    sample_pdf's u. The resampling weights carry no gradient.
    return_aux=True returns (comp_coarse, comp_fine, depth_fine (R, 1),
    acc_fine (R, 1)): the fine pass's composited depth sum(w z) and
    opacity (tinynerf_tpu/models/nerf.py:211)."""
    if randomized and generator is None:
        raise ValueError("render_rays_hierarchical(randomized=True) requires a generator")
    cfg = cfg or params.cfg
    n_rays = rays_o.shape[0]
    noise_c = noise_f = None
    if randomized and sigma_noise_std > 0.0:
        def draw(n_samples):
            return (sigma_noise_scale * sigma_noise_std * torch.randn(
                (n_rays * n_samples, 1), generator=generator, dtype=torch.float32,
                device=generator.device)).to(rays_o.device)

        noise_c, noise_f = draw(n_coarse), draw(n_coarse + n_fine)
    d_enc_ray = view_encoding(rays_d, cfg)

    z_c, pts_c = stratified_samples(near, far, n_coarse, rays_o, rays_d, randomized=randomized,
                                    generator=generator)
    rgb_c, sigma_c = run_mlp(params.coarse, pts_c, d_enc_ray, cfg, sigma_noise=noise_c)
    comp_c, _, _, weights = volume_render(rgb_c, sigma_c, z_c, rays_d, white_bkgd=white_bkgd)

    z_mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = sample_pdf(z_mids, weights[:, 1:-1].detach(), n_fine, randomized=randomized,
                     generator=generator)
    z_union = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_union[..., None]

    rgb_f, sigma_f = run_mlp(params.fine, pts_f, d_enc_ray, cfg, sigma_noise=noise_f)
    comp_f, depth_f, acc_f, _ = volume_render(rgb_f, sigma_f, z_union, rays_d,
                                              white_bkgd=white_bkgd)
    if return_aux:
        return comp_c, comp_f, depth_f, acc_f
    return comp_c, comp_f


def make_hierarchical_loss(cfg: NeRFConfig, n_fine: int = 64):
    """The coarse + fine MSE loss (the NeRF paper's objective), pluggable
    into training.make_train_block: (model, ro, rd, target, generator, s,
    noise_scale=1.0) -> (mse_c + mse_f, metrics); the PSNR is the fine
    composite's (tinynerf_tpu/models/nerf.py:216-250)."""
    from tinynerf_tpu_torch.utils.metrics import mse2psnr

    def loss(model, ro, rd, target, generator, s, noise_scale=1.0):
        comp_c, comp_f = render_rays_hierarchical(
            model, ro, rd, n_coarse=s.n_samples, n_fine=n_fine, near=s.near, far=s.far,
            white_bkgd=s.white_bkgd, cfg=cfg, randomized=True, generator=generator,
            sigma_noise_std=s.sigma_noise_std, sigma_noise_scale=noise_scale,
        )
        target = target.float()
        mse_c = torch.mean((comp_c - target) ** 2)
        mse_f = torch.mean((comp_f - target) ** 2)
        mse_f_d = mse_f.detach()
        return mse_c + mse_f, {"loss": mse_f_d, "psnr": mse2psnr(mse_f_d),
                               "loss_coarse": mse_c.detach()}

    return loss


def _linear_from_jax(tree, prefix: str, out: dict) -> None:
    w = np.asarray(tree["w"], dtype=np.float32)
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(w.T, order="C"))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(np.asarray(tree["b"], dtype=np.float32)))


def nerf_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX {'coarse', 'fine'} (or {'fine'}) params tree of numpy arrays (w
    as (in, out)) -> a state_dict for NeRF.load_state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("coarse", "fine"):
        if part not in tree:
            continue
        mlp = tree[part]
        for i, layer in enumerate(mlp["layers"]):
            _linear_from_jax(layer, f"{part}.layers.{i}", out)
        for head in ("sigma", "rgb_in", "rgb"):
            _linear_from_jax(mlp[head], f"{part}.{head}", out)
    return out


def nerf_params_to_jax(model: NeRF) -> Dict[str, Any]:
    """Inverse of nerf_params_from_jax: a JAX-layout tree of numpy arrays."""
    return nerf_state_to_jax(model.state_dict())


def nerf_state_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Any per-parameter tensors of a NeRF (its state_dict, its Adam
    moments) keyed by parameter name -> the JAX-layout tree of numpy
    arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state.items()}

    def lin(prefix):
        return {"b": sd[f"{prefix}.bias"].copy(), "w": sd[f"{prefix}.weight"].T.copy()}

    def mlp(part):
        depth = sum(1 for k in sd if k.startswith(f"{part}.layers.") and k.endswith(".weight"))
        return {
            "layers": [lin(f"{part}.layers.{i}") for i in range(depth)],
            "rgb": lin(f"{part}.rgb"),
            "rgb_in": lin(f"{part}.rgb_in"),
            "sigma": lin(f"{part}.sigma"),
        }

    return {part: mlp(part) for part in ("coarse", "fine")
            if any(k.startswith(f"{part}.") for k in sd)}
