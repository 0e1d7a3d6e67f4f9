"""Sharded full-image rendering: the rays split across the mesh's data
axis.

Port of tinynerf_tpu/parallel/render.py:24-84. Each rank renders its
padded slice of H*W / n_data rays in chunks through render.render_rays
(K1 with use_fused), and one gather over the data axis assembles the
image: rays are independent, so there is no traffic until the gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.ops.rays import get_rays
from tinynerf_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, gather, make_mesh, mesh_axes
from tinynerf_tpu_torch.render import render_rays


def make_sharded_image_renderer(
    mesh: Optional[Mesh] = None,
    *,
    H: int,
    W: int,
    focal: float,
    chunk: int = 8192,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    use_fused: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer whose rays are sharded over
    the data axis; every rank returns the whole image."""
    mesh = mesh or make_mesh()
    n_data, _ = mesh_axes(mesh)
    hw = H * W
    hw_local = -(-hw // n_data)  # rays per rank, before padding
    chunk_eff = min(chunk, hw_local)
    n_chunks = -(-hw_local // chunk_eff)
    hw_local_pad = n_chunks * chunk_eff

    @torch.no_grad()
    def render(params, pose):
        device = next(params.parameters()).device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(device)
        rays_o, rays_d = get_rays(H, W, focal, pose)
        pad = n_data * hw_local_pad - hw
        unit_z = torch.tensor([[0.0, 0.0, 1.0]], device=device)  # finite norms for padding
        rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
        rays_d = torch.cat([rays_d, unit_z.expand(pad, 3)])
        lo = mesh.data_idx * hw_local_pad
        ro, rd = rays_o[lo:lo + hw_local_pad], rays_d[lo:lo + hw_local_pad]
        out = torch.cat([
            render_rays(params, ro[c * chunk_eff:(c + 1) * chunk_eff],
                        rd[c * chunk_eff:(c + 1) * chunk_eff], n_samples=n_samples, near=near,
                        far=far, num_freqs=num_freqs, white_bkgd=white_bkgd, model_cfg=model_cfg,
                        use_fused=use_fused)
            for c in range(n_chunks)
        ])
        img = gather(out, mesh, DATA_AXIS).reshape(-1, 3)[:hw]
        return torch.clamp(img.reshape(H, W, 3), 0.0, 1.0)

    return render
