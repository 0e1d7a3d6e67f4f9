"""Process meshes and the collectives of the parallel paths.

Port of tinynerf_tpu/parallel/mesh.py:26-152. The JAX package lays the
devices of one program out as a ('data',) or ('data', 'sample') mesh;
here every rank of a torch.distributed process group is one device of
the mesh, with the ranks laid out row-major as (n_data, n_sample), as
np.reshape lays out the devices (:49): rank = data_idx * n_sample +
sample_idx. make_mesh creates each axis's process subgroups
(dist.new_group, which every rank calls in the same order); an axis of
one rank gets no group, and its collectives are skipped.

The collective backend (pick_backend, initialize_distributed): gloo on
the CPU; nccl when every local rank has its own card; gloo when local
ranks share a card, since NCCL refuses two ranks on one GPU (the compute
stays on the card). The collectives use one primitive, a summing
all_reduce. all_gather is the all_reduce of a zero-filled (n, ...)
buffer that holds this rank's slot, which is exact (x + 0 = x). Under
gloo a CUDA tensor is staged through host memory explicitly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on an (n_data, n_sample) mesh, and the process
    group of each axis with more than one rank (None without a process
    group: a layout only, which runs no collective)."""

    n_data: int
    n_sample: int
    rank: int = 0
    axis_names: Tuple[str, ...] = (DATA_AXIS,)
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, SAMPLE_AXIS: self.n_sample}

    @property
    def data_idx(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_idx(self) -> int:
        return self.rank % self.n_sample

    def axis_index(self, axis: str) -> int:
        return self.data_idx if axis == DATA_AXIS else self.sample_idx

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: Optional[int] = None, sample_parallel: int = 1,
              rank: Optional[int] = None) -> Mesh:
    """A ('data',) mesh, or with sample_parallel > 1 a ('data', 'sample')
    mesh, over the ranks of the process group.

    n_devices defaults to the world size (1 without a process group) and
    must equal it when a group exists. sample_parallel must divide it.
    Without a process group the mesh is a layout only: `rank` (default
    0) places this process on it."""
    world = dist.get_world_size() if _distributed() else 1
    n = n_devices or world
    if _distributed():
        if n != world:
            raise ValueError(f"n_devices={n}: the mesh spans every rank of the group ({world})")
        if rank is not None and rank != dist.get_rank():
            raise ValueError(f"rank={rank}, but this process is rank {dist.get_rank()}")
        rank = dist.get_rank()
    rank = rank or 0
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not on a mesh of {n}")
    n_sample = max(sample_parallel, 1)
    if n % n_sample:
        raise ValueError(f"sample_parallel={sample_parallel} must divide n_devices={n}")
    n_data = n // n_sample
    axes = (DATA_AXIS,) if sample_parallel <= 1 else (DATA_AXIS, SAMPLE_AXIS)
    groups = {}
    if _distributed() and n > 1:
        # Every rank creates every group, in the same order.
        lines = {
            SAMPLE_AXIS: [[d * n_sample + s for s in range(n_sample)] for d in range(n_data)],
            DATA_AXIS: [[d * n_sample + s for d in range(n_data)] for s in range(n_sample)],
        }
        for axis in (DATA_AXIS, SAMPLE_AXIS):
            for ranks in lines[axis]:
                if len(ranks) > 1:
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = group
    return Mesh(n_data, n_sample, rank, axes, groups)


def mesh_axes(mesh: Mesh) -> Tuple[int, int]:
    """(n_data, n_sample) sizes of the mesh axes."""
    return mesh.n_data, mesh.n_sample


def pick_backend(device_type: str) -> Tuple[str, str]:
    """(backend, why) by the fixed rule of the module docstring; the local
    rank count comes from the launcher's LOCAL_WORLD_SIZE."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if cards >= local:
        return "nccl", f"{local} local rank(s), {cards} card(s): one card each"
    return "gloo", f"{local} local ranks share {cards} card(s), which NCCL refuses"


def rank_device(device: str) -> torch.device:
    """This rank's device: its own card (LOCAL_RANK modulo the cards, so
    ranks may share one) for "cuda", else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None,
                           device_type: str = "cuda") -> bool:
    """Join the process group. Returns True iff it (already) spans more
    than one process.

    1. Already initialized (a repeat call): report the world.
    2. Explicit arguments (init_method or rank): init_process_group with
       them; errors propagate.
    3. Otherwise the launcher's environment (torch.distributed.run sets
       RANK and WORLD_SIZE): without it this is a single-process run ->
       False; with it, init_process_group(env://), and any failure is
       raised.
    backend defaults to pick_backend(device_type)."""
    if _distributed():
        return dist.get_world_size() > 1
    explicit = init_method is not None or rank is not None
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    dist.init_process_group(
        backend or pick_backend(device_type)[0], init_method=init_method,
        world_size=-1 if world_size is None else world_size, rank=-1 if rank is None else rank,
    )
    return dist.get_world_size() > 1


def _group(mesh: Mesh, axis: str):
    group = mesh.groups.get(axis)
    if group is None:
        raise RuntimeError(f"the mesh's {axis} axis has {mesh.axis_size(axis)} ranks and no "
                           "process group (a layout-only mesh runs no collective)")
    return group


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x summed over the ranks of `axis` (a new tensor, no gradient); x
    itself when the axis has one rank."""
    if mesh.axis_size(axis) == 1:
        return x
    group = _group(mesh, axis)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.detach().cpu().contiguous()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every rank's x along `axis`, in axis order (no
    gradient)."""
    buf = x.detach().new_zeros((mesh.axis_size(axis), *x.shape))
    buf[mesh.axis_index(axis)] = x.detach()
    return all_reduce_sum(buf, mesh, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axis)[ctx.mesh.axis_index(ctx.axis)], None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """gather() with a gradient: the backward sums the cotangent over the
    axis and takes this rank's slot, the transpose (psum_scatter) that
    JAX differentiates jax.lax.all_gather into."""
    return _AllGather.apply(x, mesh, axis)
