"""The device mesh of the port, and the collectives its sharded bodies
use: the counterpart of ``protocol_tpu/parallel/mesh.py``.

A ``Mesh`` is an ordered 1-D list of torch devices, one shard each,
driven by this one process (as JAX's ``Mesh`` is one process driving
every local device). A sharded value is a Python list of per-shard
tensors, shard ``d`` on ``mesh.devices[d]``; a per-shard body is a
function applied shard by shard, and each collective below is a plain
function over such lists:

- ``all_gather``: every shard gets the blocks concatenated in shard
  order (``lax.all_gather(..., tiled=True)``);
- ``psum``: every shard gets the sum of the shards' values, added in
  shard order, so every shard holds the same bits;
- ``all_to_all``: shard ``d`` gets block ``d`` of every shard's split,
  concatenated in shard order (``lax.all_to_all(..., tiled=True)``);
- ``psum_scatter``: shard ``d`` gets the sum over shards of their block
  ``d`` (``lax.psum_scatter(..., tiled=True)``); integer planes add
  exactly;
- ``ppermute``: shard ``dst`` gets shard ``src``'s value for each
  ``(src, dst)`` pair.

Copies between distinct devices are ``Tensor.to(device)``; on a mesh
that repeats one device they are no copies at all, and every shard
still runs its own kernels on its own blocks. Such a mesh is the port's
counterpart of the reference's virtual 8-device CPU mesh: it runs every
exchange and every per-shard kernel on one card.

The reference's multi-host path (``jax.distributed``) and its
``shard_map_norep`` version shim have no counterpart here.
"""

from __future__ import annotations

import torch

# single mesh axis name used across the framework
rows_axis = "rows"


class Mesh:
    """An ordered list of torch devices with one axis name: shard ``d``
    lives on ``devices[d]``. A device may repeat."""

    def __init__(self, devices, axis_names=(rows_axis,)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices``. By default
    ``devices`` is every CUDA device, and with none it raises: the CPU,
    or a device repeated, is used only when the caller passes it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=[torch.device("
                "'cpu')] * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


# --- placement ---------------------------------------------------------------

def shard(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> list:
    """Split ``x`` into ``mesh.size`` equal blocks along ``dim``, block
    ``d`` on shard ``d``'s device."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"length {x.shape[dim]} does not split over "
                         f"{mesh.size} shards")
    return [b.to(dev) for b, dev in zip(x.chunk(mesh.size, dim),
                                       mesh.devices)]


def unshard(blocks: list, dim: int = 0) -> torch.Tensor:
    """The blocks concatenated in shard order on shard 0's device."""
    return torch.cat([b.to(blocks[0].device) for b in blocks], dim)


# --- collectives -------------------------------------------------------------

def all_gather(blocks: list, mesh: Mesh, dim: int = 0) -> list:
    """Every shard's copy of the blocks concatenated in shard order."""
    return [torch.cat([b.to(dev) for b in blocks], dim)
            for dev in mesh.devices]


def _ordered_sum(values, device):
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def psum(values: list, mesh: Mesh) -> list:
    """The sum of the shards' values, added in shard order on shard 0's
    device, given to every shard."""
    total = _ordered_sum(values, mesh.devices[0])
    return [total.to(dev) for dev in mesh.devices]


def all_to_all(blocks: list, mesh: Mesh, split_dim: int,
               concat_dim: int) -> list:
    """Shard ``d`` gets piece ``d`` of every shard's block split ``D``
    ways along ``split_dim``, concatenated in shard order along
    ``concat_dim``."""
    pieces = [b.chunk(mesh.size, split_dim) for b in blocks]
    return [torch.cat([p[d].to(dev) for p in pieces], concat_dim)
            for d, dev in enumerate(mesh.devices)]


def psum_scatter(blocks: list, mesh: Mesh, scatter_dim: int) -> list:
    """Shard ``d`` gets the sum over shards, in shard order, of piece
    ``d`` of their blocks split ``D`` ways along ``scatter_dim``."""
    pieces = [b.chunk(mesh.size, scatter_dim) for b in blocks]
    return [_ordered_sum([p[d] for p in pieces], dev).contiguous()
            for d, dev in enumerate(mesh.devices)]


def ppermute(blocks: list, mesh: Mesh, perm) -> list:
    """Shard ``dst`` gets shard ``src``'s block for each ``(src, dst)``
    in ``perm``; a shard no pair names gets zeros."""
    out = [None] * mesh.size
    for src, dst in perm:
        out[dst] = blocks[src].to(mesh.devices[dst])
    return [torch.zeros_like(b) if o is None else o
            for b, o in zip(blocks, out)]
