"""MultiRegion: a grid partitioned into regions over devices.

Counterpart of ``clima_oceananigans_jl_tpu/parallel/multi_region.py``
(Oceananigans' ``MultiRegionGrid(grid; partition = XPartition(n),
devices)`` and ``@apply_regionally``). A ``MultiRegionGrid`` builds the
mesh of its partition and ``wrap`` gives the region-parallel model, a
``DistributedModel``: each region is a shard stepped in its own thread,
so regions on one card (``devices=[cuda:0] * n``) run as Oceananigans'
regions on one GPU do, and regions on several cards each on its own.
"""
from __future__ import annotations

import dataclasses

from .distributed import DistributedModel, make_mesh


@dataclasses.dataclass(frozen=True)
class XPartition:
    n: int


@dataclasses.dataclass(frozen=True)
class YPartition:
    n: int


class MultiRegionGrid:
    """grid + partition → a mesh; ``wrap(model)`` gives the region-parallel
    model. ``partition``: ``XPartition(n)``, ``YPartition(n)`` or an
    (Rx, Ry) pair; ``devices`` as ``make_mesh`` takes them (by default the
    visible CUDA devices, one region each)."""

    def __init__(self, grid, partition=None, devices=None):
        self.global_grid = grid
        if partition is None:
            partition = XPartition(len(devices) if isinstance(devices, (list, tuple))
                                   else _visible_devices())
        if isinstance(partition, XPartition):
            shape = (partition.n, 1)
        elif isinstance(partition, YPartition):
            shape = (1, partition.n)
        else:
            shape = tuple(partition)
        self.mesh = make_mesh(shape, devices)
        self.partition = partition

    def wrap(self, model):
        """Distribute a model built on the global grid over the regions."""
        return DistributedModel(model, self.mesh)


def _visible_devices():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def apply_regionally(fn, *args, **kwargs):
    """Oceananigans' ``@apply_regionally``: ``fn`` on each region's
    arguments where an argument is a list of one value per region (the
    regions' threads of ``DistributedModel.step`` already run each region
    apart), else ``fn`` once on the arguments as they are."""
    lists = [a for a in list(args) + list(kwargs.values()) if isinstance(a, list)]
    if not lists:
        return fn(*args, **kwargs)
    n = len(lists[0])
    pick = lambda a, r: a[r] if isinstance(a, list) else a
    return [fn(*(pick(a, r) for a in args),
               **{k: pick(v, r) for k, v in kwargs.items()}) for r in range(n)]
