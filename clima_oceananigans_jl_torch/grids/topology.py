"""Axis topologies.

Counterpart of ``clima_oceananigans_jl_tpu/grids/topology.py``, after
Oceananigans' ``Periodic``/``Bounded``/``Flat`` topology types.
``FULLY_CONNECTED`` marks an axis continued on another shard: a cut axis
of ``parallel/decomposition.py``'s local grids (with ``grid.dist``), or a
cubed-sphere face's edges.
"""
from __future__ import annotations

import enum


class Topology(str, enum.Enum):
    PERIODIC = "periodic"
    BOUNDED = "bounded"
    FLAT = "flat"
    FULLY_CONNECTED = "fully_connected"  # continued on a neighboring shard

    def __repr__(self) -> str:
        return self.value


PERIODIC = Topology.PERIODIC
BOUNDED = Topology.BOUNDED
FLAT = Topology.FLAT
FULLY_CONNECTED = Topology.FULLY_CONNECTED
