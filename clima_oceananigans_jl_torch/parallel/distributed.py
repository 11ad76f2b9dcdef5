"""Distributed models: the step of a model run shard by shard over a mesh.

Counterpart of ``clima_oceananigans_jl_tpu/parallel/distributed.py``
(Oceananigans' distributed architectures): the user builds a model on
the global grid, wraps it in ``DistributedModel(model, mesh)``, and gets
the same ``initial_state``/``step`` surface, with a state that is one
state per shard (rank order) on the shards' devices. Each shard steps a
copy of the model on its local grid (``parallel/decomposition.py``) in a
thread of its own (``Mesh.run``); the halo fills exchange along the cut
axes, the pressure solve runs the pencil transposes
(``parallel/distributed_fft.py``) and CG sums its inner products over
the shards. On the card each shard's step runs the kernels on its local
grid; a mesh of several shards on one card is Oceananigans' MultiRegion
on one GPU.

As in the JAX package, the single-device options that assume one shard
are cleared: the fused AB2 branch (K1) and the roll-based projection of
the nonhydrostatic model, and the hydrostatic model's fused advance.
The hydrostatic model's shards run K4a, K4b, K6, T1 and K5's cut form,
which stops at each substep's fills so that the cut axes exchange
between substeps (``ops/fused_barotropic.py::cut_sequence``). Particles
are refused: their positions are not partitioned.
"""
from __future__ import annotations

import copy

import torch

from .decomposition import gather_array, partition_grid, scatter_array
from .mesh import Mesh


def make_mesh(mesh_shape, devices=None, timeout=600.0):
    """An (Rx, Ry) ``Mesh``. ``devices``: a list (the first Rx·Ry are
    taken; one device may repeat, as Oceananigans' MultiRegion on one GPU
    puts several regions on it), ``"cpu"`` (every shard on the CPU), or
    None (the visible CUDA devices, one shard each: a mesh larger than
    that raises)."""
    n = int(mesh_shape[0]) * int(mesh_shape[1])
    if isinstance(devices, (str, torch.device)):
        if torch.device(devices).type != "cpu":
            raise ValueError("a device name gives the CPU (\"cpu\"); pass "
                             "a list of CUDA devices")
        devices = [torch.device("cpu")] * n
    elif devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise ValueError(f"a {tuple(mesh_shape)} mesh needs {n} devices, "
                             f"{count} CUDA devices are visible; pass devices= "
                             "(a list, which may repeat a card) or \"cpu\"")
        devices = [torch.device("cuda", k) for k in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if len(devices) < n:
            raise ValueError(f"a {tuple(mesh_shape)} mesh needs {n} devices, "
                             f"got {len(devices)}")
    return Mesh(mesh_shape, devices[:n], timeout=timeout)


def patch_edge_strips(model, G, state, keys, kernels=None):
    """The halo-overlap step's edge strips (the JAX models'
    ``tendencies_overlapped``): on each cut axis, the tendencies of the
    first and last H interior cells recomputed on
    ``grid.subgrid_along`` from ``state`` (its ``keys`` entries sliced
    with their halos: the exchanged fields) and written into G in place."""
    grid = model.grid
    for axis in (0, 1):
        if grid.dist[axis] is None:
            continue
        H, N = grid.halo[axis], grid.shape[axis]
        for start in (0, N - H):
            sub = copy.copy(model)
            sub.grid = grid.subgrid_along(axis, start, H)
            if model.immersed_boundary is not None:
                sub.immersed_boundary = sub.grid.immersed
            sl = [slice(None)] * 3
            sl[axis] = slice(start, start + 3 * H)
            cut = lambda x: (x[tuple(sl)].contiguous() if isinstance(x, torch.Tensor)
                             and x.ndim == 3 and x.shape[axis] > 1 else x)
            sub_state = {key: (({n: cut(x) for n, x in v.items()} if isinstance(v, dict)
                                else cut(v)) if key in keys else v)
                         for key, v in state.items() if key != "particles"}
            Gs = sub.tendencies(sub_state, kernels)
            dst = [slice(None)] * 3
            dst[axis] = slice(start + H, start + 2 * H)
            src = [slice(None)] * 3
            src[axis] = slice(H, 2 * H)
            for name in G:
                G[name][tuple(dst)] = Gs[name][tuple(src)]
    return G


def _scatter_tree(tree, scatter, n):
    """One tree per shard: ``scatter`` gives each leaf's n values; dicts,
    tuples and lists are walked."""
    if isinstance(tree, dict):
        parts = {k: _scatter_tree(v, scatter, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [_scatter_tree(v, scatter, n) for v in tree]
        return [type(tree)(p[r] for p in parts) for r in range(n)]
    return scatter(tree)


def _gather_tree(trees, gather):
    """One tree from the shards' trees: ``gather`` of each leaf's values."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _gather_tree([t[k] for t in trees], gather) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_gather_tree([t[i] for t in trees], gather)
                        for i in range(len(t0)))
    return gather(trees)


class DistributedModel:
    """A model built on a global grid, stepped shard by shard over
    ``mesh`` (``make_mesh``). ``overlap_halo=True`` takes the
    interior/edge-split step (``tendencies_overlapped`` of the
    nonhydrostatic and hydrostatic models): each shard computes its whole
    tendency from the last step's cut-axis halos, then recomputes the
    H-wide strips along its cut axes from the exchanged fields."""

    def __init__(self, model, mesh, overlap_halo=False):
        if getattr(model, "particles", None) is not None:
            raise NotImplementedError("DistributedModel does not partition "
                                      "Lagrangian particles")
        self.mesh = mesh
        self.mesh_shape = mesh.shape
        self.global_model = model
        self.grid = model.grid  # the global grid
        self.local_grids = partition_grid(model.grid, mesh.shape, mesh.devices)
        if overlap_halo:
            if not hasattr(model, "tendencies_overlapped"):
                raise ValueError("overlap_halo: model has no tendencies_overlapped")
            g = self.local_grids[0]
            for axis, n in zip((0, 1), mesh.shape):
                if n > 1 and g.shape[axis] < 2 * g.halo[axis]:
                    raise ValueError("overlap_halo: local shard thinner than 2 "
                                     "halo widths on a cut axis")
        self.overlap_halo = overlap_halo
        self.local_models = [self._local_model(model, g, r, overlap_halo)
                             for r, g in enumerate(self.local_grids)]
        self.local_grid = self.local_grids[0]
        self.local_model = self.local_models[0]

    def _local_model(self, model, grid, rank, overlap_halo):
        m = copy.copy(model)
        m.grid = grid
        if getattr(grid, "immersed", None) is not None:
            m.immersed_boundary = grid.immersed
        if hasattr(model, "pressure_solver"):
            from .distributed_fft import select_distributed_pressure_solver
            m.pressure_solver = select_distributed_pressure_solver(grid)
        if hasattr(model, "fused_step"):
            from ..ops.fused_step import fused_step_ok
            m.fused_step = fused_step_ok(m)
        if hasattr(model, "fused_advance"):
            m.fused_advance = False
        if getattr(model, "bathymetry", None) is not None:
            m.bathymetry = scatter_array(model.bathymetry, model.grid,
                                         self.mesh_shape, self.mesh.devices)[rank]
        if overlap_halo:
            m.halo_overlap = True
        if grid.device.type == "cuda" and hasattr(m, "card_unsupported_reason"):
            reason = m.card_unsupported_reason()
            if reason is not None:
                raise NotImplementedError(reason)
        return m

    # -- state ------------------------------------------------------------------
    def _with_halo_g_prev(self, state):
        """``G_prev`` with halos (the global model's halo-free layout padded
        with zero halos): the shards step on the general branch."""
        gp = state.get("G_prev")
        if not isinstance(gp, dict):
            return state
        g = self.grid
        return dict(state, G_prev={
            k: (g.pad(x) if isinstance(x, torch.Tensor) and x.ndim == 3
                and tuple(x.shape) == tuple(g.shape) else x)
            for k, x in gp.items()})

    def scatter_state(self, state):
        """A global state → one state per shard (rank order). A state of
        numpy leaves (a JAX state, or a checkpoint's) goes through
        ``interop.state_from_numpy`` for the global model first."""
        sol = state["solution"]
        if not isinstance(next(iter(sol.values())), torch.Tensor):
            from ..interop import state_from_numpy
            state = state_from_numpy(self.global_model, state)
        state = self._with_halo_g_prev(state)
        n = self.mesh.size

        def scatter(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2:
                return scatter_array(leaf, self.grid, self.mesh_shape,
                                     self.mesh.devices)
            if isinstance(leaf, torch.Tensor):
                return [leaf.to(d) for d in self.mesh.devices]
            return [leaf] * n

        return _scatter_tree(state, scatter, n)

    def gather_state(self, states):
        """One state per shard → the global state (interiors, with the
        halos at the global edges), on the first shard's device."""
        def gather(leaves):
            if isinstance(leaves[0], torch.Tensor) and leaves[0].ndim >= 2:
                return gather_array(leaves, self.grid, self.mesh_shape)
            return leaves[0]

        return _gather_tree(list(states), gather)

    def initial_state(self, **values):
        return self.scatter_state(self.global_model.initial_state(**values))

    def step(self, states, dt, kernels=None):
        """One step of every shard (each in its thread); ``kernels`` as the
        model's ``step`` takes it."""
        return self.mesh.run(
            lambda r: self.local_models[r].step(states[r], dt, kernels=kernels))

    def prognostic_names(self):
        return self.global_model.prognostic_names()
