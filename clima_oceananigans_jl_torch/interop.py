"""State exchange with the JAX package, through numpy.

``state_from_numpy`` turns a JAX ``NonhydrostaticModel`` or
``ShallowWaterModel`` state whose leaves went through ``np.asarray`` (for
instance ``jax.tree_util.tree_map(np.asarray, state)``) into this
package's state for ``model``:

- with-halo arrays are cut to their interiors, whatever halo the JAX
  model used (its fused path rounds the y halo up to 4), placed in the
  port's halo layout and halo-filled with the port's BCs;
- ``G_prev`` takes the layout ``model`` steps with (halo-free when
  ``model.g_interior``, else with zero halos but for each velocity's
  wall face on a bounded axis, which the time step reads where the wall
  is not an imposed value), from either JAX layout;
- ``pNHS`` keeps zero halos, as the projection stores it;
- over an immersed boundary the filled fields are masked in the solid,
  halos included, as the JAX ``update_state`` leaves them;
- ``diffusivities`` (the LES, vertical-mixing and GM/Redi closures'
  fields: tensors, a dict per closure, a tuple per closure tuple with None
  for a member without fields) are cut to the port's with-halo
  shape around the interior, halos and all, since the next step's
  interpolation onto the flux faces reads their first halo cells;
- the 0-d ``clock`` and ``previous_dt`` leaves become numpy scalars of
  their own dtype (the port's clock ticks in it);
- a shallow-water state (RK3) has ``solution`` and ``clock`` only;
- a hydrostatic state also carries ``eta`` (X, Y, 1) and the diagnosed
  ``w`` and ``pHY``: their x/y interiors (all z levels, so w keeps its
  top face) go into the port's layout and are halo-filled; its
  ``G_prev`` (an ``eta`` entry too under an explicit free surface) comes
  with halos (the JAX plain path) or x/y-interior (the JAX fused
  advance) and goes in with zero x/y halos; a closure's
  ``diffusivities`` go in as the nonhydrostatic model's do; a state
  without ``w`` and ``pHY`` (the JAX kernel that rebuilds them each step,
  ``wphy_in_kernel``) gets both, and the diffusivities, from the port's
  ``update_state``;
- ``particles`` (a ``LagrangianParticles`` of either package, its
  leaves numpy arrays) becomes the port's, its positions and properties
  tensors on the grid's device, in any model;
- ``layout="xzy"`` reads a JAX hydrostatic state stored (x, z, y) (its
  ``state_layout``, a checkpoint's ``__state_layout``): the solution,
  ``G_prev`` but an explicit free surface's ``eta``, ``w`` and ``pHY``
  are transposed back to (x, y, z) first.

Three more states convert whole, with their JAX shapes:

- a ``CubedSphereHydrostaticModel`` state (``solution`` of (6, X, Y, Z)
  arrays, ``eta`` of (6, X, Y, 1), ``clock``), halos and all (both
  packages' cubed-sphere grids have the same layout);
- a ``PrescribedVelocityModel`` state (``solution``, ``G_prev``,
  ``clock``, ``previous_dt``): tracers cut to their interiors, placed in
  the port's layout and halo-filled; ``G_prev`` kept with its halos
  where the shapes agree;
- a batched ensemble state (``models/ensemble.py``), whose clock's time
  has a leading member axis: each member converts alone, then the
  members stack.

``state_to_numpy`` goes the other way, keeping the port's layout (halo
3, ``G_prev`` as the model keeps it), which the JAX package's plain step
accepts; its ``particles`` is a ``LagrangianParticles`` whose leaves are
numpy arrays, whose fields build the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .boundary_conditions.bcs import fill_halos
from .grids.topology import BOUNDED
from .timesteppers.steppers import Clock
from .utils.location import CENTER, W_LOC


def _interior(arr, shape):
    """The centred (nx, ny, nz) block of a with-halo (or halo-free) array."""
    arr = np.asarray(arr)
    if arr.ndim != 3 or any((t - n) % 2 or t < n
                            for t, n in zip(arr.shape, shape)):
        raise ValueError(f"cannot cut an interior {tuple(shape)} out of "
                         f"shape {arr.shape}")
    return arr[tuple(slice((t - n) // 2, (t - n) // 2 + n)
                     for t, n in zip(arr.shape, shape))]


def _with_wall_face(grid, name, out, arr):
    """``out`` (a padded interior) with the wall face of velocity ``name``
    on its bounded axis (index h + n over the other axes' interiors) taken
    from the with-halo ``arr``, whatever its halos: a wall that is not an
    imposed value leaves that face of G to the time step."""
    axis = {"u": 0, "v": 1, "w": 2}.get(name)
    arr = np.asarray(arr)
    if (axis is None or grid.topology[axis] is not BOUNDED
            or arr.shape[axis] == grid.shape[axis]):
        return out
    n, h = grid.shape[axis], (arr.shape[axis] - grid.shape[axis]) // 2
    plane = _interior(np.take(arr, [h + n], axis=axis),
                      tuple(1 if a == axis else grid.shape[a] for a in range(3)))
    sl = list(grid.interior_slices)
    sl[axis] = slice(grid.halo[axis] + n, grid.halo[axis] + n + 1)
    out[tuple(sl)] = torch.as_tensor(np.array(plane), dtype=grid.dtype,
                                     device=grid.device)
    return out


def _xy_interior(arr, grid):
    """The x/y interior of a with-halo or x/y-interior array, all z kept,
    placed in a zero tensor of the port's x/y halos."""
    arr = np.asarray(arr)
    nx, ny = grid.Nx, grid.Ny
    cut = arr[tuple(slice((t - n) // 2, (t - n) // 2 + n)
                    for t, n in zip(arr.shape[:2], (nx, ny)))]
    out = torch.zeros(grid.total_shape[:2] + cut.shape[2:], dtype=grid.dtype,
                      device=grid.device)
    out[grid.Hx:grid.Hx + nx, grid.Hy:grid.Hy + ny] = torch.as_tensor(
        np.array(cut), dtype=grid.dtype, device=grid.device)
    return out


def _hydrostatic_from_numpy(model, state, out, t):
    from .models.free_surface import ETA_LOC, fill2d
    g = model.grid
    out["eta"] = fill2d(_xy_interior(state["eta"], g), g, ETA_LOC,
                        model.eta_bcs, t)
    if "w" in state:
        out["w"] = fill_halos(_xy_interior(state["w"], g), g, W_LOC, model.w_bcs)
    if "pHY" in state:
        out["pHY"] = fill_halos(_xy_interior(state["pHY"], g), g, CENTER,
                                model.pressure_bcs, t)
    out["G_prev"] = {n: _xy_interior(x, g) for n, x in state["G_prev"].items()}
    out["previous_dt"] = _host(state["previous_dt"])
    if "diffusivities" in state:
        out["diffusivities"] = _diffusivities_from_numpy(state["diffusivities"], g)
    return out if "w" in state else model.update_state(out)


def _natural(state):
    """A JAX "xzy" state with its (x, z, y) arrays transposed to (x, y, z)."""
    xyz = lambda a: np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 1)))
    state = dict(state)
    for k in ("solution", "G_prev"):
        state[k] = {n: v if n == "eta" else xyz(v) for n, v in state[k].items()}
    for k in ("w", "pHY"):
        if k in state:
            state[k] = xyz(state[k])
    return state


def _host(leaf):
    """A 0-d leaf as a numpy scalar of its own dtype."""
    return np.asarray(leaf)[()]


def _diffusivities_from_numpy(d, grid):
    """Diffusivity fields (arrays, dicts, tuples, None) into the port's
    layout; scalars pass."""
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: _diffusivities_from_numpy(v, grid) for k, v in d.items()}
    if isinstance(d, (tuple, list)):
        return tuple(_diffusivities_from_numpy(v, grid) for v in d)
    if np.ndim(d) == 3:  # the port's with-halo block, centred
        return torch.as_tensor(np.array(_interior(d, grid.total_shape)),
                               dtype=grid.dtype, device=grid.device)
    return d


def _diffusivities_to_numpy(d):
    if isinstance(d, dict):
        return {k: _diffusivities_to_numpy(v) for k, v in d.items()}
    if isinstance(d, (tuple, list)):
        return tuple(_diffusivities_to_numpy(v) for v in d)
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return d


def _cubed_sphere_from_numpy(model, state):
    g = model.grid
    clock = state["clock"]
    return dict(solution={n: g._tensor(np.asarray(x))
                          for n, x in state["solution"].items()},
                eta=g._tensor(np.asarray(state["eta"])),
                clock=Clock(_host(clock.time), int(np.asarray(clock.iteration)),
                            int(np.asarray(getattr(clock, "stage", 0)))))


def _numpy_member(x, i):
    """Member i of a numpy-leaved batched state (either package's clock)."""
    if isinstance(x, dict):
        return {k: _numpy_member(v, i) for k, v in x.items()}
    if hasattr(x, "time") and hasattr(x, "iteration"):
        return Clock(np.asarray(x.time)[i], np.asarray(x.iteration)[i],
                     getattr(x, "stage", 0))
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy_member(v, i) for v in x)
    return np.asarray(x)[i] if np.ndim(x) >= 1 else x


def _ensemble_from_numpy(model, state, layout):
    from .models.ensemble import stack_states
    return stack_states([state_from_numpy(model, _numpy_member(state, i), layout)
                         for i in range(len(np.asarray(state["clock"].time)))])


def state_from_numpy(model, state, layout="natural"):
    """The port's state for ``model`` from a numpy-leaved JAX state
    (``layout``: the JAX model's ``state_layout``, "natural" or "xzy");
    a batched ensemble state (a clock time with a member axis) member by
    member."""
    from .models.cubed_sphere_hydrostatic import CubedSphereHydrostaticModel
    from .models.prescribed import PrescribedVelocityModel
    if np.ndim(state["clock"].time) == 1:
        return _ensemble_from_numpy(model, state, layout)
    if isinstance(model, CubedSphereHydrostaticModel):
        return _cubed_sphere_from_numpy(model, state)
    if layout == "xzy":
        state = _natural(state)
    g = model.grid
    as_t = lambda a: torch.as_tensor(np.array(_interior(a, g.shape)),
                                     dtype=g.dtype, device=g.device)
    clock = state["clock"]
    t = float(np.asarray(clock.time))
    locs = model._locs()
    sol = {n: fill_halos(g.pad(as_t(state["solution"][n])), g, locs[n],
                         model.bcs[n], t)
           for n in model.prognostic_names()}
    out = dict(solution=sol,
               clock=Clock(_host(clock.time), int(np.asarray(clock.iteration)),
                           int(np.asarray(getattr(clock, "stage", 0)))))
    if "particles" in state:
        out["particles"] = _particles(state["particles"],
                                      lambda a: torch.as_tensor(
                                          np.array(a), dtype=g.dtype, device=g.device))
    if hasattr(model, "free_surface"):
        return _hydrostatic_from_numpy(model, state, out, t)
    if isinstance(model, PrescribedVelocityModel):
        full = lambda x: torch.as_tensor(np.array(x), dtype=g.dtype, device=g.device)
        out["G_prev"] = {n: full(x) if np.shape(x) == g.total_shape
                         else g.pad(as_t(x)) for n, x in state["G_prev"].items()}
        out["previous_dt"] = _host(state["previous_dt"])
        return out
    if not hasattr(model, "pressure_solver"):  # shallow water
        return out
    if model.immersed_boundary is not None:  # filled, then masked (JAX order)
        out = model.immersed_boundary.mask_state(model, out)
    gp = {n: as_t(state["G_prev"][n]).contiguous()
          for n in model.prognostic_names()}
    out.update(G_prev=gp if model.g_interior else
               {n: _with_wall_face(g, n, g.pad(x), state["G_prev"][n])
                for n, x in gp.items()},
               pNHS=g.pad(as_t(state["pNHS"])),
               previous_dt=_host(state["previous_dt"]))
    if "pHY" in state:
        out["pHY"] = fill_halos(g.pad(as_t(state["pHY"])), g, CENTER,
                                model.pressure_bcs, t)
    if "diffusivities" in state:
        out["diffusivities"] = _diffusivities_from_numpy(state["diffusivities"], g)
    return out


def _particles(p, leaf):
    """The port's ``LagrangianParticles`` with the fields of ``p`` (either
    package's), each position and property through ``leaf``."""
    from .particles.lagrangian import LagrangianParticles
    return LagrangianParticles(leaf(p.x), leaf(p.y), leaf(p.z),
                               {k: leaf(v) for k, v in p.properties.items()},
                               p.restitution, tuple(p.tracked_fields))


def state_to_numpy(state):
    """numpy copies of the port's state: the same keys and layout, with a
    ``Clock`` of 0-d numpy leaves."""
    np_of = lambda x: x.detach().cpu().numpy()
    out = {k: {n: np_of(x) for n, x in state[k].items()}
           for k in ("solution", "G_prev") if k in state}
    for k in ("pNHS", "pHY", "eta", "w"):
        if k in state:
            out[k] = np_of(state[k])
    if "diffusivities" in state:
        out["diffusivities"] = _diffusivities_to_numpy(state["diffusivities"])
    if "particles" in state:
        out["particles"] = _particles(state["particles"], np_of)
    dtype = next(iter(out["solution"].values())).dtype
    out["clock"] = Clock(np.asarray(state["clock"].time, dtype),
                         np.asarray(state["clock"].iteration, np.int32))
    if "previous_dt" in state:
        out["previous_dt"] = np.asarray(state["previous_dt"], dtype)
    return out
