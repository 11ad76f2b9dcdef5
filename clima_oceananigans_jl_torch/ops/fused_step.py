"""Fused AB2 advance: advection, Coriolis, pHY′ gradient, diffusion and the
AB2 substep in one kernel launch.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_step.py``. Per
prognostic field ψ: G = −∇·(vψ) [− f×u and − ∂pHY′ on u and v]
[+ ∇·(κ∇ψ), horizontal only for a vertically implicit closure], then
ψ′ = ψ + Δt((3/2+χ)G − (1/2+χ)G⁻). G comes back in the model's
``G_prev`` layout (``model.g_interior``: halo-free, else with zero
halos). ψ′ comes back halo-free, shape (nx, ny, nz), where the model
projects u, v, w on these interiors with the roll-based projection and
pads once; on the JAX package's other route (``general_route``: a
stretched z, a vertically implicit closure, or w walls the roll-based
projection cannot impose), with halos as the JAX kernel pads it, for the
implicit step and ``project_velocities``: zeros, but for w's top wall face
on a bounded z with halo-carrying G (``w_top``), which the general
projection reads. That route runs the kernel's general instantiation.

``fused_ab2_advance`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/fused_ab2_advance.cu`` (or raises), on CPU
tensors it runs ``fused_ab2_advance_reference``, the same function in
plain PyTorch.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from ..closures.eddy_viscosity import (AnisotropicMinimumDissipation,
                                       SmagorinskyLilly, TwoDimensionalLeith)
from ..closures.implicit_vertical_diffusion import implicit_step_is_noop
from ..closures.isopycnal import IsopycnalSkewSymmetricDiffusivity
from ..closures.scalar_diffusivity import (ScalarBiharmonicDiffusivity,
                                           ScalarDiffusivity)
from ..closures.vertical_mixing import (CATKEVerticalDiffusivity,
                                        ConvectiveAdjustmentVerticalDiffusivity,
                                        RiBasedVerticalDiffusivity)
from ..coriolis.coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                                 NonTraditionalBetaPlane)
from ..grids.topology import BOUNDED, FLAT, FULLY_CONNECTED
from ..immersed.immersed import ImmersedBoundary, PartialCellBottom
from ..timesteppers.steppers import ab2_coefficients, ab2_substep
from ..utils.location import U_LOC, V_LOC
from .fused_tendencies import (ADVECTION_ARGTYPES, KERNEL_SCHEMES,
                               advection_args, check_tensor,
                               fused_advective_tendencies_reference,
                               in_kernel_order, kernel_fn, kernel_order,
                               launch, pointers, supports_fused_advection,
                               z_rows_arg)
from .metric_rows import coriolis_rows

#: the closures the nonhydrostatic model takes, alone or in tuples
CLOSURES = (ScalarDiffusivity, ScalarBiharmonicDiffusivity, SmagorinskyLilly,
            AnisotropicMinimumDissipation, TwoDimensionalLeith,
            CATKEVerticalDiffusivity, ConvectiveAdjustmentVerticalDiffusivity,
            RiBasedVerticalDiffusivity, IsopycnalSkewSymmetricDiffusivity)
#: its Coriolis forms: f- and β-planes in K1, the other two as PyTorch
#: terms of ``tendencies`` (the general branch)
CORIOLIS = (FPlane, BetaPlane, ConstantCartesianCoriolis,
            NonTraditionalBetaPlane)
#: its advection schemes, the JAX package's eight, which K1 and K2 take for
#: momentum and tracers
SCHEMES = tuple(KERNEL_SCHEMES)


def _scalar_coefficient(v):
    """A ν/κ entry the kernel takes: None, a number or a 0-d tensor, or a
    per-tracer dict of them."""
    if isinstance(v, dict):
        return all(_scalar_coefficient(x) for x in v.values())
    return (v is None or isinstance(v, numbers.Real)
            or (isinstance(v, torch.Tensor) and v.ndim == 0))


def unsupported_reason(model):
    """Why the port cannot run this configuration at all, or None. A
    reason names what is not ported and, where one waits for it, its
    ROADMAP item."""
    if model.timestepper not in ("QuasiAdamsBashforth2", "RungeKutta3"):
        return (f"timestepper {model.timestepper!r} is not ported (the JAX "
                "package's QuasiAdamsBashforth2 and RungeKutta3 are)")
    cor = model.coriolis
    if cor is not None and not isinstance(cor, CORIOLIS):
        return (f"{type(cor).__name__} Coriolis is not ported (FPlane, "
                "BetaPlane, ConstantCartesianCoriolis and "
                "NonTraditionalBetaPlane are)")
    for sch in (model.advection, model.tracer_advection):
        if type(sch) not in SCHEMES:
            return (f"{type(sch).__name__} advection is not ported (the JAX "
                    "package's eight schemes are)")
    cl = model.closure
    for c in (cl if isinstance(cl, (tuple, list)) else (cl,)):
        if c is not None and not isinstance(c, CLOSURES):
            return (f"{type(c).__name__} closures are not ported (the JAX "
                    "package's scalar, biharmonic, LES, vertical-mixing and "
                    "GM/Redi closures are) (ROADMAP Queue 1 item 7)")
    ib = model.immersed_boundary
    if isinstance(ib, PartialCellBottom):
        return ("PartialCellBottom (fractional bottom cells, 3D vertical "
                "metrics) is not ported yet (ROADMAP Queue 1 item 7)")
    if ib is not None and not isinstance(ib, ImmersedBoundary):
        return (f"{type(ib).__name__} immersed boundaries are not ported yet "
                "(GridFittedBottom and GridFittedBoundary are) (ROADMAP Queue 1 "
                "item 7)")
    if all(t is FLAT for t in model.grid.topology):
        return "a nonhydrostatic grid needs an axis that is not Flat"
    # a FULLY_CONNECTED axis cut over a mesh (``grid.dist``) is filled by
    # the exchange, and K2, K3b, K3c read it like a periodic one (no wall
    # faces); one that no mesh fills (a cubed-sphere face's) is refused
    g = model.grid
    for a in range(3):
        if g.topology[a] is FULLY_CONNECTED and g.dist[a] is None:
            return ("a FULLY_CONNECTED axis that no mesh exchanges is not "
                    "ported in the nonhydrostatic model")
    return None


def _step_kernel_closure(model):
    """The model's closure when the fused kernel can run its explicit part
    (the JAX package's ``_step_kernel_closure`` with ``kernel_closure``):
    one constant-coefficient ``ScalarDiffusivity`` (scalars or per-tracer
    dicts of scalars). A vertically implicit one qualifies as it is: the
    kernel runs its horizontal part and the implicit solve the rest. An
    explicit one qualifies when its vertical part is exact in the kernel:
    the JAX kernel zeroes the wall-face diffusive flux, which equals the
    mirror fill only for zero-gradient (flux/None) z walls and an
    impenetrable zero w wall; value or gradient z walls keep diffusion
    outside the kernel (the general branch). None otherwise."""
    cl = model.closure
    if not isinstance(cl, ScalarDiffusivity) or not all(
            _scalar_coefficient(v) for v in (cl.nu, cl.kappa, cl.nu_z, cl.kappa_z)):
        return None
    if cl.vertically_implicit:
        return cl
    if model.grid.topology[2] is BOUNDED:
        for name in model.prognostic_names():
            for side in ("bottom", "top"):
                bc = getattr(model.bcs[name], side)
                if bc is not None and bc.kind not in ("flux",) \
                        and not (name == "w" and bc.kind == "open"
                                 and not callable(bc.value)
                                 and float(bc.value or 0.0) == 0.0):
                    return None
    return cl


def fused_step_ok(model):
    """The JAX gate of the fused AB2 branch (``ops/fused_step.py::
    fused_step_ok``) on the configurations the port accepts: the model's
    ``fused_advection`` and a grid that the JAX package's fused advection
    takes (``supports_fused_advection``: no bounded x or y, not a Flat y),
    quasi-AB2, f/β-plane Coriolis or none, a closure whose explicit part
    the kernel runs, and no term the kernel lacks (forcing, background
    fields, Stokes drift, tilted gravity, flux-BC values, an immersed
    boundary): those send the step to the general branch, whose advection
    K2 carries, as they do in the JAX package (and ``G_prev`` keeps its
    layout). The scheme decides nothing: K1 takes every scheme, as the
    JAX kernel traces every scheme in."""
    if not (model.fused_advection and supports_fused_advection(model.grid)
            and model.timestepper == "QuasiAdamsBashforth2"):
        return False
    # a grid cut over a mesh (a FULLY_CONNECTED axis) takes the general
    # branch, as in the JAX gate (ops/fused_step.py:63-64): K1 runs on one
    # shard's whole grid
    if model.grid.dist != (None, None, None):
        return False
    if model.coriolis is not None and not isinstance(model.coriolis,
                                                     (FPlane, BetaPlane)):
        return False
    if (model.stokes_drift is not None or model.forcing
            or model.background_fields or model.immersed_boundary is not None):
        return False
    if model.closure is not None and _step_kernel_closure(model) is None:
        return False
    b = model.buoyancy
    if b is not None and tuple(b.gravity_unit_vector) != (0.0, 0.0, -1.0):
        return False
    for name in model.prognostic_names():
        for _axis, _side, bc in model.bcs[name].sides():
            if bc is not None and bc.kind == "flux" and bc.value is not None:
                return False
    return True


def general_route(model):
    """The JAX package's route after the fused advance other than its
    interior fast lane: the implicit step and ``project_velocities`` on
    with-halo ψ′, where the roll-based projection does not apply (a
    stretched z, w walls that are not imposed values) or the implicit step
    is not the identity. The model's fast lane (the roll-based projection
    on ψ′ interiors) gives the same numbers wherever both apply."""
    return not (model._fast_projection_ok()
                and implicit_step_is_noop(model.closure))


def w_top(model):
    """K1 also writes G_w and ψ′_w at w's top wall face (with-halo z index
    hz+nz): in the fused branch, on the general route with halo-carrying G
    on a bounded z, where a w wall that the fill does not impose (FluxBC)
    leaves that face to the step."""
    return (model.fused_step and general_route(model) and not model.g_interior
            and model.grid.topology[2] is BOUNDED)


def fused_ab2_advance_reference(model, state, dt, euler):
    """The plain-PyTorch version of the kernel: the model's ``tendencies``
    with the plain advection (div_* fluxes, Coriolis, −∂pHY′, diffusion in
    the JAX term order) and ``ab2_substep``. Returns ``(psi_new, G)``:
    ψ′ halo-free, or with halos on the ``general_route`` (zeros, but for
    w's top wall face under ``w_top``), and G in the model's ``G_prev``
    layout (with-halo: zero halos, but for that face)."""
    grid = model.grid
    G = model.tendencies(state, {"advect": fused_advective_tendencies_reference})
    if general_route(model):
        gp = model._g_prev_with_halos(state["G_prev"])
        psi = ab2_substep(state["solution"], G, gp, dt, model.ab2_chi, euler)
        top = w_top(model)
        psi = {k: _keep_written(grid, x, top and k == "w") for k, x in psi.items()}
        if model.g_interior:
            G = {k: grid.interior(g).contiguous() for k, g in G.items()}
        else:
            G = {k: _keep_written(grid, g, top and k == "w") for k, g in G.items()}
        return psi, G
    G = {k: grid.interior(g).contiguous() for k, g in G.items()}
    sol = {k: grid.interior(v) for k, v in state["solution"].items()}
    gp = {k: grid.interior(g) for k, g in state["G_prev"].items()}
    psi = ab2_substep(sol, G, gp, dt, model.ab2_chi, euler)
    if not model.g_interior:
        G = {k: grid.pad(g) for k, g in G.items()}
    return psi, G


def _keep_written(grid, x, top_face):
    """A with-halo copy of ``x`` with zero halos, but for w's top wall face
    (with-halo z index hz+nz over the interior columns) under
    ``top_face``: the points the general instantiation of K1 writes."""
    out = grid.pad(grid.interior(x))
    if top_face:
        (hx, hy, hz), (nx, ny, nz) = grid.halo, grid.shape
        out[hx:hx + nx, hy:hy + ny, hz + nz] = x[hx:hx + nx, hy:hy + ny, hz + nz]
    return out


def _coriolis_rows(model):
    """f at U_LOC and V_LOC over the with-halo y axis, as the plain
    version forms it, or (None, None) without Coriolis."""
    if model.coriolis is None:
        return None, None
    return coriolis_rows(model.grid, model.coriolis)


def _diffusivities(model, names, order):
    """Host arrays of per-field diffusivities for the kernel's horizontal
    and vertical fluxes, or (None, None) without a closure. The kernel's
    z is the grid's y where z is Flat (``kernel_order``): it then takes the
    horizontal one."""
    cl = _step_kernel_closure(model)
    if cl is None:
        return None, None
    nu_z = cl.nu_z if cl.nu_z is not None else cl.nu
    kh = [cl.nu] * 3 + [cl.kappa_for(n) for n in names[3:]]
    kz = [nu_z] * 3 + [cl.kappa_z_for(n) for n in names[3:]]
    if order[2] != 2:
        kz = kh
    arr = lambda xs: (ctypes.c_double * len(xs))(*[float(x) for x in xs])
    return arr(kh), arr(kz)


def _kernel_z_rows(grid, order, scheme, tracer_scheme, general):
    """(z rows, tables) of ``z_rows_arg`` for the kernel's z; where that is
    the grid's y (a Flat z), its Δᶜ and Δᶠ rows, which a regular axis
    holds exactly."""
    if order[2] == 2:
        return z_rows_arg(grid, scheme, tracer_scheme, general)
    a = grid._axes[order[2]]
    return torch.stack([a.dc, a.df]).contiguous(), 0


def _launch(model, state, dt, euler):
    grid = model.grid
    names = model.prognostic_names()
    sol, gp = state["solution"], state["G_prev"]
    device, dtype = sol["u"].device, grid.dtype
    ints, doubles = advection_args(grid, model.advection,
                                   model.tracer_advection, len(names))
    order = kernel_order(grid)
    g_shape = grid.shape if model.g_interior else grid.total_shape
    for n in names:
        check_tensor(f"solution[{n!r}]", sol[n], grid.total_shape, dtype, device)
        check_tensor(f"G_prev[{n!r}]", gp[n], g_shape, dtype, device)
    ph = state.get("pHY") if model.buoyancy is not None else None
    if ph is not None:
        check_tensor("pHY", ph, grid.total_shape, dtype, device)
    fu, fv = _coriolis_rows(model)
    kh, kz = _diffusivities(model, names, order)

    general = general_route(model)
    if not grid.hregular:
        raise ValueError(f"K1 takes a regular x and y: {grid}")
    if FLAT in grid.topology and not general:
        raise ValueError(f"K1 takes a Flat axis on its general route only: {grid}")
    zs, tables = _kernel_z_rows(grid, order, model.advection,
                                model.tracer_advection, general)
    cl = _step_kernel_closure(model)
    vertical = int(cl is None or not cl.vertically_implicit or order[2] != 2)
    # K1 writes every point of psi' and G, in the with-halo layouts their
    # halos too
    psi_shape = grid.total_shape if general else grid.shape
    out_psi = [torch.empty(psi_shape, dtype=dtype, device=device) for _ in names]
    out_g = [torch.empty(g_shape, dtype=dtype, device=device) for _ in names]
    c1, c2 = ab2_coefficients(model.ab2_chi, euler)
    ptr = lambda t: None if t is None else t.data_ptr()
    kernel = lambda ts: pointers(in_kernel_order(order, ts))
    fn = kernel_fn("fused_ab2_advance", "fused_ab2_advance", dtype,
                   [ctypes.c_void_p] * 9 + [ctypes.c_int] + ADVECTION_ARGTYPES
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 3)
    launch("fused_ab2_advance", fn, device,
           kernel([sol[n] for n in names]), kernel([gp[n] for n in names]),
           kernel(out_psi), kernel(out_g), ptr(ph), ptr(fu), ptr(fv),
           kh, kz, int(not model.g_interior), ints, doubles, c1, c2, float(dt),
           ptr(zs), tables, vertical, int(w_top(model)))
    fused_ab2_advance.launches += 1
    return dict(zip(names, out_psi)), dict(zip(names, out_g))


def fused_ab2_advance(model, state, dt, euler):
    """One fused AB2 advance → ``(psi_new, G)``: ψ′ halo-free (with halos
    on the ``general_route``), G in the model's ``G_prev`` layout. CUDA
    tensors go through the hand-written kernel (its general instantiation
    on the general route; a failure raises and nothing falls back), CPU
    tensors through ``fused_ab2_advance_reference``."""
    device = state["solution"]["u"].device
    if device.type == "cuda":
        return _launch(model, state, dt, euler)
    if device.type != "cpu":
        raise ValueError(f"no fused_ab2_advance for {device.type} tensors")
    return fused_ab2_advance_reference(model, state, dt, euler)


#: kernel launches since the last reset (the plain version adds nothing)
fused_ab2_advance.launches = 0
