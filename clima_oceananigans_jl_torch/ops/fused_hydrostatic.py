"""The hydrostatic model's kernels: K4a (w and pHY′ columns) and K4b (fused
tendencies, optionally with the AB2 advance), with their plain versions.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py``:
the Pallas ``fused_hydrostatic_tendencies`` computes, in one pass over
(x, y) tiles, the hydrostatic tendency core — vector-invariant or
flux-form momentum advection, Coriolis, −∇pHY′ and the tracers' flux
divergences on lat-lon and stretched metrics — optionally rebuilding w
and pHY′ in the kernel and optionally taking the AB2 substep. On the
card that becomes two kernels:

- K4a ``hydrostatic_columns`` (``csrc/hydrostatic_columns.cu``): a
  block per x index and run of up to 32 y columns, staged in shared
  memory; the increments in parallel, then one thread a column and sum,
  serial over z: w from continuity, w(k+1) = −Σ Δz ∇ₕ·(u, v), and
  pHY′ = −Σ b̄ᶻ Δzᶠ from the top. Like its plain version it computes
  every (x, y) column, halo columns too (their values are overwritten by
  the caller's fill), and writes every with-halo point, so the outputs
  need no zero fill. On a Flat y a block owns a run of x indices instead
  (consecutive columns there). It runs in the model's ``update_state``;
  its plain version sums level by level in a Python loop, in the
  kernel's order.
- K4b ``fused_hydrostatic_tendencies``
  (``csrc/fused_hydrostatic_tendencies.cu``): a block per 16×8 tile of
  interior columns (and chunk of levels), its fields staged in shared
  memory, computing ``hydrostatic_advective_core`` and, with
  ``advance=(dt, euler)``, ψ′ = ψ + Δt(c₁G − c₂G⁻) too, each face flux
  once; the same launch writes the halos zero. It takes the explicit
  diffusion of a constant-coefficient ``ScalarDiffusivity``
  (``kernel_closure``), the conditional fluxes next to an immersed
  boundary (the clear flags of ``immersed/immersed.py::clear_flags``, one
  uint8 tensor a location) and a stretched y axis' WENO5 tables
  (``y_tables``), as the TPU kernel does, and beyond it a Flat x, a Flat
  y or both (a line of 128 columns a block along the axis that is not
  Flat; strides 0 along a Flat one, so that every neighbour there is the
  cell itself, as the plain version's rolls make it) and the Cartesian
  Coriolis forms (``ConstantCartesianCoriolis``,
  ``NonTraditionalBetaPlane``: their w terms read the staged w). Its
  plain version is the core (and ``ab2_substep``).

On partial bottom cells (``PartialCellBottom``, whose grid's Δz is two 3D
arrays) both kernels run their 3D-Δz forms, through the entries
``hydrostatic_columns_dz3`` and ``fused_hydrostatic_tendencies_dz3``, which
read ``metric_rows.dz3_pack``: K4a gives each u face the Δz of the cell
east of it and each v face that of the cell north of it (the grid's ``Ax``
and ``Ay``) and pHY′ the face Δz; K4b reads the Δz of each face area, cell
volume and vertical-advection quotient at its own point, in its run-time
form (every scheme, on a tile of both horizontal axes). The JAX gate
refuses these grids; the port's gate refuses them only on a Flat x or y.

``hydrostatic_advective_core`` is the JAX function, in plain torch; the
model's plain path and K4b's plain version share it. Each wrapper runs
its plain version on CPU tensors and its kernel on CUDA tensors (or
raises: nothing falls back), and counts its launches in
``<wrapper>.launches``. ``unsupported_reason`` is the kernels' static
gate: x-constant metrics (a regular x axis), the schemes and Coriolis
forms the kernel has (a Flat z the model's constructor refuses before
it). The model's constructor runs it on the card, once; the wrappers do
not run it again.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..advection.fluxes import div_Uc, div_vu, div_vv
from ..advection.schemes import AdvectionScheme
from ..advection.vector_invariant import SCHEMES as VI_SCHEMES
from ..advection.vector_invariant import VectorInvariant
from ..closures.scalar_diffusivity import (ScalarDiffusivity,
                                           momentum_diffusion, tracer_diffusion)
from ..coriolis.coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                                 HydrostaticSphericalCoriolis,
                                 NonTraditionalBetaPlane)
from ..grids.topology import FLAT
from ..immersed.immersed import clear_flags
from ..timesteppers.steppers import ab2_coefficients, ab2_substep
from ..utils.location import CENTER, U_LOC, V_LOC, W_LOC
from . import _build
from . import operators as op
from . import stencil as st
from .fused_tendencies import (KERNEL_SCHEMES, TABLE_SCHEMES,
                               axis_bounds, check_tensor,
                               kernel_fn, kernel_scheme, launch, pointers,
                               positive_bounds)
from .metric_rows import dz3_pack, partial_cell_z_rows, y_rows, y_tables, z_rows

#: the Coriolis forms K4b takes, by its code (``_coriolis_code``)
KERNEL_CORIOLIS = (FPlane, BetaPlane, HydrostaticSphericalCoriolis,
                   ConstantCartesianCoriolis, NonTraditionalBetaPlane)
#: K4b's halo rows on a Flat y: its y rows repeat their one value this many
#: cells either side (``HT_R`` of ``csrc/fused_hydrostatic_tendencies.cu``)
FLAT_Y_ROWS_HALO = 3

#: the most prognostic fields (u, v and tracers) K4b takes
MAX_FIELDS = 16


def hydrostatic_advective_core(grid, scheme, tracer_scheme, coriolis,
                               tracer_names, u, v, w, tracers, pHY=None,
                               closure=None):
    """The hydrostatic tendency core (Oceananigans'
    hydrostatic_free_surface_tendency_kernel_functions.jl): −U·∇u or
    −∇·(vu), − f×u, −∂pHY′ for u and v, −∇·(U c) per tracer; with-halo
    tensors valid on the interior. ``scheme`` or ``tracer_scheme`` None
    leaves that advection out. ``closure``, a constant-coefficient
    ``ScalarDiffusivity`` (``kernel_closure``), adds its explicit
    ν∇²u, ν∇²v and κ∇²c (without their z part when it is vertically
    implicit)."""
    if isinstance(scheme, VectorInvariant):
        Gu = -scheme.U_dot_grad_u(grid, u, v, w)
        Gv = -scheme.U_dot_grad_v(grid, u, v, w)
    elif scheme is None:
        Gu, Gv = torch.zeros_like(u), torch.zeros_like(v)
    else:  # conservative flux form
        Gu = -div_vu(grid, scheme, u, v, w)
        Gv = -div_vv(grid, scheme, u, v, w)
    if coriolis is not None:
        Gu = Gu - coriolis.x_f_cross_U(grid, u, v, w)
        Gv = Gv - coriolis.y_f_cross_U(grid, u, v, w)
    if pHY is not None:
        Gu = Gu - st.dxf(pHY) / grid.dx(U_LOC)
        Gv = Gv - st.dyf(pHY) / grid.dy(V_LOC)
    if closure is not None:
        Gu = Gu + momentum_diffusion(u, grid, U_LOC, closure)
        Gv = Gv + momentum_diffusion(v, grid, V_LOC, closure)
    G = {"u": Gu, "v": Gv}
    for name in tracer_names:
        c = tracers[name]
        Gc = (-div_Uc(grid, tracer_scheme, u, v, w, c)
              if tracer_scheme is not None else torch.zeros_like(c))
        if closure is not None:
            Gc = Gc + tracer_diffusion(c, grid, name, closure)
        G[name] = Gc
    return G


def kernel_closure(model):
    """The model's closure where K4b adds its explicit part (JAX
    ``kernel_closure``): one ``ScalarDiffusivity`` of scalar ν, κ, νz, κz
    (per-tracer dicts of scalars included) on a grid without an immersed
    boundary; None otherwise, and the model adds the diffusion as torch
    ops."""
    cl = model.closure
    if not isinstance(cl, ScalarDiffusivity):
        return None
    if getattr(model.grid, "immersed", None) is not None:
        return None

    def scalar_ok(v):
        if v is None:
            return True
        if isinstance(v, dict):
            return all(scalar_ok(x) for x in v.values())
        return not callable(v) and np.ndim(v) == 0
    if not all(scalar_ok(v) for v in (cl.nu, cl.kappa, cl.nu_z, cl.kappa_z)):
        return None
    return cl


def _flux_form(model):
    """The model's flux-form momentum scheme, or None (the vector-invariant
    form, or no momentum advection)."""
    sch = model.momentum_advection
    return sch if isinstance(sch, AdvectionScheme) else None


def _mask_locs(model):
    """The locations whose solid masks K4b's conditional fluxes read (JAX
    ``_mask_locs``): CENTER for a tracer scheme that reads beyond its two
    cells (``buffer`` > 0), U_LOC and V_LOC for such a flux-form momentum
    scheme; none for the 2nd-order and first-order schemes and the
    vector-invariant form."""
    if getattr(model.grid, "immersed", None) is None:
        return ()
    ts, flux_form = model.tracer_advection, _flux_form(model)
    locs = []
    if isinstance(ts, AdvectionScheme) and ts.buffer > 0:
        locs.append(CENTER)
    if flux_form is not None and flux_form.buffer > 0:
        locs += [U_LOC, V_LOC]
    return tuple(locs)


# -- the static gate -------------------------------------------------------------

def unsupported_reason(model):
    """Why K4a/K4b cannot run this model's configuration, or None. Like the
    JAX gate it takes every ``AdvectionScheme`` for momentum and tracers
    (K4b's scheme codes, ``KERNEL_SCHEMES``, WENO5's bf16 options
    included) and the vector-invariant momentum; beyond it, a Flat x, a
    Flat y or both (the JAX gate leaves them to jnp), the Cartesian
    Coriolis forms, and a shard's grid cut over a mesh (the JAX gate
    refuses it, ops/fused_hydrostatic.py:146): the kernels read a cut
    axis' exchanged halos as on a periodic axis, with no near-wall bounds
    and no wall faces there, as the plain version on the local grid does
    (``axis_bounds`` reduces no order on a cut axis)."""
    grid = model.grid
    if not grid.x_regular:
        return ("K4 takes a regular x axis (x-constant metrics) "
                "(ROADMAP Queue 1 item 6)")
    sch, ts = model.momentum_advection, model.tracer_advection
    if sch is not None and not (isinstance(sch, VectorInvariant)
                                or type(sch) in KERNEL_SCHEMES):
        return f"K4 has no {type(sch).__name__} momentum advection"
    if ts is not None and type(ts) not in KERNEL_SCHEMES:
        return f"K4 has no {type(ts).__name__} tracer advection"
    cor = model.coriolis
    if cor is not None and not isinstance(cor, KERNEL_CORIOLIS):
        return f"K4 has no {type(cor).__name__} Coriolis"
    if len(model.prognostic_names()) > MAX_FIELDS:
        return f"K4 takes at most {MAX_FIELDS} prognostic fields"
    if partial_cells(grid) and FLAT in grid.topology[:2]:
        return "K4's 3D-Δz (partial-cell) forms take no Flat x or y"
    buffers = [s.buffer for s in (_flux_form(model), ts)
               if s is not None and s.buffer > 0]
    halos = [grid.halo[a] for a in (0, 1) if grid.topology[a] is not FLAT]
    if _mask_locs(model) and halos and min(halos) < max(buffers) + 1:
        return (f"K4b's conditional fluxes read {max(buffers) + 1} halo cells "
                "in x and y")
    return None


def supports_fused_hydro_advance(model):
    """The JAX gate of the fused advance (``ops/fused_hydrostatic.py::
    supports_fused_hydro_advance``): K4b computes G and the AB2 substep in
    one launch only where every tendency term lives in the kernel, so not
    with forcing or flux-BC values (added to G after the kernel) nor
    under an explicit free surface (its −g∇η likewise), nor with an
    immersed boundary (the tendencies are masked) or a closure K4b does
    not take (``kernel_closure``), and only with the model's
    ``fused_advection``. The JAX gate's TPU conditions (its VMEM budget
    beyond 5 tracers, the state layout) have no counterpart here."""
    from ..models.free_surface import ExplicitFreeSurface
    if not model.fused_advection or model.forcing:
        return False
    if model.grid.dist != (None, None, None):
        return False  # as the JAX DistributedModel clears fused_advance
    if getattr(model.grid, "immersed", None) is not None:
        return False
    if model.closure is not None and kernel_closure(model) is None:
        return False
    if isinstance(model.free_surface, ExplicitFreeSurface):
        return False
    for name in model.prognostic_names():
        for _axis, _side, bc in model.bcs[name].sides():
            if bc is not None and bc.kind == "flux" and bc.value is not None:
                return False
    return True


# -- K4a: w from continuity and pHY′, column by column ----------------------------

def hydrostatic_columns_reference(grid, u, v, b=None):
    """The plain-PyTorch version of K4a → (w, pHY′ or None), with-halo
    tensors with unfilled halos: w on the interior faces above the bottom
    (face Hz stays 0), pHY′ on the interior centres; sums level by level,
    w upwards and pHY′ downwards from the top face, in K4a's order."""
    Hz, Nz = grid.Hz, grid.Nz
    incr = grid.dz(CENTER) * op.div_xy_ccc(u, v, grid)
    w = grid.zeros()
    acc = None
    for k in range(Hz, Hz + Nz):
        acc = incr[:, :, k] if acc is None else acc + incr[:, :, k]
        w[:, :, k + 1] = -acc
    if b is None:
        return w, None
    S = st.izf(b) * grid.dz(W_LOC)   # b̄ᶻ Δzᶠ at the faces
    ph = grid.zeros()
    acc = None
    for k in range(Hz + Nz - 1, Hz - 1, -1):
        acc = S[:, :, k + 1] if acc is None else acc + S[:, :, k + 1]
        ph[:, :, k] = -acc
    return w, ph


def partial_cells(grid):
    """Whether ``grid`` has partial bottom cells (3D Δz): K4a and K4b then
    run their 3D-Δz forms, reading ``dz3_pack``."""
    return getattr(grid, "partial_cells", False)


def _launch_columns(grid, u, v, b):
    for name, f in (("u", u), ("v", v), ("b", b)):
        if f is not None:
            check_tensor(name, f, grid.total_shape, grid.dtype, u.device)
    # on partial cells the entry _dz3 reads the 3D Δz in place of the z rows
    d3 = partial_cells(grid)
    ys, zs = y_rows(grid), dz3_pack(grid) if d3 else z_rows(grid)
    # K4a writes every with-halo point
    empty = lambda: torch.empty(grid.total_shape, dtype=grid.dtype, device=u.device)
    w = empty()
    ph = empty() if b is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = kernel_fn("hydrostatic_columns", "hydrostatic_columns" + ("_dz3" if d3 else ""),
                   grid.dtype, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6)
    launch("hydrostatic_columns", fn, u.device, ptr(u), ptr(v), ptr(b),
           ptr(ys), ptr(zs), ptr(w), ptr(ph), *grid.shape, *grid.halo)
    hydrostatic_columns.launches += 1
    return w, ph


def hydrostatic_columns(grid, u, v, b=None):
    """w from continuity and, given the buoyancy ``b``, pHY′ → (w, pHY′
    or None), with-halo tensors valid on the interior columns (the caller
    fills the halos). CUDA tensors go through K4a (a failure raises;
    nothing falls back), CPU tensors through
    ``hydrostatic_columns_reference``. The grid passes
    ``unsupported_reason`` (a regular x axis)."""
    if u.device.type == "cuda":
        return _launch_columns(grid, u, v, b)
    if u.device.type != "cpu":
        raise ValueError(f"no hydrostatic_columns for {u.device.type} tensors")
    return hydrostatic_columns_reference(grid, u, v, b)


#: kernel launches since the last reset (the plain version adds nothing)
hydrostatic_columns.launches = 0


def columns_config(grid, with_b=True):
    """K4a's launch shape for ``grid`` on the current CUDA device: the
    y columns a block owns, its blocks per x row, its shared
    memory in bytes, threads a block and registers a thread (as ptxas
    allocated them)."""
    out = (ctypes.c_int * 5)()
    fn = getattr(_build.load("hydrostatic_columns"), "hydrostatic_columns_config"
                 + ("_f32" if grid.dtype == torch.float32 else "_f64"))
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(grid.Ny, grid.Hy, grid.Nz, grid.Hz, int(with_b), out)
    if rc != 0:
        raise RuntimeError(f"hydrostatic_columns config failed: CUDA error {rc}")
    return dict(zip(("run", "blocks_per_row", "smem_bytes", "threads",
                     "registers"), out))


# -- K4b: the fused tendencies --------------------------------------------------------

def fused_hydrostatic_tendencies_reference(model, state, advance=None):
    """The plain-PyTorch version of K4b: ``hydrostatic_advective_core`` on
    the state (G, with-halo) and, with ``advance=(dt, euler)``, the AB2
    substep of the solution → ``(psi_new, G)``."""
    sol = state["solution"]
    ph = state.get("pHY") if model.buoyancy is not None else None
    G = hydrostatic_advective_core(
        model.grid, model.momentum_advection, model.tracer_advection,
        model.coriolis, model.tracer_names, sol["u"], sol["v"], state["w"],
        {n: sol[n] for n in model.tracer_names}, pHY=ph,
        closure=kernel_closure(model))
    if advance is None:
        return G
    dt, euler = advance
    return ab2_substep(sol, G, state["G_prev"], dt, model.ab2_chi, euler), G


#: K4b's momentum codes after those of the vector-invariant schemes
FLUX_FORM, NO_MOMENTUM = len(VI_SCHEMES), len(VI_SCHEMES) + 1


def _momentum_code(scheme):
    """The vector-invariant scheme's index in ``VI_SCHEMES``, ``FLUX_FORM``
    or ``NO_MOMENTUM``."""
    if isinstance(scheme, VectorInvariant):
        return VI_SCHEMES.index(scheme.scheme)
    return NO_MOMENTUM if scheme is None else FLUX_FORM


def _coriolis_code(cor):
    """0 none, 1 f- or β-plane, 2 spherical energy, 3 spherical enstrophy,
    4 constant Cartesian, 5 non-traditional β-plane."""
    if cor is None:
        return 0
    if isinstance(cor, HydrostaticSphericalCoriolis):
        return 2 if cor.scheme == "energy" else 3
    if isinstance(cor, ConstantCartesianCoriolis):
        return 4
    if isinstance(cor, NonTraditionalBetaPlane):
        return 5
    return 1


def kernel_y_rows(grid, coriolis=None):
    """K4b's y rows: ``y_rows``, on a Flat y its one column repeated
    ``FLAT_Y_ROWS_HALO`` times either side (the kernel reads them as halo
    rows)."""
    ys = y_rows(grid, coriolis)
    if grid.topology[1] is not FLAT:
        return ys
    key = ("k4b_flat_y_rows", coriolis)
    if key not in grid._cache:
        grid._cache[key] = ys.expand(-1, 1 + 2 * FLAT_Y_ROWS_HALO).contiguous()
    return grid._cache[key]


def _launch_tendencies(model, state, advance):
    grid = model.grid
    names = model.prognostic_names()
    sol = state["solution"]
    device, dtype = sol["u"].device, grid.dtype
    fields = [sol[n] for n in names]
    for n, f in zip(names, fields):
        check_tensor(f"solution[{n!r}]", f, grid.total_shape, dtype, device)
    w = state["w"]
    check_tensor("w", w, grid.total_shape, dtype, device)
    ph = state.get("pHY") if model.buoyancy is not None else None
    if ph is not None:
        check_tensor("pHY", ph, grid.total_shape, dtype, device)
    sch, ts = model.momentum_advection, model.tracer_advection
    flux_form = _flux_form(model)
    mom_code, mom_eps = kernel_scheme(flux_form) if flux_form is not None else (0, 0.0)
    tr, tr_eps = kernel_scheme(ts) if ts is not None else (-1, 0.0)
    # the near-wall bounds per axis of the flux-form momentum scheme, then
    # of the tracer scheme (none for a scheme that reads two cells)
    bounds_of = lambda s: ([b for a in range(3) for b in axis_bounds(grid, a, s)]
                           if s is not None else [0, 0, -1, 0, -1] * 3)
    bounds = bounds_of(flux_form)
    tracer_bounds = (ctypes.c_int * 15)(*bounds_of(ts))
    pw = (ctypes.c_double * 4)(*positive_bounds(flux_form), *positive_bounds(ts))
    # the WENO5 family's tables on a stretched z or y
    table = any(type(s) in TABLE_SCHEMES for s in (flux_form, ts))
    tables = table and not grid.z_regular
    ytables = table and not grid.y_regular
    # on partial cells the entry _dz3 reads the 3D Δz (one more pointer);
    # the z rows then carry the tables alone
    d3 = partial_cells(grid)
    ys = kernel_y_rows(grid, model.coriolis)
    zs = partial_cell_z_rows(grid, tables) if d3 else z_rows(grid, tables)
    yt = y_tables(grid) if ytables else None
    # the conditional fluxes' clear flags, by location
    locs = _mask_locs(model)
    flags = {loc: clear_flags(grid, loc, (ts if loc == CENTER else sch).buffer)
             if loc in locs else None for loc in (CENTER, U_LOC, V_LOC)}
    # the closure's coefficients by field: ν and νz for u and v, κ and κz
    # of each tracer
    cl = kernel_closure(model)
    kh, kv = (ctypes.c_double * MAX_FIELDS)(), (ctypes.c_double * MAX_FIELDS)()
    if cl is not None:
        nu_z = cl.nu_z if cl.nu_z is not None else cl.nu
        for i, n in enumerate(names):
            kh[i], kv[i] = ((cl.nu, nu_z) if i < 2
                            else (cl.kappa_for(n), cl.kappa_z_for(n)))
    closure = 0 if cl is None else (1 if cl.vertically_implicit else 2)
    out_g = [torch.empty(grid.total_shape, dtype=dtype, device=device)
             for _ in names]
    if advance is None:
        out_psi, gp, c1, c2, dt = [], [], 0.0, 0.0, 0.0
    else:
        dt, euler = advance
        c1, c2 = ab2_coefficients(model.ab2_chi, euler)
        gp = [state["G_prev"][n] for n in names]
        for n, g in zip(names, gp):
            check_tensor(f"G_prev[{n!r}]", g, grid.total_shape, dtype, device)
        out_psi = [torch.empty_like(g) for g in out_g]
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = kernel_fn("fused_hydrostatic_tendencies",
                   "fused_hydrostatic_tendencies" + ("_dz3" if d3 else ""),
                   dtype, [ctypes.c_void_p] * 14 + [ctypes.c_int] * 30
                   + [ctypes.c_double] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * d3)
    launch("fused_hydrostatic_tendencies", fn, device, pointers(fields),
           ptr(w), ptr(ph), ptr(ys), ptr(zs), ptr(yt),
           *(ptr(flags[loc]) for loc in (CENTER, U_LOC, V_LOC)),
           pointers(gp) if gp else None, pointers(out_g),
           pointers(out_psi) if out_psi else None, kh, kv,
           len(names), *grid.shape, *grid.halo,
           _momentum_code(sch), mom_code, tr, _coriolis_code(model.coriolis),
           int(tables), int(ytables), closure, int(advance is not None),
           *bounds, mom_eps, tr_eps, c1, c2, float(dt), tracer_bounds, pw,
           *(int(grid.topology[a] is FLAT) for a in (0, 1)),
           *((ptr(dz3_pack(grid)),) if d3 else ()))
    fused_hydrostatic_tendencies.launches += 1
    G = dict(zip(names, out_g))
    if advance is None:
        return G
    return dict(zip(names, out_psi)), G


def fused_hydrostatic_tendencies(model, state, advance=None):
    """The hydrostatic tendencies of every prognostic field → G (with-halo
    tensors valid on the interior) or, with ``advance=(dt, euler)``,
    ``(psi_new, G)`` with ψ′ = ψ + Δt(c₁G − c₂G⁻). ``state`` carries the
    filled solution, ``w``, ``pHY`` (with buoyancy) and, to advance,
    ``G_prev``. CUDA tensors go through K4b (a failure raises; nothing
    falls back), CPU tensors through
    ``fused_hydrostatic_tendencies_reference``. The model passes
    ``unsupported_reason``, as its constructor checks on the card."""
    device = state["solution"]["u"].device
    if device.type == "cuda":
        return _launch_tendencies(model, state, advance)
    if device.type != "cpu":
        raise ValueError(f"no fused_hydrostatic_tendencies for {device.type} "
                         "tensors")
    return fused_hydrostatic_tendencies_reference(model, state, advance)


#: kernel launches since the last reset (the plain version adds nothing)
fused_hydrostatic_tendencies.launches = 0
