"""The split-explicit barotropic substeps: kernel K5 and its plain version.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_barotropic.py``
(Pallas ``fused_substep_eta``, all N substeps in one VMEM-resident
call). Each substep of the loop (Oceananigans'
split_explicit_free_surface_kernels.jl):

1. fill η's halos;
2. U += Δτ(−g Hᶠᶜ δxη/Δx + Gᵁ), V likewise;
3. fill U's and V's halos;
4. η −= Δτ(δx(Δy U) + δy(Δx V))/Az;
5. η̅ += w_f[i] η, U̅ += w_v[i] U, V̅ += w_v[i] V;

and η̅ is filled at the end. ``fused_substep_eta_reference`` is that
loop in plain PyTorch, the JAX ``SplitExplicitFreeSurface.substep_eta``
loop (free_surface.py:357-380) on (X, Y, 1) tensors.

``fused_substep_eta`` is the wrapper: on CPU tensors it runs the plain
version, on CUDA tensors the hand-written kernel
``csrc/fused_substep_eta.cu`` (or raises): one cooperative launch runs
all n substeps (the column depths read as (X, Y) planes, which vary in
x over an immersed bottom; on a Flat x or y the neighbour along it is
the point itself), a grid-wide barrier between the U, V half and
the η half of each, every with-halo (x, y) point taking its halo value
through the fill rule of its location (a periodic wrap, the zero-gradient
mirror, or the impenetrable wall's zero face and negated mirror), so no
separate fill runs. η̅'s halos accumulate the same sums as their mirror points,
which is what the final fill writes. The wrapper allocates the three
outputs and one block of six scratch arrays and launches; it counts its
launches in ``fused_substep_eta.launches``. ``cooperative_grid`` reports
the grid a launch takes.

On a shard of a grid cut over a mesh (``parallel/decomposition.py``) a
cut axis' halos are the neighbouring shards' strips, so one launch cannot
run the substeps: ``cut_sequence`` runs each substep in the plain
version's order, K5's cut form (two launches of the same source, one a
half-substep, that write interior points only) between the halo fills of
``ops/fused_fill.py::fused_fill_halos`` (K6 and the neighbour exchange,
with the physical side's fill on the end shards of a bounded global
axis). Every halo point the fills write is written by them from interior
values, x then y as in the plain version, so the corners come out as
there; the averages take U and V after their fill, halos included, and η̅
is filled at the end. That is 2n K5 and 2n + 1 fills a call; the cut
form's launches are counted in ``fused_substep_eta.launches`` and, apart,
in ``fused_substep_eta.cut_launches``. ``substep_uv_interior_reference``
and ``substep_eta_interior_reference`` are the halves' plain mirrors,
which write what the kernel writes.
"""
from __future__ import annotations

import ctypes

import torch

from ..boundary_conditions.bcs import default_bcs, fill_halos
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..models.free_surface import ETA_LOC
from ..utils.location import CENTER, U_LOC, V_LOC
from . import _build
from . import stencil as st
from .fused_fill import cut_axes, fields_unsupported_reason, fused_fill_halos
from .fused_tendencies import check_tensor, kernel_fn, launch
from .metric_rows import y_row


def fused_substep_eta_reference(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf,
                                g, dtau, wv, wf, n):
    """The plain-PyTorch version of K5 → (η̅ filled, U̅, V̅). Writes into
    none of its arguments."""
    dxu, dyv = grid.dx(U_LOC), grid.dy(V_LOC)
    dyu, dxv = grid.dy(U_LOC), grid.dx(V_LOC)
    az = grid.Az(CENTER)
    eta, U, V = eta0.clone(), U0, V0
    eta_av, U_av, V_av = (torch.zeros_like(a) for a in (eta0, U0, V0))
    for i in range(n):
        fill_halos(eta, grid, ETA_LOC, eta_bcs, axes=(0, 1))
        U = U + dtau * (-g * Hfc * st.dxf(eta) / dxu + GU)
        V = V + dtau * (-g * Hcf * st.dyf(eta) / dyv + GV)
        fill_halos(U, grid, U_LOC, None, axes=(0, 1))
        fill_halos(V, grid, V_LOC, None, axes=(0, 1))
        eta = eta - dtau * (st.dxc(dyu * U) + st.dyc(dxv * V)) / az
        eta_av = eta_av + wf[i] * eta
        U_av = U_av + wv[i] * U
        V_av = V_av + wv[i] * V
    fill_halos(eta_av, grid, ETA_LOC, eta_bcs, axes=(0, 1))
    return eta_av, U_av, V_av


def unsupported_reason(grid, eta_bcs):
    """Why K5 cannot run on ``grid`` with ``eta_bcs``, or None: it needs
    x-constant metrics (a regular x axis). Its cooperative form needs η
    walls that fill by the zero-gradient mirror and at least H+1 cells on
    a bounded axis (so no mirror index is clamped); it takes a Flat x, a
    Flat y or both (the JAX kernel's gate refuses them). On a shard of a
    grid cut over a mesh the cut form runs, whose fills are K6's: it takes
    what K6 takes of η, U and V."""
    if not grid.x_regular:
        return "K5 takes a regular x axis (x-constant metrics)"
    if cut_axes(grid):
        shape = grid.total_shape[:2] + (1,)
        return fields_unsupported_reason(grid, [(ETA_LOC, eta_bcs, (0, 1), shape),
                                                (U_LOC, None, (0, 1), shape),
                                                (V_LOC, None, (0, 1), shape)])
    bcs = eta_bcs if eta_bcs is not None else default_bcs(grid, ETA_LOC)
    for axis, _side, bc in bcs.sides():
        if axis < 2 and grid.topology[axis] is BOUNDED:
            if bc is not None and not (bc.kind == "flux" and bc.value is None):
                return f"K5 takes zero-gradient η walls, not {bc}"
            if grid.shape[axis] < grid.halo[axis] + 1:
                return "K5 takes at least H+1 cells on a bounded axis"
        if axis < 2 and grid.topology[axis] not in (BOUNDED, PERIODIC, FLAT):
            return (f"K5 takes periodic, bounded, Flat or cut x and y, not "
                    f"{grid.topology[axis]!r} without a mesh: {grid}")
    return None


def depth_inputs(grid, Hfc, Hcf):
    """What K5 reads of the metrics and the column depths: the (5, Y)
    x-constant metric rows (dxu, dyv, dyu, dxv, az), built once per grid,
    and the with-halo (X, Y) depth planes of Hᶠᶜ and Hᶜᶠ (which vary in x
    over an immersed bottom), made contiguous once for the depth tensors
    last given (``column_depths`` returns the same ones)."""
    rows = grid._cache.get("substep_eta_rows")
    if rows is None:
        rows = grid._cache["substep_eta_rows"] = torch.stack([
            y_row(grid, m) for m in (grid.dx(U_LOC), grid.dy(V_LOC),
                                     grid.dy(U_LOC), grid.dx(V_LOC),
                                     grid.Az(CENTER))]).contiguous()
    last = grid._cache.get("substep_eta_depths")
    if last is None or last[0] is not Hfc or last[1] is not Hcf:
        last = grid._cache["substep_eta_depths"] = (
            Hfc, Hcf, (Hfc[:, :, 0].contiguous(), Hcf[:, :, 0].contiguous()))
    return rows, last[2]


def _launch(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau, wv, wf, n):
    device, dtype = eta0.device, grid.dtype
    shape = grid.total_shape[:2] + (1,)
    for name, a in (("eta0", eta0), ("U0", U0), ("V0", V0), ("GU", GU),
                    ("GV", GV)):
        check_tensor(name, a, shape, dtype, device)
    for name, a in (("wv", wv), ("wf", wf)):
        check_tensor(name, a, (n,), dtype, device)
    rows, (hfc, hcf) = depth_inputs(grid, Hfc, Hcf)
    out = [torch.empty(shape, dtype=dtype, device=device) for _ in range(3)]
    # η, U and V twice each: a halo point reads its mirror's old value
    buf = torch.empty((6,) + shape, dtype=dtype, device=device)
    fn = kernel_fn("fused_substep_eta", "fused_substep_eta", dtype,
                   [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                   + [ctypes.c_double] * 2)
    launch("fused_substep_eta", fn, device, rows.data_ptr(), hfc.data_ptr(),
           hcf.data_ptr(),
           *[t.data_ptr() for t in (eta0, U0, V0, GU, GV, wv, wf, buf, *out)],
           n, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
           int(grid.topology[0] is BOUNDED), int(grid.topology[1] is BOUNDED),
           float(g), float(dtau))
    fused_substep_eta.launches += 1
    return tuple(out)


def _interior(grid):
    """The interior (x, y) points of a with-halo (X, Y, 1) array."""
    return (slice(grid.Hx, grid.Hx + grid.Nx), slice(grid.Hy, grid.Hy + grid.Ny))


def substep_uv_interior_reference(grid, eta, U_in, V_in, GU, GV, Hfc, Hcf, g,
                                  dtau, U, V):
    """The plain mirror of the cut form's first half: U′ = U + Δτ(−g Hᶠᶜ
    δxη/Δx + Gᵁ) and V′ likewise, the plain version's expressions, written
    into ``U`` and ``V`` on the interior points only."""
    sl = _interior(grid)
    Un = U_in + dtau * (-g * Hfc * st.dxf(eta) / grid.dx(U_LOC) + GU)
    Vn = V_in + dtau * (-g * Hcf * st.dyf(eta) / grid.dy(V_LOC) + GV)
    U[sl] = Un[sl]
    V[sl] = Vn[sl]


def substep_eta_interior_reference(grid, U, V, wv, wf, i, eta, eta_av, U_av,
                                   V_av, dtau):
    """The plain mirror of the cut form's second half: U̅ += w_v[i] U and
    V̅ += w_v[i] V on every with-halo point (U and V filled), then on the
    interior points η′ = η − Δτ(δx(Δy U) + δy(Δx V))/Az written into
    ``eta`` and η̅ += w_f[i] η′; the averages start from zeros at i = 0."""
    sl = _interior(grid)
    start = lambda a: torch.zeros_like(a) if i == 0 else a
    U_av.copy_(start(U_av) + wv[i] * U)
    V_av.copy_(start(V_av) + wv[i] * V)
    dyu, dxv = grid.dy(U_LOC), grid.dx(V_LOC)
    en = eta - dtau * (st.dxc(dyu * U) + st.dyc(dxv * V)) / grid.Az(CENTER)
    eta[sl] = en[sl]
    eta_av[sl] = (start(eta_av) + wf[i] * en)[sl]


def cut_sequence(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau, wv,
                 wf, n, half_uv, half_eta, fill=None):
    """The substeps on a shard of a cut grid → (η̅ filled, U̅, V̅): per
    substep the fill of η (``fill``, by default ``fused_fill_halos``: K6
    and the exchange), ``half_uv`` (U′, V′ on the interior), one fill of
    U′ and V′, then ``half_eta`` (the averages, η′ on the interior); η̅
    filled at the end. ``half_uv`` and ``half_eta`` take the arguments of
    ``substep_uv_interior_reference`` and
    ``substep_eta_interior_reference``. Writes into none of its arguments;
    the work arrays start uninitialised (``torch.empty``), as only the
    points the halves and the fills write are read."""
    fill = fill or fused_fill_halos
    eta = eta0.clone()
    empty = lambda: torch.empty_like(eta0)
    U, V, eta_av, U_av, V_av = (empty() for _ in range(5))
    for i in range(n):
        fill(grid, [(eta, ETA_LOC, eta_bcs, (0, 1), 0.0)])
        half_uv(grid, eta, U0 if i == 0 else U, V0 if i == 0 else V, GU, GV,
                Hfc, Hcf, g, dtau, U, V)
        fill(grid, [(U, U_LOC, None, (0, 1), 0.0), (V, V_LOC, None, (0, 1), 0.0)])
        half_eta(grid, U, V, wv, wf, i, eta, eta_av, U_av, V_av, dtau)
    fill(grid, [(eta_av, ETA_LOC, eta_bcs, (0, 1), 0.0)])
    return eta_av, U_av, V_av


def _cut_fn(dtype):
    return kernel_fn("fused_substep_eta", "fused_substep_cut", dtype,
                     [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                     + [ctypes.c_double] * 2)


def _launch_cut_half(half, grid, *, rows, hfc, hcf, device, GU=None, GV=None,
                     U_in=None, V_in=None, wv=None, wf=None, eta=None, U=None,
                     V=None, eta_av=None, U_av=None, V_av=None, i=0, g=0.0,
                     dtau=0.0):
    ptr = lambda t: None if t is None else t.data_ptr()
    launch("fused_substep_eta", _cut_fn(grid.dtype), device, half, ptr(rows),
           ptr(hfc), ptr(hcf), ptr(GU), ptr(GV), ptr(U_in), ptr(V_in), ptr(wv),
           ptr(wf), ptr(eta), ptr(U), ptr(V), ptr(eta_av), ptr(U_av), ptr(V_av),
           i, grid.Nx, grid.Ny, grid.Hx, grid.Hy, float(g), float(dtau))
    fused_substep_eta.launches += 1
    fused_substep_eta.cut_launches += 1


def cut_kernel_halves(grid, Hfc, Hcf):
    """K5's cut form's two halves on ``grid`` as launches, each taking the
    arguments of its plain mirror (``substep_uv_interior_reference``,
    ``substep_eta_interior_reference``): ``(half_uv, half_eta)``."""
    rows, (hfc, hcf) = depth_inputs(grid, Hfc, Hcf)
    common = dict(rows=rows, hfc=hfc, hcf=hcf, device=hfc.device)

    def half_uv(grid, eta, U_in, V_in, GU, GV, _Hfc, _Hcf, g, dtau, U, V):
        _launch_cut_half(0, grid, GU=GU, GV=GV, U_in=U_in, V_in=V_in, eta=eta,
                         U=U, V=V, g=g, dtau=dtau, **common)

    def half_eta(grid, U, V, wv, wf, i, eta, eta_av, U_av, V_av, dtau):
        _launch_cut_half(1, grid, wv=wv, wf=wf, eta=eta, U=U, V=V, eta_av=eta_av,
                         U_av=U_av, V_av=V_av, i=i, dtau=dtau, **common)

    return half_uv, half_eta


def _launch_cut(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau, wv, wf, n):
    device, dtype = eta0.device, grid.dtype
    shape = grid.total_shape[:2] + (1,)
    for name, a in (("eta0", eta0), ("U0", U0), ("V0", V0), ("GU", GU),
                    ("GV", GV)):
        check_tensor(name, a, shape, dtype, device)
    for name, a in (("wv", wv), ("wf", wf)):
        check_tensor(name, a, (n,), dtype, device)
    return cut_sequence(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau,
                        wv, wf, n, *cut_kernel_halves(grid, Hfc, Hcf))


def fused_substep_eta(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau,
                      wv, wf, n):
    """All ``n`` barotropic substeps → (η̅ filled, U̅, V̅), with-halo
    (X, Y, 1) tensors. CUDA tensors go through the hand-written kernel K5
    (its cooperative form, or on a shard of a cut grid its cut form between
    the fills of ``cut_sequence``; a failure raises, nothing falls back),
    CPU tensors through
    ``fused_substep_eta_reference``. The grid and ``eta_bcs`` pass
    ``unsupported_reason``, as the model's constructor checks on the card."""
    if eta0.device.type == "cuda":
        launcher = _launch_cut if cut_axes(grid) else _launch
        return launcher(grid, eta_bcs, eta0, U0, V0, GU, GV, Hfc, Hcf, g, dtau,
                        wv, wf, n)
    if eta0.device.type != "cpu":
        raise ValueError(f"no fused_substep_eta for {eta0.device.type} tensors")
    return fused_substep_eta_reference(grid, eta_bcs, eta0, U0, V0, GU, GV,
                                       Hfc, Hcf, g, dtau, wv, wf, n)


#: kernel launches since the last reset (the plain version adds nothing),
#: and of them the cut form's
fused_substep_eta.launches = 0
fused_substep_eta.cut_launches = 0


def cooperative_grid(grid):
    """The cooperative grid K5 takes on the current CUDA device for
    ``grid``'s (x, y) points: blocks, threads a block, blocks an SM, the
    points a thread keeps in shared memory, rows of threads (the grid
    stride over x), shared memory a block, and the registers and spilled
    bytes a thread has (as ptxas allocated them)."""
    out = (ctypes.c_int * 8)()
    fn = getattr(_build.load("fused_substep_eta"), "fused_substep_eta_config"
                 + ("_f32" if grid.dtype == torch.float32 else "_f64"))
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(grid.Nx, grid.Ny, grid.Hx, grid.Hy, out)
    if rc != 0:
        raise RuntimeError(f"fused_substep_eta config failed: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "blocks_per_sm", "points_kept",
                     "thread_rows", "smem_bytes", "registers", "local_bytes"), out))
