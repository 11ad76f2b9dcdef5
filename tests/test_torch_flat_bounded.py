"""Port parity: Flat axes and bounded x and y in the nonhydrostatic model.

The JAX side is the plain path (``fused_advection=False``), in float64 on
grids of 32 points or fewer an axis. On the six topologies of the card's
holds, (Periodic, Flat, Bounded), (Bounded, Flat, Bounded), (Periodic,
Periodic, Flat), (Flat, Flat, Bounded), (Flat, Periodic, Bounded),
(Periodic, Bounded, Bounded) and (Bounded, Bounded, Bounded):

- K2's plain version against the JAX ``div_*`` fluxes, bit for bit on the
  interior and on each bounded axis' velocity wall face (u's east, v's
  north, w's top: with-halo index h + n), with WENO5,
  ``UpwindBiasedFifthOrder`` and centred schemes;
- K3b's and K3c's plain versions against the JAX ``div_ccc`` and face
  gradients, bit for bit;
- the pressure solve (FFT on periodic axes, DCT-II on bounded ones,
  eigenvalue 0 on a Flat one) within 1e-12 of max|φ| (torch.fft and
  jnp.fft round differently);
- the gates: the AB2 branch and the ``G_prev`` layout the JAX model takes.

The eight configurations of the examples and validations that run on
these grids (``CONFIGS``, cut to 16 or fewer points an axis) take 10 RK3
steps, 10 quasi-AB2 steps on the port's default branch and 10 on its
general branch (``fused_advection=False``) against the JAX plain step;
u, v, w, the tracers, pHY′ and pNHS agree within ``RTOL = 1e-9`` of
max|field| (FFTs and the pHY′ cumulative sums round differently), and
their states pass through ``interop`` with the wall faces of a with-halo
``G_prev``. The user callables (BC values, background fields, drag) are
written twice, with ``jnp`` and with ``torch``.

Two Coriolis forms are new: ``ConstantCartesianCoriolis`` and
``NonTraditionalBetaPlane``, held term by term (``x_f_cross_U``,
``y_f_cross_U``, ``z_f_cross_U``) bit for bit.

The ``cuda`` cases hold K1, K2, K3b and K3c against their plain versions
on the card bit for bit over NaN-filled outputs, on every topology above
(``python -m pytest --noconftest -m cuda tests/test_torch_flat_bounded.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from clima_oceananigans_jl_torch.ops import stencil as tst

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.boundary_conditions.bcs import BC as JBC
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JBuoyancy
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.ops import operators as jop
    from clima_oceananigans_jl_tpu.ops import stencil as jst
    from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock
    from clima_oceananigans_jl_tpu.utils.location import U_LOC, V_LOC, W_LOC
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9

#: the topologies of the card's holds, and a small size on each
TOPOLOGIES = {"PFB": (13, 1, 11), "BFB": (12, 1, 9), "PPF": (14, 13, 1),
              "FFB": (1, 1, 20), "FPB": (1, 14, 11), "PBB": (10, 9, 8),
              "BBB": (9, 8, 7)}
NAMES = {"P": "periodic", "B": "bounded", "F": "flat"}


def topology(code):
    return tuple(NAMES[c] for c in code)


def grid_pair(code, size=None, halo=3, dtype=torch.float64, device=DEVICE):
    """The same grid in both packages (the JAX one None off JAX)."""
    size = size or TOPOLOGIES[code]
    kw = dict(size=size, x=(0.0, 1.3), y=(0.0, 0.7), z=(-0.9, 0.0),
              topology=topology(code), halo=(halo,) * 3)
    tg = T.RectilinearGrid(dtype=dtype, device=device, **kw)
    jg = J.RectilinearGrid(dtype=jnp.float64, **kw) if device == DEVICE else None
    return jg, tg


def wall_mask(grid, name):
    """The interior, and the wall face of velocity ``name`` on its bounded
    axis (with-halo index h + n over the interior of the other axes)."""
    mask = torch.zeros(grid.total_shape, dtype=torch.bool, device=grid.device)
    mask[grid.interior_slices] = True
    axis = {"u": 0, "v": 1, "w": 2}.get(name)
    if axis is not None and grid.topology[axis] is T.BOUNDED:
        sl = list(grid.interior_slices)
        sl[axis] = grid.halo[axis] + grid.shape[axis]
        mask[tuple(sl)] = True
    return mask


def random_fields(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


SCHEMES = {"weno5": ("WENO5", "WENO5"),
           "ub5": ("UpwindBiasedFifthOrder", "UpwindBiasedFifthOrder"),
           "centred": ("CenteredSecondOrder", "CenteredSecondOrder")}


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("code", list(TOPOLOGIES))
def test_k2_plain_version_matches_jax(code, scheme):
    """K2's plain version is the JAX plain fluxes bit for bit, on the
    interior and on the velocities' wall faces."""
    jg, tg = grid_pair(code)
    u, v, w, c = random_fields(tg.total_shape, 4, seed=1)
    js, ts = (getattr(P, SCHEMES[scheme][0])() for P in (J, T))
    ref = dict(u=-jfl.div_vu(jg, js, *map(jnp.asarray, (u, v, w))),
               v=-jfl.div_vv(jg, js, *map(jnp.asarray, (u, v, w))),
               w=-jfl.div_vw(jg, js, *map(jnp.asarray, (u, v, w))),
               c=-jfl.div_Uc(jg, js, *map(jnp.asarray, (u, v, w, c))))
    got = tft.fused_advective_tendencies_reference(
        tg, ts, ts, *map(torch.as_tensor, (u, v, w)), {"c": torch.as_tensor(c)})
    for name, r in ref.items():
        mask = wall_mask(tg, name).numpy()
        assert np.array_equal(np.asarray(r)[mask], got[name].numpy()[mask]), name


@pytest.mark.parametrize("code", list(TOPOLOGIES))
def test_projection_stencils_and_solve_match_jax(code):
    """K3b's and K3c's plain versions are the JAX divergence and face
    gradients bit for bit; the pressure solve agrees within 1e-12."""
    jg, tg = grid_pair(code)
    u, v, w, p = random_fields(tg.total_shape, 4, seed=2)
    div = tft.fused_divergence_reference(tg, *map(torch.as_tensor, (u, v, w)))
    jdiv = jg.interior(jop.div_ccc(*map(jnp.asarray, (u, v, w)), jg))
    assert np.array_equal(np.asarray(jdiv), div.numpy())
    pj = jnp.asarray(p)
    ref = (jst.dxf(pj) / jg.dx(U_LOC), jst.dyf(pj) / jg.dy(V_LOC),
           jst.dzf(pj) / jg.dz(W_LOC))
    for r, g in zip(ref, tft.fused_pressure_gradient_reference(tg, torch.as_tensor(p))):
        assert np.array_equal(np.asarray(jg.interior(r)), tg.interior(g).numpy())
    rhs = div - div.mean()
    phi = T.NonhydrostaticModel(tg).pressure_solver.solve(rhs)
    jphi = JN(jg, fused_advection=False).pressure_solver.solve(jnp.asarray(rhs.numpy()))
    err = np.abs(np.asarray(jphi) - phi.numpy()).max()
    assert err <= 1e-12 * np.abs(np.asarray(jphi)).max(), err


@pytest.mark.parametrize("code", list(TOPOLOGIES))
def test_gates_match_jax(code):
    """The AB2 branch and ``G_prev``'s layout are the JAX model's own with
    its fused advection asked for: a bounded x or y, or a Flat y, keep
    the step on the general branch."""
    jg, tg = grid_pair(code)
    jm = JN(jg, advection=J.WENO5(), fused_advection=True)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5())
    assert tm.fused_step == jm.fused_step
    assert tm.g_interior == jm.g_interior
    assert tft.supports_fused_advection(tm.grid) == J.ops.fused_tendencies.supports_fused_advection(jm.grid)


@pytest.mark.parametrize("code", list(TOPOLOGIES))
def test_fill_groups_pass_k6_gate(code):
    """K6 takes the nonhydrostatic fill groups on these grids: horizontal
    convection's callable top value, value and open walls included."""
    _, tg = grid_pair(code)
    b_top = T.ValueBC(lambda x, y, t: torch.cos(x + y))
    model = T.NonhydrostaticModel(
        tg, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
        boundary_conditions={"b": T.FieldBCs(top=b_top),
                             "w": T.FieldBCs(top=T.FluxBC())})
    assert model._fill_unsupported_reason() is None


def test_kernel_order_moves_a_flat_axis_to_y():
    """The kernels' axis order keeps every offset: only an axis of extent
    1 moves."""
    for code, order in (("PPB", (0, 1, 2)), ("PFB", (0, 1, 2)), ("PPF", (0, 2, 1)),
                        ("FPB", (1, 0, 2)), ("FFB", (1, 0, 2)), ("PFF", (2, 1, 0))):
        size = tuple(1 if c == "F" else 5 for c in code)
        _, tg = grid_pair(code, size)
        assert tft.kernel_order(tg) == order
        shape = tg.total_shape
        a = torch.arange(int(np.prod(shape))).reshape(shape)
        assert torch.equal(a.permute(order).contiguous().flatten(), a.flatten())
    with pytest.raises(ValueError):
        tft.kernel_order(grid_pair("FFF", (1, 1, 1))[1])


# -- the Coriolis forms ---------------------------------------------------------------

CORIOLIS = {
    "ConstantCartesianCoriolis": dict(fx=3e-5, fy=-2e-5, fz=1e-4),
    "NonTraditionalBetaPlane": dict(fz0=1e-4, fy0=5e-5, beta=2e-3, gamma=-1e-3),
}


@pytest.mark.parametrize("term", ["x_f_cross_U", "y_f_cross_U", "z_f_cross_U"])
@pytest.mark.parametrize("form", list(CORIOLIS))
def test_coriolis_forms_match_jax_term_by_term(form, term):
    jg, tg = grid_pair("PBB")
    u, v, w = random_fields(tg.total_shape, 3, seed=3)
    ref = getattr(getattr(J, form)(**CORIOLIS[form]), term)(jg, *map(jnp.asarray, (u, v, w)))
    got = getattr(getattr(T, form)(**CORIOLIS[form]), term)(tg, *map(torch.as_tensor, (u, v, w)))
    mask = tg.interior_slices
    assert np.array_equal(np.asarray(ref)[mask], got.numpy()[mask])


# -- the configurations ----------------------------------------------------------------

class Lib:
    """The names a configuration needs from one package."""

    def __init__(self, jax_side, device=DEVICE, dtype=None):
        self.jax, self.device = jax_side, device
        self.P = J if jax_side else T
        self.np = jnp if jax_side else torch
        self.st = jst if jax_side else tst
        self.dtype = dtype or (jnp.float64 if jax_side else torch.float64)
        self.BC = JBC if jax_side else T.BC
        self.Buoyancy = JBuoyancy if jax_side else T.BuoyancyTracer
        self.Model = JN if jax_side else T.NonhydrostaticModel

    def grid(self, size, topo, **axes):
        kw = dict(size=size, topology=topology(topo), dtype=self.dtype, **axes)
        if not self.jax:
            kw["device"] = self.device
        return self.P.RectilinearGrid(**kw)

    def model(self, grid, fused_advection="auto", **kw):
        if self.jax:
            fused_advection = False
        return self.Model(grid, fused_advection=fused_advection, **kw)


def horizontal_convection(L, size=(16, 1, 8), timestepper="RungeKutta3", **kw):
    """examples/horizontal_convection.py: Ra = 1e8, Pr = 1, the callable
    top ValueBC b = −b* cos(2πx/Lx), WENO5, ScalarDiffusivity(ν, κ)."""
    Lx, b_star = 2.0, 1.0
    nu = np.sqrt(b_star * Lx ** 3 / 1e8)
    xp = L.np
    b_top = L.P.ValueBC(lambda x, y, t: -b_star * xp.cos(2 * np.pi * x / Lx))
    return L.model(L.grid(size, "BFB", x=(-1.0, 1.0), y=(0, 1), z=(-1.0, 0.0)),
                   advection=L.P.WENO5(), timestepper=timestepper,
                   buoyancy=L.Buoyancy(), closure=L.P.ScalarDiffusivity(nu=nu, kappa=nu),
                   boundary_conditions={"b": L.P.FieldBCs(top=b_top)}, **kw)


def two_dimensional_turbulence(L, size=(16, 16, 1), timestepper="RungeKutta3", **kw):
    """examples/two_dimensional_turbulence.py: UB5, ScalarDiffusivity(1e-5)."""
    return L.model(L.grid(size, "PPF", x=(0, 2 * np.pi), y=(0, 2 * np.pi)),
                   timestepper=timestepper, advection=L.P.UpwindBiasedFifthOrder(),
                   closure=L.P.ScalarDiffusivity(nu=1e-5), **kw)


def kelvin_helmholtz(L, size=(16, 1, 16), timestepper="RungeKutta3", **kw):
    """examples/kelvin_helmholtz_instability.py: the background shear
    tanh(z) and stratification, UB5 (its background fields take the plain
    route, as in the JAX package)."""
    xp = L.np
    U = L.P.BackgroundField(lambda x, y, z, t: xp.tanh(z))
    B = L.P.BackgroundField(lambda x, y, z, t, p: p["h"] * p["Ri"] * xp.tanh(z / p["h"]),
                            parameters={"h": 1.0, "Ri": 0.1})
    return L.model(L.grid(size, "PFB", x=(-5, 5), y=(0, 1), z=(-5, 5)),
                   timestepper=timestepper, advection=L.P.UpwindBiasedFifthOrder(),
                   background_fields={"u": U, "b": B},
                   closure=L.P.ScalarDiffusivity(nu=2e-4, kappa=2e-4),
                   buoyancy=L.Buoyancy(), **kw)


def tilted_bottom_boundary_layer(L, size=(12, 1, 10), timestepper="RungeKutta3", **kw):
    """examples/tilted_bottom_boundary_layer.py: a bottom-refined
    stretched z, gravity and rotation tilted by 3°
    (ConstantCartesianCoriolis), the background stratification, UB5, the
    quadratic bottom drag as discrete flux BCs."""
    xp, st = L.np, L.st
    Lx, Lz, nz = 400.0, 100.0, size[2]
    k = np.arange(nz + 1)
    z_faces = Lz * (np.exp(2.5 * k / nz) - 1) / (np.exp(2.5) - 1)
    theta = np.radians(3.0)
    up = (np.sin(theta), 0.0, np.cos(theta))
    f0, N2, V_inf = 1e-4, 1e-5, 0.1
    cd = (0.4 / np.log(float(z_faces[1]) / 2 / 0.1)) ** 2
    B = L.P.BackgroundField(lambda x, y, z, t, p: p["N2"] * (x * p["sx"] + z * p["sz"]),
                            parameters={"N2": N2, "sx": up[0], "sz": up[2]})

    def drag_u(grid, t, fields):
        u, v = fields["u"], st.ixf(st.iyc(fields["v"]))
        return -cd * xp.sqrt(u ** 2 + (v + V_inf) ** 2) * u

    def drag_v(grid, t, fields):
        v, u = fields["v"], st.ixc(st.iyf(fields["u"]))
        return -cd * xp.sqrt(u ** 2 + (v + V_inf) ** 2) * (v + V_inf)

    return L.model(
        L.grid(size, "PFB", x=(0, Lx), y=(0, 1), z=z_faces),
        buoyancy=L.Buoyancy(gravity_unit_vector=(-up[0], -up[1], -up[2])),
        coriolis=L.P.ConstantCartesianCoriolis(fx=f0 * up[0], fy=0.0, fz=f0 * up[2]),
        advection=L.P.UpwindBiasedFifthOrder(), timestepper=timestepper,
        closure=L.P.ScalarDiffusivity(nu=1e-4, kappa=1e-4), background_fields={"b": B},
        boundary_conditions={"u": L.P.FieldBCs(bottom=L.BC("flux", drag_u, discrete=True)),
                             "v": L.P.FieldBCs(bottom=L.BC("flux", drag_v, discrete=True))},
        **kw)


def one_dimensional_diffusion(L, size=(1, 1, 16), timestepper="QuasiAdamsBashforth2", **kw):
    """examples/one_dimensional_diffusion.py: κ = 1 on (Flat, Flat,
    Bounded), centred advection."""
    return L.model(L.grid(size, "FFB", z=(-0.5, 0.5)), timestepper=timestepper,
                   closure=L.P.ScalarDiffusivity(kappa=1.0), tracers=("T",), **kw)


def thermal_bubble(L, size=(16, 1, 16), timestepper="RungeKutta3", **kw):
    """validation/thermal_bubble.py: WENO5, a buoyancy tracer,
    ScalarDiffusivity(1e-2)."""
    return L.model(L.grid(size, "PFB", x=(0, 1000.0), y=(0, 1), z=(0, 1000.0)),
                   advection=L.P.WENO5(), tracers=("b",), buoyancy=L.Buoyancy(),
                   closure=L.P.ScalarDiffusivity(nu=1e-2, kappa=1e-2),
                   timestepper=timestepper, **kw)


def lid_driven_cavity(L, size=(16, 1, 16), timestepper="RungeKutta3", **kw):
    """validation/lid_driven_cavity.py: Re = 100, the moving lid u = 1,
    no slip elsewhere, WENO5."""
    F = L.P.FieldBCs
    return L.model(L.grid(size, "BFB", x=(0.0, 1.0), y=(0.0, 1.0), z=(0.0, 1.0)),
                   advection=L.P.WENO5(), closure=L.P.ScalarDiffusivity(nu=1e-2),
                   timestepper=timestepper,
                   boundary_conditions={
                       "u": F(top=L.P.ValueBC(1.0), bottom=L.P.ValueBC(0.0)),
                       "w": F(west=L.P.ValueBC(0.0), east=L.P.ValueBC(0.0))}, **kw)


def stratified_couette_flow(L, size=(4, 1, 16), timestepper="QuasiAdamsBashforth2", **kw):
    """validation/stratified_couette_flow.py: walls moving at ±U and held
    at ±B, a vertically implicit ScalarDiffusivity, no advection scheme
    (centred)."""
    F, V = L.P.FieldBCs, L.P.ValueBC
    return L.model(L.grid(size, "PFB", x=(0, 1), y=(0, 1), z=(-1.0, 1.0)),
                   tracers=("b",), buoyancy=L.Buoyancy(), advection=None,
                   closure=L.P.ScalarDiffusivity(nu=1e-2, kappa=1e-2,
                                                 time_discretization="vertically_implicit"),
                   timestepper=timestepper,
                   boundary_conditions={"u": F(top=V(1.0), bottom=V(-1.0)),
                                        "b": F(top=V(1e-4), bottom=V(-1e-4))}, **kw)


#: (builder, Δt, initial fields and their amplitude); the three with
#: ``UpwindBiasedFifthOrder`` are stepped in ``test_torch_upwind5.py``
CONFIGS = {
    "horizontal_convection": (horizontal_convection, 1e-2, {"u": 1e-3, "w": 1e-3, "b": 1e-3}),
    "two_dimensional_turbulence": (two_dimensional_turbulence, 0.05, {"u": 0.3, "v": 0.3}),
    "kelvin_helmholtz_instability": (kelvin_helmholtz, 0.05, {"u": 1e-3, "w": 1e-3}),
    "tilted_bottom_boundary_layer": (tilted_bottom_boundary_layer, 20.0, {"u": 1e-3, "v": 1e-3}),
    "one_dimensional_diffusion": (one_dimensional_diffusion, 1e-4, {"T": 1.0}),
    "thermal_bubble": (thermal_bubble, 1.0, {"b": 1e-2, "u": 1e-3}),
    "lid_driven_cavity": (lid_driven_cavity, 5e-3, {"w": 1e-3}),
    "stratified_couette_flow": (stratified_couette_flow, 0.5, {"b": 1e-5}),
}


def initial_values(model, amplitudes, seed=0):
    rng = np.random.default_rng(seed)
    return {n: a * rng.standard_normal(model.grid.shape) for n, a in amplitudes.items()}


def compare(jstate, tstate, what):
    """Fields, pHY′ and pNHS within RTOL of max|field| (pNHS of
    max(|pNHS|, |pHY′|))."""
    tg_int = lambda a: a
    for name, ref in jstate["solution"].items():
        ref = np.asarray(ref)
        got = tstate["solution"][name].numpy()
        assert ref.shape == got.shape, (what, name)
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(ref - got).max() <= RTOL * scale, (what, name, np.abs(ref - got).max(), scale)
    scale = max(np.abs(np.asarray(jstate["pNHS"])).max(),
                np.abs(np.asarray(jstate.get("pHY", 0.0))).max(), 1e-300)
    for key in ("pHY", "pNHS"):
        if key in jstate:
            err = np.abs(np.asarray(jstate[key]) - tstate[key].numpy()).max()
            assert err <= RTOL * scale, (what, key, err, scale)


def run_pair(config, timestepper, fused_advection="auto", steps=10):
    build, dt, amps = CONFIGS[config]
    jm = build(Lib(True), timestepper=timestepper)
    tm = build(Lib(False), timestepper=timestepper, fused_advection=fused_advection)
    vals = initial_values(tm, amps)
    js = jm.initial_state(**{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tm.initial_state(**vals)
    for _ in range(steps):
        js, ts = jm.step(js, dt), tm.step(ts, dt)
    return jm, tm, js, ts


UB5_CONFIGS = ("two_dimensional_turbulence", "kelvin_helmholtz_instability",
               "tilted_bottom_boundary_layer")


@pytest.mark.parametrize("branch", ["RK3", "AB2", "AB2 general"])
@pytest.mark.parametrize("config", [c for c in CONFIGS if c not in UB5_CONFIGS])
def test_configuration_matches_jax_over_ten_steps(config, branch):
    check_configuration(config, branch)


def check_configuration(config, branch):
    """10 steps of ``config`` on ``branch`` against the JAX plain step."""
    timestepper = "RungeKutta3" if branch == "RK3" else "QuasiAdamsBashforth2"
    jm, tm, js, ts = run_pair(config, timestepper,
                              False if branch == "AB2 general" else "auto")
    if branch == "AB2 general":
        assert not tm.fused_step
    compare(js, ts, (config, branch))


@pytest.mark.parametrize("config", ["horizontal_convection", "two_dimensional_turbulence",
                                    "lid_driven_cavity", "one_dimensional_diffusion"])
def test_state_passes_through_interop(config):
    """A JAX state into the port and back: the port steps from it as from
    its own (``G_prev`` with halos keeps its wall faces)."""
    build, dt, amps = CONFIGS[config]
    jm, tm, js, ts = run_pair(config, "QuasiAdamsBashforth2", steps=2)
    back = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    for name, g in ts["G_prev"].items():
        ref = np.asarray(js["G_prev"][name])
        mask = wall_mask(tm.grid, name).numpy() if g.shape != tm.grid.shape else Ellipsis
        got = back["G_prev"][name].numpy()
        assert np.abs(ref[mask] - got[mask]).max() <= RTOL * max(np.abs(ref[mask]).max(), 1e-300)
    a, b = tm.step(ts, dt), tm.step(back, dt)
    for name in a["solution"]:
        x, y = a["solution"][name].numpy(), b["solution"][name].numpy()
        assert np.abs(x - y).max() <= RTOL * max(np.abs(x).max(), 1e-300), name
    ns = state_to_numpy(ts)
    js2 = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in ns.items() if k != "clock"})
    js2["clock"] = JClock(jnp.asarray(ns["clock"].time), jnp.asarray(ns["clock"].iteration))
    compare(jm.step(js2, dt), a, (config, "interop"))


def test_what_stays_out_is_refused_by_name():
    """An advection scheme that is none of the JAX package's eight is
    refused by name; a grid with every axis Flat has nothing to step."""
    _, tg = grid_pair("PPB", (6, 5, 4))
    for scheme in ("CenteredFourthOrder", "UpwindBiasedThirdOrder",
                   "UpwindBiasedFirstOrder", "PositiveWENO5", "BoundsPreservingWENO5"):
        fake = type(scheme, (T.CenteredSecondOrder,), {})
        with pytest.raises(NotImplementedError, match=f"{scheme} advection is not ported"):
            T.NonhydrostaticModel(tg, advection=fake())
    with pytest.raises(NotImplementedError):
        T.NonhydrostaticModel(grid_pair("FFF", (1, 1, 1))[1])


# -- on the card ---------------------------------------------------------------------

#: sizes of the card's holds, off the kernels' tiles
CARD = {"PFB": (100, 1, 45), "BFB": (77, 1, 29), "PPF": (100, 77, 1),
        "FFB": (1, 1, 100), "FPB": (1, 100, 45), "PBB": (30, 27, 25),
        "BBB": (27, 25, 19)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def poison_cache(grid, n):
    """Leave n NaN-filled blocks of the outputs' size in the caching
    allocator, so that outputs a kernel does not write stay NaN."""
    blocks = [torch.full(grid.total_shape, float("nan"), dtype=grid.dtype,
                         device="cuda") for _ in range(n)]
    del blocks


def card_fields(grid, n, seed=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(grid.total_shape, generator=gen, dtype=grid.dtype,
                        device="cuda") for _ in range(n)]


def hold_k2(grid, scheme, tracer_scheme, fields):
    """K2 against its plain version: bit for bit on the interior and the
    wall faces, every other halo point exactly 0."""
    args = (grid, scheme, tracer_scheme, *fields[:3],
            {f"c{i}": c for i, c in enumerate(fields[3:])})
    poison_cache(grid, len(fields) + 2)
    before = tft.fused_advective_tendencies.launches
    got = tft.fused_advective_tendencies(*args)
    torch.cuda.synchronize()
    assert tft.fused_advective_tendencies.launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    for name in ref:
        mask = wall_mask(grid, name)
        assert torch.equal(got[name][mask], ref[name][mask]), name
        rest = got[name][~mask]
        assert not rest.isnan().any() and not rest.any(), f"{name}: halo"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_k2_matches_plain_version(code, scheme, dtype):
    needs_card()
    _, tg = grid_pair(code, CARD[code], dtype=DTYPES[dtype], device="cuda")
    sch = getattr(T, SCHEMES[scheme][0])()
    hold_k2(tg, sch, sch, card_fields(tg, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("code", list(CARD))
def test_cuda_projection_kernels_match_plain_versions(code, dtype):
    """K3b bit for bit; K3c bit for bit on the interior with every halo
    point exactly 0, over NaN-filled memory."""
    needs_card()
    _, tg = grid_pair(code, CARD[code], dtype=DTYPES[dtype], device="cuda")
    u, v, w, p = card_fields(tg, 4, seed=5)
    assert torch.equal(tft.fused_divergence(tg, u, v, w),
                       tft.fused_divergence_reference(tg, u, v, w))
    poison_cache(tg, 4)
    got = tft.fused_pressure_gradient(tg, p)
    for g, r in zip(got, tft.fused_pressure_gradient_reference(tg, p)):
        assert torch.equal(tg.interior(g), tg.interior(r))
        rest = g.clone()
        rest[tg.interior_slices] = 0
        assert not rest.isnan().any() and not rest.any()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["weno5", "ub5"])
@pytest.mark.parametrize("code", ["PPF", "FPB"])
def test_cuda_k1_matches_plain_version(code, scheme):
    """K1 on a Flat z and a Flat x (its general instantiation), with
    Coriolis, diffusion and the tracers, Euler and AB2, bit for bit over
    NaN-filled outputs."""
    needs_card()
    _, tg = grid_pair(code, CARD[code], dtype=torch.float32, device="cuda")
    sch = getattr(T, SCHEMES[scheme][0])()
    kw = dict(tracers=("c",)) if code == "PPF" else dict(buoyancy=T.BuoyancyTracer())
    model = T.NonhydrostaticModel(tg, advection=sch, coriolis=T.FPlane(f=0.3),
                                  closure=T.ScalarDiffusivity(nu=1e-3, kappa=2e-3), **kw)
    assert model.fused_step and tfs.general_route(model)
    gen = torch.Generator(device="cuda").manual_seed(6)
    rand = lambda shape: 1e-2 * torch.randn(shape, generator=gen, dtype=tg.dtype, device="cuda")
    state = model.initial_state(**{n: rand(model.grid.shape) for n in model.prognostic_names()})
    state = dict(state, G_prev={k: rand(tuple(g.shape)) for k, g in state["G_prev"].items()})
    for euler in (True, False):
        poison_cache(model.grid, 2 * len(model.prognostic_names()))
        psi, g = tfs.fused_ab2_advance(model, state, 1e-3, euler)
        ref_psi, ref_g = tfs.fused_ab2_advance_reference(model, state, 1e-3, euler)
        for name in psi:
            assert torch.equal(psi[name], ref_psi[name]), name
            assert torch.equal(g[name], ref_g[name]), name
