"""Port parity: the fused AB2 advance (K1).

The plain version ``fused_ab2_advance_reference`` against
(a) the JAX package's Pallas kernel ``fused_ab2_advance(...,
interpret=True)`` on a ``fused_advection=True`` JAX model, and
(b) the JAX plain path ``tendencies()`` + ``ab2_substep``,
at 16³ (and, against (b), 12×10×8 with a passive tracer), (Periodic,
Periodic, Bounded), f64, Euler and AB2 form, without and with the
kernel's options (f-plane Coriolis with a scalar diffusivity, β-plane
Coriolis with a horizontal one), on the same numpy-seeded state.
Tolerance: max|Δ| ≤ 1e-12·max|ref|, because XLA's CPU
backend may fuse and contract where eager PyTorch does not.

Against (a), w's k = 0 plane (its bottom wall face) is left out: the TPU
kernel works on z-halo-free blocks with wrap-around and leaves G_w and w′
there unspecified, since the projection imposes the wall value next.
Against (b), every point is compared.

The ``cuda`` cases hold the CUDA kernel against the plain version on the
card bit for bit and skip without one: every option, both G_prev layouts
(in the with-halo one G's halos must be zero without a zero fill), random,
smooth and all-zero fields, sizes off the kernel's tiles, 16 fields, fp32
and fp64. It needs no JAX, so on a GPU machine without
JAX it runs alone: ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_step.py``.
"""
import types

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.interop import state_from_numpy
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from test_torch_fused_tendencies import wave

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-12
DT = 1e-3


def close(ref, got, rtol, what):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    assert ref.shape == got.shape, what
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (what, err, scale)


def initial_values(shape, seed=0, tracers=()):
    rng = np.random.default_rng(seed)
    vals = dict(u=1e-2 * rng.standard_normal(shape),
                v=1e-2 * rng.standard_normal(shape),
                w=1e-3 * rng.standard_normal(shape),
                b=1e-4 * rng.standard_normal(shape))
    vals.update({n: rng.standard_normal(shape) for n in tracers})
    return vals


#: K1's options: name → a function of the package (J or T) giving the
#: model's Coriolis and closure keywords (f and ν large enough to matter)
OPTIONS = {
    "none": lambda P: {},
    "fplane-diffusion": lambda P: dict(
        coriolis=P.FPlane(f=2.0),
        closure=P.ScalarDiffusivity(nu=1e-3, kappa=2e-3, nu_z=5e-4)),
    "betaplane-horizontal": lambda P: dict(
        coriolis=P.BetaPlane(f0=1.0, beta=3.0),
        closure=P.HorizontalScalarDiffusivity(nu=1e-3, kappa=2e-3)),
}


def jax_model(size, fused, tracers=(), option="none"):
    import jax.numpy as jnp
    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity
    from clima_oceananigans_jl_tpu.coriolis import coriolis
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import (
        NonhydrostaticModel)
    grid = J.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                             topology=("periodic", "periodic", "bounded"),
                             dtype=jnp.float64)
    P = types.SimpleNamespace(
        FPlane=coriolis.FPlane, BetaPlane=coriolis.BetaPlane,
        ScalarDiffusivity=scalar_diffusivity.ScalarDiffusivity,
        HorizontalScalarDiffusivity=scalar_diffusivity.HorizontalScalarDiffusivity)
    return NonhydrostaticModel(grid, advection=J.WENO5(),
                               buoyancy=BuoyancyTracer(), tracers=tracers,
                               fused_advection=fused, **OPTIONS[option](P))


def torch_model(size, dtype=torch.float64, device=DEVICE, tracers=(),
                option="none", w_top=None):
    """The port's model; ``w_top`` imposes w on the top wall, which keeps
    the fused branch (without a closure) but stores G_prev with halos."""
    grid = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                             topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                             dtype=dtype, device=device)
    bcs = None if w_top is None else {"w": T.FieldBCs(top=T.ValueBC(w_top))}
    return T.NonhydrostaticModel(grid, advection=T.WENO5(),
                                 buoyancy=T.BuoyancyTracer(), tracers=tracers,
                                 boundary_conditions=bcs, **OPTIONS[option](T))


def with_random_gprev(jm, js, seed=1):
    """The JAX state with a random G_prev in the JAX model's own layout."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    gp = {k: jnp.asarray(1e-2 * rng.standard_normal(v.shape))
          for k, v in js["G_prev"].items()}
    return dict(js, G_prev=gp)


def to_numpy(state):
    import jax
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("euler", [True, False], ids=["euler", "ab2"])
def test_plain_k1_matches_jax_pallas_kernel(euler, option):
    from clima_oceananigans_jl_tpu.ops import fused_step as jfs
    size = (16, 16, 16)
    jm = jax_model(size, fused=True, option=option)
    assert jm.fused_step and jm.g_interior
    js = with_random_gprev(jm, jm.initial_state(**initial_values(size)))
    tm = torch_model(size, option=option)
    assert tm.fused_step and tm.g_interior
    ts = state_from_numpy(tm, to_numpy(js))
    j_sol, j_G = jfs.fused_ab2_advance(jm, js, DT, euler, interpret=True,
                                       interior_velocities=True)
    t_sol, t_G = tfs.fused_ab2_advance_reference(tm, ts, DT, euler)
    for name in tm.prognostic_names():
        ref_psi = np.asarray(jm.grid.interior(j_sol[name]))
        ref_g = np.asarray(j_G[name])
        got_psi, got_g = t_sol[name], t_G[name]
        if name == "w":  # the bottom wall face, unspecified in the TPU kernel
            ref_psi, ref_g = ref_psi[:, :, 1:], ref_g[:, :, 1:]
            got_psi, got_g = got_psi[:, :, 1:], got_g[:, :, 1:]
        close(ref_psi, got_psi, RTOL, f"psi'[{name}]")
        close(ref_g, got_g, RTOL, f"G[{name}]")


@pytest.mark.parametrize("euler", [True, False], ids=["euler", "ab2"])
@pytest.mark.parametrize("size,tracers,option", [
    ((16, 16, 16), (), "none"), ((12, 10, 8), ("c",), "none"),
    ((12, 10, 8), ("c",), "fplane-diffusion"),
    ((12, 10, 8), (), "betaplane-horizontal")])
def test_plain_k1_matches_jax_plain_path(euler, size, tracers, option):
    from clima_oceananigans_jl_tpu.timesteppers.steppers import ab2_substep
    jm = jax_model(size, fused=False, tracers=tracers, option=option)
    js = with_random_gprev(
        jm, jm.initial_state(**initial_values(size, tracers=tracers)))
    tm = torch_model(size, tracers=tracers, option=option)
    ts = state_from_numpy(tm, to_numpy(js))
    j_G = jm.tendencies(js)
    j_sol = ab2_substep(js["solution"], j_G, js["G_prev"], DT, jm.ab2_chi,
                        euler)
    t_sol, t_G = tfs.fused_ab2_advance_reference(tm, ts, DT, euler)
    for name in tm.prognostic_names():
        close(jm.grid.interior(j_sol[name]), t_sol[name], RTOL, f"psi'[{name}]")
        close(jm.grid.interior(j_G[name]), tm.grid.interior(t_G[name]), RTOL,
              f"G[{name}]")


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    size = (8, 8, 8)
    tm = torch_model(size)
    ts = tm.initial_state(**initial_values(size))
    before = tfs.fused_ab2_advance.launches
    psi, G = tfs.fused_ab2_advance(tm, ts, DT, True)
    ref_psi, ref_G = tfs.fused_ab2_advance_reference(tm, ts, DT, True)
    assert tfs.fused_ab2_advance.launches == before
    for name in tm.prognostic_names():
        assert torch.equal(psi[name], ref_psi[name])
        assert torch.equal(G[name], ref_G[name])
        assert psi[name].shape == G[name].shape == size


def test_unsupported_configurations_raise():
    """What the port does not run is refused by name; a vertically
    implicit closure, closure tuples, callable-valued ν (which the JAX
    constructor takes too), a stretched z, a stretched x (its multigrid
    pressure solve, the general AB2 branch, as the JAX gate has it) and a
    bounded x construct."""
    grid = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                             dtype=torch.float64, device=DEVICE)
    implicit = T.ScalarDiffusivity(nu=1e-3,
                                   time_discretization="vertically_implicit")
    # a timestepper or Coriolis form the JAX package lacks too is refused by
    # name; what waits for the port cites its ROADMAP item
    for kw, match in ((dict(timestepper="SplitRungeKutta3"),
                       "timestepper 'SplitRungeKutta3' is not ported"),
                      (dict(coriolis=object()), "object Coriolis is not ported"),
                      (dict(closure=object()), "ROADMAP"),
                      (dict(immersed_boundary=object()), "ROADMAP")):
        with pytest.raises(NotImplementedError, match=match):
            T.NonhydrostaticModel(grid, advection=T.WENO5(), **kw)
    for kw in (dict(closure=implicit),
               dict(closure=(T.ScalarDiffusivity(nu=1e-3),)),
               dict(closure=T.ScalarDiffusivity(nu=lambda x, y, z: x))):
        model = T.NonhydrostaticModel(grid, advection=T.WENO5(), **kw)
        assert model.fused_step == (kw["closure"] is implicit)
    stretched = T.RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1),
                                  z=-(1.0 - np.arange(9) / 8) ** 1.5,
                                  dtype=torch.float64, device=DEVICE)
    assert tfs.general_route(T.NonhydrostaticModel(stretched, advection=T.WENO5()))
    stretched_x = T.RectilinearGrid(size=(8, 8, 8), x=np.arange(9) ** 1.5,
                                    y=(0, 1), z=(0, 1),
                                    dtype=torch.float64, device=DEVICE)
    mx = T.NonhydrostaticModel(stretched_x, advection=T.WENO5())
    assert type(mx.pressure_solver).__name__ == "MultigridPoissonSolver"
    assert not mx.fused_step and not mx.projection_kernels
    # a bounded x runs, on the general AB2 branch as the JAX gate has it
    bounded_x = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                                  topology=(T.BOUNDED, T.PERIODIC, T.BOUNDED),
                                  dtype=torch.float64, device=DEVICE)
    assert not T.NonhydrostaticModel(bounded_x, advection=T.WENO5()).fused_step
    assert tfs.fused_step_ok(torch_model((8, 8, 8)))


#: the terms K1 lacks, each a function of the package (J or T) giving the
#: model keywords that add it
GENERAL_TERMS = {
    "forcing": lambda P: dict(forcing={"u": P.Forcing(
        lambda x, y, z, t, u: -0.5 * u, field_dependencies="u")}),
    "relaxation": lambda P: dict(forcing={"b": P.Relaxation(rate=2.0, target=1e-4)}),
    "stokes drift": lambda P: dict(stokes_drift=P.UniformStokesDrift(
        dz_us=lambda z, t: 0.1 + 0.2 * z)),
    "background": lambda P: dict(background_fields={
        "u": lambda x, y, z, t: 1e-2 * z + 0 * x * y}),
    "tilted gravity": lambda P: dict(buoyancy=P.BuoyancyTracer(
        gravity_unit_vector=(0.1, 0.0, -(1 - 0.01) ** 0.5))),
    "flux value": lambda P: dict(boundary_conditions={
        "b": P.FieldBCs(top=P.FluxBC(1e-5))}),
}


@pytest.mark.parametrize("term", GENERAL_TERMS)
def test_terms_k1_lacks_take_the_general_branch_as_the_jax_gate_says(term):
    """Each term outside K1 (forcing, Stokes drift, background fields,
    tilted gravity, a flux value) makes ``fused_step_ok`` false in both
    packages, the port's AB2 step takes the general branch, and two steps
    agree with the JAX plain path to 1e-9 of max|field| (its FFT and
    cumulative sums)."""
    import jax.numpy as jnp
    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.forcings import forcing as jf
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.ops.fused_step import fused_step_ok as j_gate
    from clima_oceananigans_jl_tpu.stokes_drift import UniformStokesDrift
    size = (12, 10, 8)
    JP = types.SimpleNamespace(Forcing=jf.Forcing, Relaxation=jf.Relaxation,
                               UniformStokesDrift=UniformStokesDrift,
                               BuoyancyTracer=BuoyancyTracer, FieldBCs=J.FieldBCs,
                               FluxBC=J.FluxBC)
    kw = dict(dict(buoyancy=BuoyancyTracer()), **GENERAL_TERMS[term](JP))
    jgrid = J.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=jnp.float64)
    assert j_gate(NonhydrostaticModel(jgrid, advection=J.WENO5(),
                                      fused_advection=True, **kw)) is False
    tgrid = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                              topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                              dtype=torch.float64, device=DEVICE)
    tm = T.NonhydrostaticModel(tgrid, advection=T.WENO5(),
                               **dict(dict(buoyancy=T.BuoyancyTracer()),
                                      **GENERAL_TERMS[term](T)))
    assert not tfs.fused_step_ok(tm) and not tm.fused_step and not tm.g_interior
    jm = NonhydrostaticModel(jgrid, advection=J.WENO5(), fused_advection=False, **kw)
    vals = initial_values(size, seed=5)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    for _ in range(2):
        js, ts = jm.step(js, DT), tm.step(ts, DT)
    for n in ("u", "v", "w", "b"):
        close(jm.grid.interior(js["solution"][n]), tm.grid.interior(ts["solution"][n]),
              1e-9, n)


def card_state(tm, tracers, kind):
    """A state of the port's model on the card: numpy-seeded random
    fields or ``wave`` fields of ``kind``; G_prev random in the model's
    layout."""
    size = tm.grid.shape
    if kind == "random":
        vals = initial_values(size, tracers=tracers)
    else:
        field = wave(size, kind)
        vals = {n: field(a) for a, n in enumerate(tm.prognostic_names())}
    ts = tm.initial_state(**vals)
    rng = np.random.default_rng(1)
    g_shape = size if tm.g_interior else tm.grid.total_shape
    ts["G_prev"] = {k: torch.as_tensor(1e-2 * rng.standard_normal(g_shape),
                                       dtype=tm.grid.dtype, device="cuda")
                    for k in tm.prognostic_names()}
    return ts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size,tracers,option,w_top,kind", [
    (torch.float64, (16, 12, 10), ("c",), "none", None, "random"),
    (torch.float64, (16, 12, 10), ("c",), "fplane-diffusion", None, "random"),
    (torch.float64, (16, 12, 10), (), "betaplane-horizontal", None, "random"),
    (torch.float64, (16, 12, 10), ("c",), "none", 1e-3, "random"),
    (torch.float32, (32, 24, 16), (), "none", None, "random"),
    (torch.float32, (32, 24, 16), (), "fplane-diffusion", None, "random"),
    (torch.float32, (20, 13, 40), ("c",), "fplane-diffusion", None, "smooth"),
    (torch.float32, (12, 10, 8), (), "none", 1e-3, "zero"),
    (torch.float32, (9, 17, 33), tuple(f"c{i}" for i in range(12)),
     "fplane-diffusion", None, "random"),
    (torch.float64, (12, 10, 40), tuple(f"c{i}" for i in range(12)),
     "betaplane-horizontal", None, "smooth"),
    (torch.float32, (20, 13, 40), ("c",), "none", 1e-3, "smooth")],
    ids=["f64", "f64-fplane", "f64-betaplane", "f64-with-halo-G", "f32",
         "f32-fplane", "f32-fplane-smooth-off-tile", "f32-with-halo-G-zero",
         "f32-16-fields-off-tile", "f64-16-fields-chunks",
         "f32-with-halo-G-smooth-off-tile"])
def test_cuda_kernel_matches_plain_version(dtype, size, tracers, option,
                                           w_top, kind):
    """The kernel against the plain version on the card, bit for bit
    (max|Δ| = 0), Euler and AB2 form, in both G_prev layouts; in the
    with-halo one, G's halos are zero although G was not zero-filled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = torch_model(size, dtype=dtype, device="cuda", tracers=tracers,
                     option=option, w_top=w_top)
    assert tm.fused_step and tm.g_interior == (w_top is None)
    ts = card_state(tm, tracers, kind)
    nf = len(tm.prognostic_names())
    for euler in (True, False):
        # NaN-filled blocks of G's size for the caching allocator to reuse
        blocks = [torch.full_like(ts["G_prev"]["u"], float("nan"))
                  for _ in range(nf)]
        del blocks
        before = tfs.fused_ab2_advance.launches
        psi, G = tfs.fused_ab2_advance(tm, ts, DT, euler)
        torch.cuda.synchronize()
        assert tfs.fused_ab2_advance.launches == before + 1
        ref_psi, ref_G = tfs.fused_ab2_advance_reference(tm, ts, DT, euler)
        for name in tm.prognostic_names():
            assert torch.equal(ref_psi[name], psi[name]), f"psi'[{name}]"
            assert torch.equal(ref_G[name], G[name]), f"G[{name}]"
