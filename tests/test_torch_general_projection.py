"""Port parity: the general pressure projection and its two stencils
(K3b ``fused_divergence``, K3c ``fused_pressure_gradient``).

The configuration that reaches it is the flagship of
``__graft_entry__.py`` (WENO5, ``BuoyancyTracer``, ``FPlane``,
``ScalarDiffusivity``, RK3) on (Periodic, Periodic, Bounded) with
``FluxBC()`` w walls, which are not imposed values. The JAX side is the
plain path (``fused_advection=False``).

Tolerances: K3b's and K3c's plain versions are bitwise the JAX
``div_ccc`` and face gradients (the same expression trees); one
projection agrees to 1e-12 of max|ref| (torch.fft and jnp.fft round
differently); ten RK3 steps to 1e-9 (the FFTs and the pHY′ cumulative
sums reassociate, and ten steps carry it forward). A FluxBC w wall is
mirrored about an untouched wall face, so the Neumann solve cannot
remove the net wall flux: after the projection ∇·u is uniform, and the
check is its deviation from the domain mean.

The ``cuda`` cases hold the kernels against their plain versions on the
card, alone and through three RK3 steps of the flux-wall configuration
(``python -m pytest --noconftest -m cuda
tests/test_torch_general_projection.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
    from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.ops import operators as jop
    from clima_oceananigans_jl_tpu.ops import stencil as jst
    from clima_oceananigans_jl_tpu.utils.location import U_LOC, V_LOC, W_LOC
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

SIZE = (16, 12, 10)
DT = 1e-3
TOPOLOGIES = {"ppb": ("periodic", "periodic", "bounded"),
              "ppp": ("periodic", "periodic", "periodic")}


def torch_grid(topo="ppb", size=SIZE, dtype=torch.float64, device=DEVICE):
    return T.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                             topology=TOPOLOGIES[topo], dtype=dtype,
                             device=device)


def grids(topo="ppb"):
    jg = J.RectilinearGrid(size=SIZE, extent=(1.0, 2.0, 0.5),
                           topology=TOPOLOGIES[topo], dtype=jnp.float64)
    return jg, torch_grid(topo)


def random_fields(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def models(size=SIZE, w_bcs=("flux", "flux"), timestepper="RungeKutta3",
           b_top=None):
    """The flagship configuration in both packages with the given w walls
    (``"flux"``: ``FluxBC()``; ``"value"``: ``ValueBC(0)``)."""
    jg = J.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=TOPOLOGIES["ppb"], dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=DEVICE)

    def bcs(mod):
        make = {"flux": lambda: mod.FluxBC(), "value": lambda: mod.ValueBC(0.0)}
        out = {"w": mod.FieldBCs(bottom=make[w_bcs[0]](), top=make[w_bcs[1]]())}
        if b_top is not None:
            out["b"] = mod.FieldBCs(top=mod.ValueBC(b_top))
        return out

    jm = NonhydrostaticModel(jg, advection=J.WENO5(), buoyancy=BuoyancyTracer(),
                             coriolis=jcor.FPlane(f=1e-4),
                             closure=jsd.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                             boundary_conditions=bcs(jbcs),
                             timestepper=timestepper, fused_advection=False)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(),
                               buoyancy=T.BuoyancyTracer(),
                               coriolis=T.FPlane(f=1e-4),
                               closure=T.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
                               boundary_conditions=bcs(tbcs),
                               timestepper=timestepper)
    return jm, tm


def w_top(grid, a):
    """The (nx, ny) plane of w's top wall face (with-halo z index hz+nz),
    which a FluxBC wall leaves to the time step."""
    return a[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny,
             grid.Hz + grid.Nz]


def initial_values(size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return dict(u=1e-2 * rng.standard_normal(size),
                v=1e-2 * rng.standard_normal(size),
                b=1e-4 * rng.standard_normal(size))


def close(ref, got, rtol, what):
    ref, got = np.asarray(ref), np.asarray(got)
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_divergence_plain_version_matches_jax_bitwise(topo):
    jg, tg = grids(topo)
    u, v, w = random_fields(tg.total_shape, 3)
    ref = jg.interior(jop.div_ccc(jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(w), jg))
    got = tft.fused_divergence_reference(tg, *map(torch.as_tensor, (u, v, w)))
    assert tuple(got.shape) == SIZE
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_pressure_gradient_plain_version_matches_jax_bitwise(topo):
    jg, tg = grids(topo)
    (p,) = random_fields(tg.total_shape, 1, seed=1)
    pj = jnp.asarray(p)
    ref = (jst.dxf(pj) / jg.dx(U_LOC), jst.dyf(pj) / jg.dy(V_LOC),
           jst.dzf(pj) / jg.dz(W_LOC))
    got = tft.fused_pressure_gradient_reference(tg, torch.as_tensor(p))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(jg.interior(r)), tg.interior(g).numpy())


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    tg = torch_grid()
    u, v, w, p = map(torch.as_tensor, random_fields(tg.total_shape, 4, seed=2))
    before = (tft.fused_divergence.launches,
              tft.fused_pressure_gradient.launches)
    assert torch.equal(tft.fused_divergence(tg, u, v, w),
                       tft.fused_divergence_reference(tg, u, v, w))
    for a, b in zip(tft.fused_pressure_gradient(tg, p),
                    tft.fused_pressure_gradient_reference(tg, p)):
        assert torch.equal(a, b)
    assert (tft.fused_divergence.launches,
            tft.fused_pressure_gradient.launches) == before
    # a Flat z is the kernels' y: its size 1, halo 0 and spacing 1
    flat = T.RectilinearGrid(size=(8, 6, 1), extent=(1, 2),
                             topology=(T.PERIODIC, T.PERIODIC, T.FLAT), device=DEVICE)
    assert tft._projection_args(flat) == (8, 1, 6, 3, 0, 3, 1 / 8, 1.0, 2 / 6)


@pytest.mark.parametrize("w_bcs,fast", [
    (("flux", "flux"), False), (("value", "flux"), False),
    (("value", "value"), True)], ids=["flux-flux", "value-flux", "value-value"])
def test_projection_is_chosen_where_jax_chooses_it(w_bcs, fast):
    jm, tm = models(w_bcs=w_bcs)
    assert tm._fast_projection_ok() == jm._fast_projection_ok() == fast


def projection_inputs(tm, jm, seed=3):
    """A filled model state with random velocities, in both packages."""
    vals = initial_values(seed=seed)
    ts = tm.initial_state(**vals)
    rng = np.random.default_rng(seed + 1)
    w = 1e-3 * rng.standard_normal(tm.grid.total_shape)
    ts["solution"]["w"] = torch.as_tensor(w)
    js = jm.initial_state(**vals)
    js["solution"]["w"] = jnp.asarray(w)
    return js, ts


def residual_divergence(model, state):
    """max|∇·u − mean ∇·u|·Δx / max|u| of a projected state."""
    g = model.grid
    sol = state["solution"]
    div = tft.fused_divergence_reference(g, sol["u"], sol["v"], sol["w"])
    umax = max(float(g.interior(sol[k]).abs().max()) for k in ("u", "v", "w"))
    return float((div - div.mean()).abs().max()) * (g.Lx / g.Nx) / umax


def test_general_projection_matches_jax():
    jm, tm = models()
    js, ts = projection_inputs(tm, jm)
    jout = jm._project_velocities_general(js, DT)
    tout = tm.project_velocities(ts, DT)
    for name in ("u", "v", "w"):
        close(jm.grid.interior(jout["solution"][name]),
              tm.grid.interior(tout["solution"][name]).numpy(), 1e-12, name)
    close(jout["pNHS"], tout["pNHS"].numpy(), 1e-12, "pNHS with halos")
    assert residual_divergence(tm, tout) <= 1e-12


def test_general_projection_leaves_a_uniform_divergence_and_its_inputs_alone():
    jm, tm = models()
    _, ts = projection_inputs(tm, jm, seed=5)
    before = {k: v.clone() for k, v in ts["solution"].items()}
    out = tm.project_velocities(ts, DT)
    for k, v in ts["solution"].items():
        assert torch.equal(v, before[k]), k
    g = tm.grid
    sol = out["solution"]
    div = tft.fused_divergence_reference(g, sol["u"], sol["v"], sol["w"])
    umax = max(float(g.interior(sol[k]).abs().max()) for k in ("u", "v", "w"))
    # the untouched FluxBC wall faces carry a net flux the solve keeps
    assert abs(float(div.mean())) * (g.Lx / g.Nx) / umax > 1e-9
    assert residual_divergence(tm, out) <= 1e-12


def test_flagship_with_flux_walls_ten_rk3_steps_match():
    jm, tm = models()
    assert not tm.fused_step and not tm._fast_projection_ok()
    vals = initial_values(seed=6)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    for name in ("u", "v", "w", "b"):
        close(jm.grid.interior(js["solution"][name]),
              tm.grid.interior(ts["solution"][name]).numpy(), 1e-9, name)
    for key in ("pHY", "pNHS"):
        close(jm.grid.interior(js[key]), tm.grid.interior(ts[key]).numpy(),
              1e-9, key)
    close(w_top(jm.grid, js["solution"]["w"]),
          w_top(tm.grid, ts["solution"]["w"]).numpy(), 1e-9, "w top wall face")
    assert residual_divergence(tm, ts) <= 1e-12


def test_ab2_general_branch_with_flux_walls_matches():
    """A value wall on b keeps the AB2 step off the fused branch, so the
    flux walls on w reach the general projection there too."""
    jm, tm = models(timestepper="QuasiAdamsBashforth2", b_top=1e-4)
    assert not tm.fused_step
    vals = initial_values(seed=7)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(5):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    for name in ("u", "v", "w", "b"):
        close(jm.grid.interior(js["solution"][name]),
              tm.grid.interior(ts["solution"][name]).numpy(), 1e-9, name)


def test_port_still_refuses_bounded_x_and_y_and_the_fused_ab2_branch():
    """Bounded x and y construct now and keep AB2 on the general branch
    (the JAX gate refuses its fused advection there), with the general
    projection. The fused AB2 branch before the general projection runs:
    K1's ψ′ with halos, then the implicit step and ``project_velocities``
    (``test_torch_stretched_nonhydrostatic.py`` holds it against JAX)."""
    for topo in ((T.BOUNDED, T.PERIODIC, T.BOUNDED),
                 (T.PERIODIC, T.BOUNDED, T.BOUNDED)):
        grid = T.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                                 topology=topo, dtype=torch.float64, device=DEVICE)
        model = T.NonhydrostaticModel(grid, advection=T.WENO5())
        assert not model.fused_step and not model._fast_projection_ok()
        assert tfs.unsupported_reason(model) is None
    _, tm = models(timestepper="QuasiAdamsBashforth2")
    assert tm.fused_step and tfs.general_route(tm) and tfs.w_top(tm)
    # value walls keep the AB2 step on the roll-based projection
    _, tm = models(w_bcs=("value", "value"), timestepper="QuasiAdamsBashforth2")
    assert tm._fast_projection_ok() and tfs.unsupported_reason(tm) is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,topo,rtol", [
    (torch.float64, "ppb", 1e-13), (torch.float64, "ppp", 1e-13),
    (torch.float32, "ppb", 1e-6)], ids=["f64-ppb", "f64-ppp", "f32-ppb"])
def test_cuda_kernels_match_plain_versions(dtype, topo, rtol):
    """K3b and K3c against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tg = torch_grid(topo, (32, 24, 20), dtype, "cuda")
    u, v, w, p = (torch.as_tensor(a, dtype=dtype, device="cuda")
                  for a in random_fields(tg.total_shape, 4, seed=8))
    before = (tft.fused_divergence.launches,
              tft.fused_pressure_gradient.launches)
    div = tft.fused_divergence(tg, u, v, w)
    grads = tft.fused_pressure_gradient(tg, p)
    torch.cuda.synchronize()
    assert (tft.fused_divergence.launches,
            tft.fused_pressure_gradient.launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref = tft.fused_divergence_reference(tg, u, v, w)
    assert float((div - ref).abs().max()) <= rtol * float(ref.abs().max())
    for g, r in zip(grads, tft.fused_pressure_gradient_reference(tg, p)):
        halo = g.clone()
        halo[tg.interior_slices] = 0
        assert not halo.any(), "the kernel wrote outside the interior"
        gi, ri = tg.interior(g), tg.interior(r)
        assert float((gi - ri).abs().max()) <= rtol * float(ri.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [
    (torch.float32, (64, 48, 40)), (torch.float64, (37, 29, 23)),
    (torch.float32, (13, 70, 45))], ids=["f32", "f64-off-tile", "f32-off-tile"])
def test_cuda_k3c_halo_zeros_over_nan_memory(dtype, size):
    """K3c's outputs come from torch.empty over NaN-filled memory: the
    interior bitwise its plain version, every halo point exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tg = torch_grid("ppb", size, dtype, "cuda")
    (p,) = (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in random_fields(tg.total_shape, 1, seed=10))
    p[..., tg.Hz] = p[..., tg.Hz - 1]  # zero numerators on the bottom face
    blocks = [torch.full(tg.total_shape, float("nan"), dtype=dtype, device="cuda")
              for _ in range(6)]
    del blocks
    grads = tft.fused_pressure_gradient(tg, p)
    torch.cuda.synchronize()
    for g, r in zip(grads, tft.fused_pressure_gradient_reference(tg, p)):
        assert torch.equal(tg.interior(g), tg.interior(r))
        halo = g.clone()
        halo[tg.interior_slices] = 0
        assert not halo.isnan().any() and not halo.any()


@pytest.mark.cuda
def test_cuda_flux_wall_steps_match_plain_run():
    """Three RK3 steps of the flux-wall flagship in f64 through K2, K3b and
    K3c against the same steps through their plain versions: the kernels
    must leave w's top wall face as the plain run does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clima_oceananigans_jl_torch.models import nonhydrostatic as tnh

    def run(kernels):
        grid = T.RectilinearGrid(size=SIZE, extent=(1.0, 1.0, 1.0),
                                 topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                                 dtype=torch.float64, device="cuda")
        walls = {"w": tbcs.FieldBCs(bottom=tbcs.FluxBC(), top=tbcs.FluxBC())}
        model = T.NonhydrostaticModel(
            grid, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
            coriolis=T.FPlane(f=1e-4),
            closure=T.ScalarDiffusivity(nu=1e-5, kappa=1e-5),
            boundary_conditions=walls, timestepper="RungeKutta3")
        state = model.initial_state(**initial_values(seed=9))
        for _ in range(3):
            state = model.step(state, DT, kernels)
        return model.grid, state["solution"]

    before = tft.fused_divergence.launches
    grid, got = run(None)
    assert tft.fused_divergence.launches == before + 9
    _, ref = run(tnh.PLAIN)
    for name in ("u", "v", "w", "b"):
        close(grid.interior(ref[name]).cpu(), grid.interior(got[name]).cpu(),
              1e-13, name)
    close(w_top(grid, ref["w"]).cpu(), w_top(grid, got["w"]).cpu(), 1e-13,
          "w top wall face")
