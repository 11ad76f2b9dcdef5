"""Port parity: the JAX suite's decomposed near-global stack
(``tests/test_distributed.py::test_distributed_near_global_flagship_config``
and ``::test_overlap_halo_near_global_flagship``) in the port's
``DistributedModel`` on the CPU, held against JAX's ``DistributedModel``
on the same (2, 2) mesh: a 48×24×8 fp64 lat-lon grid (0–360, −60–60),
the ``GridFittedBottom`` of a ridge and a bump, split-explicit(12),
``HydrostaticSphericalCoriolis``, ``BuoyancyTracer``, the vertically
implicit ``ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3,
kappa_z=1e-4)`` and a wind ``FluxBC`` on u; 3 steps of 600 s from one
initial state, built by the JAX model from the suite's callables and
scattered to both meshes.

Tolerance: u, v, b and η within 1e-12 of max|ref| (``W_RTOL`` of
``tests/test_torch_distributed_hydrostatic.py``): w's and pHY′'s
cumulative sums run in another order in torch than in XLA.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T

try:
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.parallel import distributed as jdist
except ImportError:
    pass

torch.set_num_threads(1)

W_RTOL = 1e-12
STEPS, DT = 3, 600.0


def near_global(P):
    """The JAX suite's near-global stack at 48×24×8 fp64 in package ``P``."""
    xp = jnp if P is J else torch
    kw = dict(dtype=jnp.float64) if P is J else dict(dtype=torch.float64, device="cpu")
    grid = P.LatitudeLongitudeGrid(size=(48, 24, 8), longitude=(0, 360),
                                   latitude=(-60, 60), z=(-3000.0, 0.0), **kw)

    def bathy(lam, phi):
        return xp.where((lam > 170) & (lam < 190), 100.0,
                        -3000.0 + 800.0 * xp.exp(-((lam - 60) / 15.0) ** 2))

    def wind(lam, phi, t):
        return -1e-4 * xp.cos(3.0 * np.pi * phi / 180.0)

    return P.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=P.SplitExplicitFreeSurface(substeps=12),
        coriolis=P.HydrostaticSphericalCoriolis(), buoyancy=P.BuoyancyTracer(),
        closure=P.ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                    time_discretization="vertically_implicit"),
        immersed_boundary=P.GridFittedBottom(bathy),
        boundary_conditions={"u": P.FieldBCs(top=P.FluxBC(wind))})


@pytest.fixture(scope="module")
def initial():
    """The JAX models and the one initial state, numpy leaves."""
    jm = near_global(J)
    js = jm.initial_state(b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    return jm, js, jax.tree_util.tree_map(np.asarray, js)


def _interior(grid, x):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny]


@pytest.mark.parametrize("overlap", [False, True])
def test_decomposed_near_global_matches_jax(initial, overlap):
    jm, js, npstate = initial
    jd = jdist.DistributedModel(jm, jdist.make_mesh((2, 2)), overlap_halo=overlap)
    sj = jd.scatter_state(js)
    for _ in range(STEPS):
        sj = jd.step(sj, jnp.float64(DT))
    sj = jd.gather_state(sj)
    tm = near_global(T)
    td = T.DistributedModel(tm, T.make_mesh((2, 2), "cpu"), overlap_halo=overlap)
    st = td.scatter_state(npstate)
    for _ in range(STEPS):
        st = td.step(st, DT)
    st = td.gather_state(st)
    g = tm.grid
    pairs = {n: (sj["solution"][n], st["solution"][n]) for n in ("u", "v", "b")}
    pairs["eta"] = (sj["eta"], st["eta"])
    for name, (a, b) in pairs.items():
        ref, got = _interior(g, a), _interior(g, b)
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got - ref).max()
        assert err <= W_RTOL * scale, f"{name}: {err} > {W_RTOL} * {scale}"
