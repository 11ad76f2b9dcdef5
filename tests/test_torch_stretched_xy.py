"""Port parity: the nonhydrostatic model on a grid stretched in x or y
(the multigrid pressure solve, the general AB2 branch) and K2 there.

The same numpy-seeded inputs go through the JAX package and the port in
float64:

- K2's plain version (the reference of its stretched-x/y form) against the
  JAX ``div_*`` bit for bit (op by op) on a stretched x, y and both, with
  WENO5, PositiveWENO5, BoundsPreservingWENO5, UB1, UB3, UB5 and C4, on
  (Bounded, Flat, Bounded) too: the two-sided table form along the
  stretched axis, the per-index face areas and volumes;
- the nonhydrostatic model on a stretched x, a stretched y and both: 3
  quasi-AB2 steps within ``RTOL`` of max|field| of the jitted JAX model,
  max|∇·u| < 1e-7.

The ``cuda`` cases hold K2's stretched-x/y form
(``csrc/fused_advective_tendencies_xy.cu``) against its plain version on
the card bit for bit over NaN-filled outputs, on the interior, each
velocity's wall face and the zero halos: every scheme, WENO5's bf16
options, the Flat layout, the clear flags, partial tiles (``python -m
pytest --noconftest -m cuda tests/test_torch_stretched_xy.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from clima_oceananigans_jl_torch.ops import operators as top
from clima_oceananigans_jl_torch.solvers import stencil_matrix as tsm

try:  # the cuda cases also run on a machine without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import fluxes as jfl
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9


def stretched_grid(pkg, stretch, size, topology=None, device=DEVICE, **kw):
    """The JAX suite's grids: x faces tanh-refined at both walls, y faces
    refined at one end, z faces −cos, on the axes named in ``stretch``."""
    n = size
    xf = np.tanh(np.linspace(-1.2, 1.2, n[0] + 1)) / np.tanh(1.2)
    yf = np.linspace(0.0, 1.0, n[1] + 1) ** 1.3
    zf = -np.cos(np.linspace(0, np.pi / 2, n[2] + 1))
    topology = topology or ("bounded", "periodic", "bounded")
    dtype = (dict(dtype=jnp.float64) if pkg is not T
             else dict(dtype=kw.pop("dtype", torch.float64), device=device))
    return pkg.RectilinearGrid(
        size=n, x=xf if "x" in stretch else (-1.0, 1.0),
        y=yf if "y" in stretch else (0.0, 1.0),
        z=zf if "z" in stretch else (-1.0, 0.0), topology=topology, **dtype, **kw)


#: K2's plain version on stretched grids: (stretched axes, topology,
#: momentum, tracer scheme)
K2_PLAIN = {"x WENO5": ("x", ("bounded", "periodic", "bounded"), "WENO5", "WENO5"),
            "y PW": ("y", ("periodic", "bounded", "bounded"), "UpwindBiasedThirdOrder",
                     "PositiveWENO5"),
            "xyz BP": ("xyz", ("bounded", "bounded", "bounded"), "CenteredFourthOrder",
                       "BoundsPreservingWENO5"),
            "x BFB": ("x", ("bounded", "flat", "bounded"), "WENO5", "UpwindBiasedFifthOrder"),
            "xy UB1": ("xy", ("bounded", "bounded", "bounded"), "UpwindBiasedFirstOrder",
                       "UpwindBiasedFirstOrder")}


@pytest.mark.parametrize("case", list(K2_PLAIN))
def test_k2_plain_version_on_a_stretched_x_or_y_matches_jax(case):
    """K2's plain version (the reference of its stretched-x/y form) against
    the JAX div_* bit for bit on the interior and the velocities' wall
    faces: the two-sided table form along a stretched x or y, the per-index
    areas and volumes."""
    stretch, topology, mom, tr = K2_PLAIN[case]
    size = (11, 1 if "flat" in topology else 9, 8)
    grids = {pkg: stretched_grid(pkg, stretch, size, topology=topology) for pkg in (J, T)}
    jg, tg = grids[J], grids[T]
    rng = np.random.default_rng(2)
    u, v, w = (rng.standard_normal(tg.total_shape) for _ in range(3))
    c = rng.uniform(-0.1, 1.1, tg.total_shape)
    js, jt = getattr(J, mom)(), getattr(J, tr)()
    ju = tuple(map(jnp.asarray, (u, v, w)))
    ref = dict(u=-jfl.div_vu(jg, js, *ju), v=-jfl.div_vv(jg, js, *ju),
               w=-jfl.div_vw(jg, js, *ju), c=-jfl.div_Uc(jg, jt, *ju, jnp.asarray(c)))
    got = tft.fused_advective_tendencies_reference(
        tg, getattr(T, mom)(), getattr(T, tr)(), *map(torch.as_tensor, (u, v, w)),
        {"c": torch.as_tensor(c)})
    for name, r in ref.items():
        assert np.array_equal(np.asarray(jg.interior(r)), tg.interior(got[name]).numpy()), name
    for name, axis in (("u", 0), ("v", 1), ("w", 2)):
        if topology[axis] == "bounded":
            face = [slice(h, h + n) for h, n in zip(tg.halo, tg.shape)]
            face[axis] = tg.halo[axis] + tg.shape[axis]
            assert np.array_equal(np.asarray(ref[name])[tuple(face)],
                                  got[name].numpy()[tuple(face)]), name


def nonhydrostatic_state(model, shape, pkg):
    rng = np.random.default_rng(9)
    u = 1e-2 * rng.standard_normal(shape)
    v = 1e-2 * rng.standard_normal(shape)
    c = ((lambda x, y, z: jnp.exp(-(x ** 2 + (z + 0.5) ** 2) / 0.1)) if pkg is J
         else (lambda x, y, z: torch.exp(-(x ** 2 + (z + 0.5) ** 2) / 0.1)))
    return model.initial_state(u=u, v=v, c=c)


#: the stretched axes of each nonhydrostatic case and its advection scheme
STRETCHED_MODELS = {"x": ("xz", "WENO5"), "y": ("y", "UpwindBiasedThirdOrder"),
                    "xy": ("xyz", "CenteredSecondOrder")}


@pytest.mark.parametrize("stretch", list(STRETCHED_MODELS))
def test_nonhydrostatic_on_a_stretched_x_or_y_matches_jax(stretch):
    """The JAX suite's stretched configuration (16×8×8 fp64, (Bounded,
    Periodic, Bounded)) with a tracer on a stretched x (and z, WENO5), a
    stretched y (UB3) and both (and z, centred): 3 quasi-AB2 steps within
    RTOL of the JAX model, the port's velocities divergence-free to
    1e-7."""
    size = (16, 8, 8)
    axes, scheme = STRETCHED_MODELS[stretch]
    models = {pkg: (JN if pkg is J else T.NonhydrostaticModel)(
        stretched_grid(pkg, axes, size), advection=getattr(pkg, scheme)(), tracers=("c",),
        **(dict(fused_advection=False) if pkg is J else {})) for pkg in (J, T)}
    tm = models[T]
    assert isinstance(tm.pressure_solver, tsm.MultigridPoissonSolver)
    assert not tm.fused_step and not tm.projection_kernels
    js = nonhydrostatic_state(models[J], size, J)
    ts = nonhydrostatic_state(tm, size, T)
    step = jax.jit(models[J].step)
    for _ in range(3):
        js, ts = step(js, jnp.float64(1e-3)), tm.step(ts, 1e-3)
    for k in ("u", "v", "w", "c"):
        ref = np.asarray(models[J].grid.interior(js["solution"][k]))
        got = tm.grid.interior(ts["solution"][k]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), k
    sol = ts["solution"]
    div = tm.grid.interior(top.div_ccc(sol["u"], sol["v"], sol["w"], tm.grid))
    assert float(div.abs().max()) < 1e-7


# -- on the card ---------------------------------------------------------------

def nan_cache(shape, dtype, n=8):
    """NaN-filled blocks left in the caching allocator, so that an output
    point a kernel does not write stays NaN."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for _ in range(n)]
    del blocks


#: K2's stretched-x/y form on the card: (stretched axes, topology, size,
#: momentum, tracer scheme, immersed); a scheme is a name, or a name and
#: its keywords
CUDA_CASES = {
    "x P": ("x", ("periodic", "periodic", "bounded"), (37, 26, 19), "WENO5", "WENO5", False),
    "x B": ("x", ("bounded", "periodic", "bounded"), (37, 26, 19), "WENO5", "UpwindBiasedThirdOrder", False),
    "y": ("y", ("periodic", "bounded", "bounded"), (29, 33, 17), "UpwindBiasedThirdOrder", "PositiveWENO5", False),
    "xy": ("xy", ("bounded", "bounded", "bounded"), (30, 27, 18), "CenteredFourthOrder", "WENO5", False),
    "xz": ("xz", ("bounded", "periodic", "bounded"), (33, 20, 21), "WENO5", "PositiveWENO5", False),
    "x BFB": ("x", ("bounded", "flat", "bounded"), (45, 1, 23), "WENO5", "WENO5", False),
    "x immersed": ("x", ("bounded", "periodic", "bounded"), (32, 24, 16), "WENO5", "WENO5", True),
    "xy UB1": ("xy", ("bounded", "bounded", "bounded"), (30, 27, 18), "UpwindBiasedFirstOrder",
               "UpwindBiasedFirstOrder", False),
    "xz UB5": ("xz", ("bounded", "periodic", "bounded"), (33, 20, 21), "UpwindBiasedFifthOrder",
               "UpwindBiasedFifthOrder", False),
    "y BP": ("y", ("periodic", "bounded", "bounded"), (29, 33, 17), "BoundsPreservingWENO5",
             "BoundsPreservingWENO5", False),
    "xz fast_bf16": ("xz", ("bounded", "periodic", "bounded"), (33, 20, 21),
                     ("WENO5", {"fast_bf16": True}), ("WENO5", {"fast_bf16": True}), False),
    "x bf16_smoothness": ("x", ("bounded", "bounded", "bounded"), (37, 26, 19),
                          ("WENO5", {"bf16_smoothness": True}),
                          ("WENO5", {"bf16_smoothness": True}), False),
    "xyz partial tiles": ("xyz", ("bounded", "bounded", "bounded"), (13, 14, 5), "WENO5",
                          "UpwindBiasedThirdOrder", False),
}


def make_scheme(spec):
    """The port's scheme of a ``CUDA_CASES`` entry: a name, or a name and its
    keywords."""
    name, kw = (spec, {}) if isinstance(spec, str) else spec
    return getattr(T, name)(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_k2_stretched_form_matches_plain_version(case, dtype):
    """K2's stretched-x/y form against its plain version bit for bit on the
    interior, each velocity's wall face and the zero halos, over
    NaN-filled outputs; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stretch, topology, size, mom, tr, immersed = CUDA_CASES[case]
    dt = {"fp32": torch.float32, "fp64": torch.float64}[dtype]
    n = size
    faces = lambda m: np.tanh(np.linspace(-1.2, 1.2, m + 1)) / np.tanh(1.2)
    grid = T.RectilinearGrid(
        size=size, x=faces(n[0]) if "x" in stretch else (-1.0, 1.0),
        y=np.linspace(0, 1, n[1] + 1) ** 1.3 if "y" in stretch else (0.0, 1.0),
        z=-np.cos(np.linspace(0, np.pi / 2, n[2] + 1)) if "z" in stretch else (-1.0, 0.0),
        topology=topology, dtype=dt, device="cuda")
    if immersed:  # the model's with-halo ImmersedGrid over a ridge
        grid = T.NonhydrostaticModel(
            grid, advection=make_scheme(mom), tracers=("c0", "c1"),
            immersed_boundary=T.GridFittedBottom(
                lambda x, y: -0.8 + 0.3 * torch.exp(-x ** 2 / 0.1))).grid
    rng = np.random.default_rng(3)
    f = [torch.as_tensor(rng.standard_normal(grid.total_shape), dtype=dt, device="cuda")
         for _ in range(5)]
    args = (grid, make_scheme(mom), make_scheme(tr), f[0], f[1], f[2],
            {"c0": f[3], "c1": f[4]})
    nan_cache(grid.total_shape, dt)
    before = tft.fused_advective_tendencies.stretched_launches
    got = tft.fused_advective_tendencies(*args)
    assert tft.fused_advective_tendencies.stretched_launches == before + 1
    ref = tft.fused_advective_tendencies_reference(*args)
    for name in got:
        g, r = got[name], ref[name]
        assert torch.equal(grid.interior(g), grid.interior(r)), name
        rest = g.clone()
        rest[grid.interior_slices] = 0
        axis = {"u": 0, "v": 1, "w": 2}.get(name)
        if axis is not None and topology[axis] == "bounded":
            face = [slice(h, h + m) for h, m in zip(grid.halo, grid.shape)]
            face[axis] = grid.halo[axis] + grid.shape[axis]
            assert torch.equal(g[tuple(face)], r[tuple(face)]), f"{name}'s wall face"
            rest[tuple(face)] = 0
        assert not rest.isnan().any() and not rest.any(), f"{name}: a halo point is not 0"
