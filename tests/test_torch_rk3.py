"""Port parity: the RK3 flagship step and the AB2 branches with Coriolis
and diffusion, end to end.

The flagship configuration of ``__graft_entry__.py::_flagship_model``
(WENO5, ``BuoyancyTracer``, ``FPlane(f=1e-4)``,
``ScalarDiffusivity(nu=1e-5, kappa=1e-5)``, RK3, (Periodic, Periodic,
Bounded)) at 16³ and 24×16×12 in f64, built in both packages from the
same numpy-seeded fields and stepped 10 times; the JAX side is the plain
path (``fused_advection=False``). u, v, w, b interiors, pHY′ and pNHS
must agree to max|Δ| ≤ 1e-9·max|ref|: besides XLA's contraction, the FFT
libraries and the pHY′ cumulative sum sum in different orders, and ten
steps carry those differences forward.

The quasi-AB2 cases take both branches of the port's step: Coriolis and
a scalar diffusivity run inside the fused advance (K1's plain version
here), and a value wall on b sends the same physics through the general
branch (``tendencies`` → ``ab2_substep`` → projection). One test per
fault repaired in the port: the kernel build hash covers included
headers, ``project_velocities`` leaves its inputs alone, the clock
carries the RK3 stage, and ``state_from_numpy`` gives ``G_prev`` the
layout of the model's step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_torch.interop import state_from_numpy, state_to_numpy
from clima_oceananigans_jl_torch.ops import _build
from clima_oceananigans_jl_torch.ops import fused_step as tfs
from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.timesteppers.steppers import Clock as JClock

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-9
DT = 1e-3
FLAGSHIP = dict(f=1e-4, nu=1e-5, kappa=1e-5, timestepper="RungeKutta3")


def models(size, f, nu, kappa, timestepper, beta=None, bcs=None):
    """The same configuration in both packages (JAX: plain path)."""
    jg = J.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(T.PERIODIC, T.PERIODIC, T.BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    if beta is None:
        jc, tc = jcor.FPlane(f=f), T.FPlane(f=f)
    else:
        jc, tc = jcor.BetaPlane(f0=f, beta=beta), T.BetaPlane(f0=f, beta=beta)
    jb = tb = None
    if bcs is not None:
        jb = {n: jbcs.FieldBCs(**{s: jbcs.ValueBC(v) for s, v in sides.items()})
              for n, sides in bcs.items()}
        tb = {n: tbcs.FieldBCs(**{s: tbcs.ValueBC(v) for s, v in sides.items()})
              for n, sides in bcs.items()}
    jm = NonhydrostaticModel(jg, advection=J.WENO5(), buoyancy=BuoyancyTracer(),
                             coriolis=jc,
                             closure=jsd.ScalarDiffusivity(nu=nu, kappa=kappa),
                             boundary_conditions=jb, timestepper=timestepper,
                             fused_advection=False)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(),
                               buoyancy=T.BuoyancyTracer(), coriolis=tc,
                               closure=T.ScalarDiffusivity(nu=nu, kappa=kappa),
                               boundary_conditions=tb, timestepper=timestepper)
    return jm, tm


def initial_values(size, seed=0):
    """u, v ~ 1e-2·N(0,1) and b ~ 1e-4·N(0,1), as ``entry()`` draws them."""
    rng = np.random.default_rng(seed)
    return dict(u=1e-2 * rng.standard_normal(size),
                v=1e-2 * rng.standard_normal(size),
                b=1e-4 * rng.standard_normal(size))


def compare(jm, js, tm, ts, rtol=RTOL):
    for name in ("u", "v", "w", "b"):
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (name, err, scale)
    for key in ("pHY", "pNHS"):
        ref = np.asarray(jm.grid.interior(js[key]))
        got = tm.grid.interior(ts[key]).numpy()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= rtol * scale, (key, err, scale)
    assert ts["clock"].iteration == int(js["clock"].iteration)
    assert ts["clock"].time == pytest.approx(float(js["clock"].time), rel=1e-12)


def run_both(jm, tm, vals, steps, js=None, ts=None):
    js = jm.initial_state(**vals) if js is None else js
    ts = tm.initial_state(**vals) if ts is None else ts
    step = jax.jit(jm.step)
    for _ in range(steps):
        js = step(js, DT)
        ts = tm.step(ts, DT)
    return js, ts


@pytest.mark.parametrize("size", [(16, 16, 16), (24, 16, 12)])
def test_flagship_rk3_ten_steps_match(size):
    jm, tm = models(size, **FLAGSHIP)
    assert not tm.fused_step and not tm.g_interior
    js, ts = run_both(jm, tm, initial_values(size), 10)
    compare(jm, js, tm, ts)
    for a in ts["solution"].values():
        assert a.shape == tm.grid.total_shape and bool(torch.isfinite(a).all())
    assert all(g.shape == tm.grid.total_shape for g in ts["G_prev"].values())
    assert ts["clock"].stage == 0 and ts["previous_dt"] == DT


def test_restart_from_jax_rk3_state_matches():
    size = (16, 16, 16)
    jm, tm = models(size, **FLAGSHIP)
    js, _ = run_both(jm, tm, initial_values(size, seed=1), 0)
    step = jax.jit(jm.step)
    for _ in range(3):
        js = step(js, DT)
    ts = state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    assert ts["clock"].iteration == 3 and ts["previous_dt"] == DT
    compare(jm, js, tm, ts, rtol=0.0)  # the conversion itself is exact
    js, ts = run_both(jm, tm, None, 3, js, ts)
    compare(jm, js, tm, ts)


@pytest.mark.parametrize("beta", [None, 3.0], ids=["fplane", "betaplane"])
def test_ab2_coriolis_diffusion_takes_the_fused_branch(beta):
    size = (16, 12, 10)
    jm, tm = models(size, f=2.0, nu=1e-3, kappa=2e-3,
                    timestepper="QuasiAdamsBashforth2", beta=beta)
    assert tm.fused_step and tm.g_interior
    calls = []

    def spy(model, state, dt, euler):
        calls.append(euler)
        return tfs.fused_ab2_advance_reference(model, state, dt, euler)

    vals = initial_values(size, seed=2)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT)
        ts = tm.step(ts, DT, kernels={"advance": spy})
    assert calls == [True] + [False] * 9
    compare(jm, js, tm, ts)
    assert all(g.shape == size for g in ts["G_prev"].values())


def test_ab2_diffusion_with_value_wall_takes_the_general_branch():
    size = (16, 12, 10)
    jm, tm = models(size, f=2.0, nu=1e-3, kappa=2e-3,
                    timestepper="QuasiAdamsBashforth2",
                    bcs={"b": {"top": 1e-4}})
    assert tfs._step_kernel_closure(tm) is None
    assert not tm.fused_step and not tm.g_interior
    assert not jm.fused_step

    def fail(*args):
        raise AssertionError("the general branch ran the fused advance")

    vals = initial_values(size, seed=3)
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(10):
        js = step(js, DT)
        ts = tm.step(ts, DT, kernels={"advance": fail})
    compare(jm, js, tm, ts)
    assert all(g.shape == tm.grid.total_shape for g in ts["G_prev"].values())


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """Fault 1: an edited header must change the library path."""
    assert [p.name for p in _build.sources("fused_ab2_advance")
            ] == ["fused_ab2_advance.cu", "weno5_advection.cuh", "tiles.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("inline int g() { return 2; }\n")
    assert _build.library_path("k") != before


def test_project_velocities_writes_into_none_of_its_inputs():
    """Fault 2: the projection on with-halo states is functional, like
    the JAX step (the bottom wall plane went into ``w`` in place)."""
    size = (12, 10, 8)
    _, tm = models(size, **FLAGSHIP)
    rng = np.random.default_rng(4)
    state = tm.initial_state(**initial_values(size, seed=4))
    sol = {k: v + torch.as_tensor(1e-3 * rng.standard_normal(v.shape))
           for k, v in state["solution"].items()}
    state = dict(state, solution=sol)
    before = {k: v.clone() for k, v in sol.items()}
    out = tm.project_velocities(state, DT)
    for k in sol:
        assert torch.equal(state["solution"][k], before[k]), k
    assert not torch.equal(out["solution"]["w"], sol["w"])
    w0 = tm.grid.interior(sol["w"])
    tm._fast_project_interior(tm.grid.interior(sol["u"]),
                              tm.grid.interior(sol["v"]), w0, 0.0, DT)
    assert torch.equal(sol["w"], before["w"])


def test_clock_carries_the_rk3_stage():
    """Fault 3: ``Clock.tick(dt, stage=...)`` as in the JAX clock."""
    tc, jc = T.Clock(0.5, 7), JClock(0.5, 7)
    for stage in (True, True, False):
        tc, jc = tc.tick(0.25, stage=stage), jc.tick(0.25, stage=stage)
        assert (tc.time, tc.iteration, tc.stage) == (jc.time, jc.iteration,
                                                     jc.stage)
    assert (tc.iteration, tc.stage) == (8, 0)


@pytest.mark.parametrize("config", ["rk3", "ab2-fused", "ab2-value-wall"])
def test_state_from_numpy_gives_g_prev_the_layout_of_the_step(config):
    """Fault 4: ``G_prev`` keeps the JAX layout of each step (halo-free
    only for the fused AB2 branch with z-halo-free walls), whichever
    layout the JAX state had."""
    size = (12, 10, 8)
    kw = dict(f=2.0, nu=1e-3, kappa=2e-3, timestepper="QuasiAdamsBashforth2")
    if config == "rk3":
        kw["timestepper"] = "RungeKutta3"
    elif config == "ab2-value-wall":
        kw["bcs"] = {"w": {"top": 1e-3}}
    jm, tm = models(size, **kw)
    assert tm.g_interior == (config == "ab2-fused")
    want = size if tm.g_interior else tm.grid.total_shape
    assert tm.initial_state()["G_prev"]["u"].shape == want
    js = jm.initial_state(**initial_values(size, seed=5))
    js = jax.tree_util.tree_map(np.asarray, jax.jit(jm.step)(js, DT))
    inner = {k: v[tm.grid.interior_slices] for k, v in js["G_prev"].items()}
    for gp in (js["G_prev"], inner):
        ts = state_from_numpy(tm, dict(js, G_prev=gp))
        for k, g in ts["G_prev"].items():
            assert g.shape == want
            assert np.array_equal(tm.grid.interior(g).numpy(), inner[k])
    stepped = tm.step(ts, DT)
    assert state_to_numpy(stepped)["G_prev"]["u"].shape == want
    # a state carrying the other layout (another branch's) steps the same
    other = {k: (tm.grid.pad(g) if tm.g_interior else tm.grid.interior(g))
             for k, g in ts["G_prev"].items()}
    again = tm.step(dict(ts, G_prev=other), DT)
    for k in stepped["solution"]:
        assert torch.equal(again["solution"][k], stepped["solution"][k])
