"""Port parity: Lagrangian particles in the three models.

The same numpy-seeded inputs go through the JAX package and the port in
float64:

- one particle step (forward Euler on the trilinearly sampled u, v, w,
  the periodic wrap, the damped reflection at walls, the tracked fields
  sampled at the new positions) on given fields, bit for bit against the
  JAX step run op by op, on a regular, a stretched and a lat-lon grid;
  the wrap (``torch.remainder`` against ``jnp.mod``) and the reflection
  by themselves, bit for bit, far outside the domain too;
- particles in the nonhydrostatic (quasi-AB2 and RK3), hydrostatic and
  shallow-water models: a few steps of the jitted JAX model and of the
  port, positions and tracked properties within ``RTOL`` of the domain's
  size and of max|property| (the models' fields themselves agree to
  ~1e-15, their FFTs and reductions summing in other orders);
- ``interop`` both ways with particles, and the checkpoint behaviour: a
  state with particles is written (the particles as a pickled object
  array, as the JAX package writes them) and its restore raises
  ``ValueError``, as the JAX package's does (ROADMAP, "Not faults").
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch import interop
from clima_oceananigans_jl_torch.output import checkpointer as tck

try:  # no cuda case here, but keep the file importable without JAX
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from clima_oceananigans_jl_tpu.models import free_surface as jfs
    from clima_oceananigans_jl_tpu.models.hydrostatic import (
        HydrostaticFreeSurfaceModel as JH)
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN
    from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel as JSW
    from clima_oceananigans_jl_tpu.output import checkpointer as jck
    from clima_oceananigans_jl_tpu.particles.lagrangian import LagrangianParticles as JLP
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-12


def grid_kw(pkg):
    return (dict(dtype=jnp.float64) if pkg is J
            else dict(dtype=torch.float64, device=DEVICE))


def grids(kind, pkg):
    if kind == "regular":
        return pkg.RectilinearGrid(size=(8, 6, 5), x=(0, 2.0), y=(-1.0, 1.0), z=(-1.0, 0.0),
                                   topology=("periodic", "bounded", "bounded"),
                                   halo=(3, 3, 3), **grid_kw(pkg))
    if kind == "stretched":
        xf = np.tanh(np.linspace(-1.2, 1.2, 9)) / np.tanh(1.2)
        zf = -np.cos(np.linspace(0, np.pi / 2, 6))
        return pkg.RectilinearGrid(size=(8, 6, 5), x=xf, y=(0.0, 1.0), z=zf,
                                   topology=("bounded", "periodic", "bounded"),
                                   halo=(3, 3, 3), **grid_kw(pkg))
    cls = JLL if pkg is J else T.LatitudeLongitudeGrid
    return cls(size=(12, 8, 4), longitude=(0, 360), latitude=(-60, 60), z=(-1000.0, 0.0),
               halo=(3, 3, 3), **grid_kw(pkg))


def domain(grid):
    """(lo, hi) of each axis' interior faces, as numpy."""
    out = []
    for a in range(3):
        ax = grid._axes[a]
        lo = float(np.asarray(ax.cf[ax.h]))
        out.append((lo, lo + ax.extent))
    return out


def particles_arrays(grid, n, seed, spill=0.0):
    """numpy positions, uniform in the domain widened by ``spill`` of each
    extent on either side."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo - spill * (hi - lo), hi + spill * (hi - lo), n)
            for lo, hi in domain(grid)]


def both_particles(xyz, restitution=1.0, tracked=("c",)):
    jp = JLP(*map(jnp.asarray, xyz), {}, restitution, tracked)
    tp = T.LagrangianParticles(*map(torch.as_tensor, xyz), {}, restitution, tracked)
    return jp, tp


def same(j, t):
    a, b = np.asarray(j), t.numpy()
    assert np.array_equal(a, b), np.abs(a - b).max()


@pytest.mark.parametrize("restitution", [1.0, 0.5])
def test_boundaries_bitwise(restitution):
    """The periodic wrap and the damped reflection, then the clip, on
    positions up to two extents outside the domain."""
    jg, tg = grids("regular", J), grids("regular", T)
    xyz = particles_arrays(tg, 4096, 1, spill=2.0)
    jp, tp = both_particles(xyz, restitution)
    for axis in range(3):
        same(jp._apply_boundaries(jnp.asarray(xyz[axis]), jg, axis),
             tp._apply_boundaries(torch.as_tensor(xyz[axis]), tg, axis))


@pytest.mark.parametrize("kind", ["regular", "stretched", "lat-lon"])
def test_particle_step_bitwise(kind):
    """One step of 4096 particles on given u, v, w and c: positions and the
    tracked c bit for bit."""
    jg, tg = grids(kind, J), grids(kind, T)
    rng = np.random.default_rng(2)
    f = {k: rng.standard_normal(tg.total_shape) for k in ("u", "v", "w", "c")}
    scale = {"lat-lon": 5e4}.get(kind, 0.2)
    xyz = particles_arrays(tg, 4096, 3)
    jp, tp = both_particles(xyz, 0.7)
    jv = {k: jnp.asarray(scale * f[k]) for k in ("u", "v", "w")}
    tv = {k: torch.as_tensor(scale * f[k]) for k in ("u", "v", "w")}
    jn = jp.step(jg, jv, 0.5, {"c": jnp.asarray(f["c"])})
    tn = tp.step(tg, tv, 0.5, {"c": torch.as_tensor(f["c"])})
    for a in ("x", "y", "z"):
        same(getattr(jn, a), getattr(tn, a))
    same(jn.properties["c"], tn.properties["c"])
    assert len(tn) == 4096 and tn.tracked_fields == ("c",)
    for (lo, hi), q in zip(domain(tg), (tn.x, tn.y, tn.z)):
        assert float(q.min()) >= lo and float(q.max()) <= hi


def close_particles(jp, tp, grid):
    for (lo, hi), a in zip(domain(grid), ("x", "y", "z")):
        ref, got = np.asarray(getattr(jp, a)), getattr(tp, a).numpy()
        assert np.abs(ref - got).max() <= RTOL * max(hi - lo, 1.0), a
    for k, v in jp.properties.items():
        ref, got = np.asarray(v), tp.properties[k].numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), k


def model_case(kind, pkg):
    """(model, initial values, Δt, steps) of each model kind."""
    rng = np.random.default_rng(5)
    if kind in ("nonhydrostatic AB2", "nonhydrostatic RK3"):
        g = pkg.RectilinearGrid(size=(8, 8, 6), extent=(1.0, 1.0, 1.0),
                                topology=("periodic", "periodic", "bounded"), **grid_kw(pkg))
        step = "QuasiAdamsBashforth2" if kind.endswith("AB2") else "RungeKutta3"
        model = (JN if pkg is J else T.NonhydrostaticModel)(
            g, advection=pkg.WENO5(), tracers=("c",), timestepper=step,
            **(dict(fused_advection=False) if pkg is J else {}))
        shape = g.shape
        vals = dict(u=0.1 * rng.standard_normal(shape), v=0.1 * rng.standard_normal(shape),
                    c=rng.standard_normal(shape))
        return model, vals, 0.05, 3
    if kind == "hydrostatic":
        g = pkg.RectilinearGrid(size=(10, 8, 4), x=(0, 1e6), y=(0, 8e5), z=(-1000.0, 0),
                                topology=("periodic", "bounded", "bounded"), **grid_kw(pkg))
        fs = (jfs if pkg is J else T).ExplicitFreeSurface()
        model = (JH if pkg is J else T.HydrostaticFreeSurfaceModel)(
            grid=g, tracers=("c",), free_surface=fs,
            **(dict(fused_advection=False) if pkg is J else {}))
        shape = g.shape
        vals = dict(u=0.2 * rng.standard_normal(shape), v=0.2 * rng.standard_normal(shape),
                    c=rng.standard_normal(shape))
        return model, vals, 600.0, 3
    g = pkg.RectilinearGrid(size=(16, 12, 1), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
                            topology=("periodic", "bounded", "flat"), **grid_kw(pkg))
    model = (JSW if pkg is J else T.ShallowWaterModel)(
        g, gravitational_acceleration=10.0, tracers=("c",))
    shape = g.shape
    vals = dict(uh=0.1 * rng.standard_normal(shape), vh=0.1 * rng.standard_normal(shape),
                c=rng.standard_normal(shape), h=1.0 + 0.01 * rng.standard_normal(shape))
    return model, vals, 1e-2, 3


@pytest.mark.parametrize("kind", ["nonhydrostatic AB2", "nonhydrostatic RK3",
                                  "hydrostatic", "shallow water"])
def test_particles_in_each_model_match_jax(kind):
    """256 particles tracking c through a few steps of each model, against
    the jitted JAX model; the state carries them from ``initial_state``."""
    (jm, vals, dt, steps), (tm, _, _, _) = model_case(kind, J), model_case(kind, T)
    xyz = particles_arrays(tm.grid, 256, 7)
    jp, tp = both_particles(xyz, 0.8)
    jm.particles, tm.particles = jp, tp
    js, ts = jm.initial_state(**vals), tm.initial_state(**vals)
    assert ts["particles"] is tp
    step = jax.jit(jm.step)
    for _ in range(steps):
        js, ts = step(js, jnp.float64(dt)), tm.step(ts, dt)
    assert not np.array_equal(ts["particles"].x.numpy(), xyz[0])
    close_particles(js["particles"], ts["particles"], tm.grid)


def test_particles_pass_through_interop():
    """A JAX state with particles into the port and back, leaf for leaf;
    the JAX model steps the port's state."""
    (jm, vals, dt, _), (tm, _, _, _) = (model_case("nonhydrostatic AB2", J),
                                        model_case("nonhydrostatic AB2", T))
    xyz = particles_arrays(tm.grid, 64, 8)
    jm.particles, _ = both_particles(xyz)
    js = jax.jit(jm.step)(jm.initial_state(**vals), jnp.float64(dt))
    ts = interop.state_from_numpy(tm, jax.tree_util.tree_map(np.asarray, js))
    tp = ts["particles"]
    assert isinstance(tp, T.LagrangianParticles) and tp.x.dtype == torch.float64
    for a in ("x", "y", "z"):
        same(getattr(js["particles"], a), getattr(tp, a))
    same(js["particles"].properties["c"], tp.properties["c"])
    back = interop.state_to_numpy(ts)["particles"]
    assert isinstance(back.x, np.ndarray) and back.tracked_fields == ("c",)
    jp = JLP(*map(jnp.asarray, (back.x, back.y, back.z)),
             {k: jnp.asarray(v) for k, v in back.properties.items()},
             back.restitution, back.tracked_fields)
    for a in ("x", "y", "z"):
        same(getattr(jp, a), getattr(tp, a))


class _Sim:
    def __init__(self, state):
        self.state = state

    def model_iteration(self):
        return 0


def test_checkpoint_with_particles_fails_as_in_jax(tmp_path):
    """Both packages write a state with particles (a pickled object array
    under state/particles) and both restores raise ValueError."""
    _, tp = both_particles(particles_arrays(grids("regular", T), 8, 9))
    ts = {"solution": {"u": torch.zeros(3, dtype=torch.float64)}, "particles": tp,
          "clock": T.Clock(np.float64(0.0), 0)}
    ck = tck.Checkpointer(dir=str(tmp_path / "port"))
    ck.write(_Sim(ts))
    with np.load(ck.checkpoint_path(0), allow_pickle=True) as data:
        assert data["state/particles"].dtype == object
    with pytest.raises(ValueError, match="allow_pickle"):
        tck.restore_state(ts, ck.checkpoint_path(0))
    jp, _ = both_particles(particles_arrays(grids("regular", T), 8, 9))
    js = {"solution": {"u": jnp.zeros(3)}, "particles": jp,
          "clock": J.Clock(jnp.zeros(()), jnp.zeros((), jnp.int32))}
    jc = jck.Checkpointer(dir=str(tmp_path / "jax"))
    jc.write(_Sim(js))
    with pytest.raises(ValueError, match="allow_pickle"):
        jck.restore_state(js, jc.checkpoint_path(0))
