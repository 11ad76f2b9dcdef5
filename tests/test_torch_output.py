"""Port parity: output writers, time averages, checkpoints and readers
(the port's counterpart of ``tests/test_output.py``).

Each package runs the same shallow-water simulation (16×16×1 fp64,
WENO5, uh = 0.1 sin x, h = 1) with a writer, and the two files must have
the same structure (groups, datasets, dimensions, attributes, times and
iterations exactly) and the same values to 1e-12 of max|field| (the
models' own parity). ``WindowedTimeAverage`` is held to the hand
integral, and bit for bit to the JAX object on the same fp32 samples (the
port's sum stays a tensor). Checkpoints continue bit for bit in every
model kind (quasi-AB2 on the fused and the general branch, RK3,
split-explicit, shallow water), pick up by iteration and path, and prune
to ``keep``. JAX checkpoints restart in the port (the natural layout, the
hydrostatic ``"xzy"`` layout, a hydrostatic state without w and pHY′ and
with an x/y-interior ``G_prev``): the restored state is the JAX one, and
the port continues within 1e-9 of max|field| of JAX continuing from the
same file; a port checkpoint restarts the JAX plain path likewise. The
readers of both packages read both packages' files. Without h5py the
package imports, a classic NetCDF writer and checkpoints run, and the
HDF5 writer raises ``ImportError``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.output import checkpointer as tck

try:  # this file needs JAX; the guard keeps collection quiet without it
    import jax
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.output import checkpointer as jck
    from clima_oceananigans_jl_tpu.output import readers as jreaders
    from clima_oceananigans_jl_tpu.output import writers as jwriters
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
RTOL = 1e-9
ROOT = Path(__file__).resolve().parent.parent


def P(side):
    return J if side == "jax" else T


def sw_sim(side, stop=6, dt=1e-3):
    p = P(side)
    kw = dict(size=(16, 16, 1), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
              topology=(p.PERIODIC, p.PERIODIC, p.FLAT))
    if side == "jax":
        g = J.RectilinearGrid(dtype=jnp.float64, **kw)
    else:
        g = T.RectilinearGrid(dtype=torch.float64, device=DEVICE, **kw)
    model = p.ShallowWaterModel(g, gravitational_acceleration=10.0, advection=p.WENO5())
    sin = jnp.sin if side == "jax" else torch.sin
    state = model.initial_state(uh=lambda x, y, z: 0.1 * sin(x), h=1.0)
    return p.Simulation(model, state=state, dt=dt, stop_iteration=stop)


def close(ref, got, rtol=1e-12):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert np.abs(ref - got).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def h5_tree(path):
    """{dataset path: (shape, dtype, attributes)} of an HDF5 file."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = sorted(f.attrs)
        f.visititems(lambda name, obj: out.__setitem__(name, (
            obj.shape, str(obj.dtype), sorted(obj.attrs))) if hasattr(obj, "shape") else None)
    return out


# -- writers --------------------------------------------------------------------------
def test_hdf5_writer_matches_jax(tmp_path):
    import h5py
    paths = {}
    for side in ("jax", "torch"):
        sim = sw_sim(side)
        paths[side] = str(tmp_path / f"{side}.h5")
        sim.output_writers["fields"] = P(side).HDF5OutputWriter(
            dict(h="h", uh="uh"), paths[side], schedule=P(side).IterationInterval(2))
        sim.run()
    assert h5_tree(paths["jax"]) == h5_tree(paths["torch"])
    with h5py.File(paths["jax"], "r") as fj, h5py.File(paths["torch"], "r") as ft:
        assert sorted(ft["timeseries/h"]) == ["0", "1", "2", "3"]
        for name in ("t", "iteration"):
            for i in ft[f"timeseries/{name}"]:
                assert ft[f"timeseries/{name}/{i}"][()] == fj[f"timeseries/{name}/{i}"][()]
        for name in ("h", "uh"):
            for i in ft[f"timeseries/{name}"]:
                close(fj[f"timeseries/{name}/{i}"][()], ft[f"timeseries/{name}/{i}"][()])


def test_netcdf4_writer_matches_jax(tmp_path):
    import h5py
    paths = {}
    for side in ("jax", "torch"):
        sim = sw_sim(side)
        paths[side] = str(tmp_path / f"{side}.nc")
        w = P(side).NetCDFOutputWriter(dict(h="h", uh="uh"), paths[side],
                                       schedule=P(side).IterationInterval(3))
        sim.output_writers["nc"] = w
        sim.run()
        w.close()
    assert h5_tree(paths["jax"]) == h5_tree(paths["torch"])
    with h5py.File(paths["jax"], "r") as fj, h5py.File(paths["torch"], "r") as ft:
        assert ft.attrs["_NCProperties"] == fj.attrs["_NCProperties"]
        h = ft["h"]
        assert h.shape == (3, 16, 16, 1) and h.dims[0][0].name == "/time"
        assert [d[0].name for d in h.dims] == [d[0].name for d in fj["h"].dims]
        assert list(h.attrs["DIMENSION_LABELS"]) == list(fj["h"].attrs["DIMENSION_LABELS"])
        np.testing.assert_array_equal(ft["time"][()], fj["time"][()])
        for name in ("h", "uh"):
            close(fj[name][()], ft[name][()])


def test_netcdf_classic_writer_matches_jax(tmp_path):
    from scipy.io import netcdf_file
    paths = {}
    for side in ("jax", "torch"):
        sim = sw_sim(side)
        paths[side] = str(tmp_path / f"{side}.nc")
        w = P(side).NetCDFOutputWriter(dict(h="h"), paths[side], format="classic",
                                       schedule=P(side).IterationInterval(3),
                                       indices=(None, (2, 9), None))
        sim.output_writers["nc"] = w
        sim.run()
        w.close()
    with netcdf_file(paths["jax"], "r", mmap=False) as fj, \
            netcdf_file(paths["torch"], "r", mmap=False) as ft:
        assert fj.dimensions == ft.dimensions and sorted(fj.variables) == sorted(ft.variables)
        assert ft.variables["h"].dimensions == ("time", "x16", "y7", "z1")
        assert ft.variables["time"].units == fj.variables["time"].units
        np.testing.assert_array_equal(ft.variables["time"][:], fj.variables["time"][:])
        close(fj.variables["h"][:], ft.variables["h"][:])


def test_netcdf4_gzip_of_a_device_tensor(tmp_path):
    """A callable output returning a tensor, gzip-compressed: a fraction of
    the raw bytes, read back exactly."""
    import h5py

    class Sim:
        def model_time(self):
            return 0.0

    field = torch.zeros((512, 512, 4), dtype=torch.float32)
    field[100:200, 100:200] = 1.0
    path = str(tmp_path / "big.nc")
    w = T.NetCDFOutputWriter(dict(c=lambda s: field), path, compression=4)
    w.write(Sim())
    w.write(Sim())
    w.close()
    assert os.path.getsize(path) < 2 * field.numel() * 4 / 10
    with h5py.File(path, "r") as f:
        assert f["c"].compression == "gzip"
        np.testing.assert_array_equal(f["c"][1], field.numpy())


# -- time averages ---------------------------------------------------------------------------
class TinySim:
    def __init__(self):
        self.t = 0.0

    def model_time(self):
        return self.t


def drive_average(mod, schedule, samples, as_tensor):
    """A WindowedTimeAverage of ``mod`` over ``samples`` [(t, value)]: its
    results at each firing of ``schedule`` and after the last sample."""
    sim = TinySim()
    box = {}
    fetch = (lambda s: torch.as_tensor(box["v"])) if as_tensor else (lambda s: box["v"])
    wta = mod.WindowedTimeAverage(fetch, schedule=schedule)
    out = []
    for k, (t, v) in enumerate(samples):
        sim.t, box["v"] = t, v
        wta(sim)
        if schedule is not None and schedule(sim):
            r = wta.result()
            out.append(r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r))
    r = wta.result()
    out.append(r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r))
    return out


def test_windowed_time_average_matches_hand_integral():
    sim = TinySim()
    box = {}
    wta = T.WindowedTimeAverage(lambda s: torch.tensor([box["v"]], dtype=torch.float64))
    dts, vals = [0.5, 0.25, 0.25, 1.0], [1.0, 2.0, 3.0, 4.0, 5.0]
    box["v"] = vals[0]
    wta(sim)
    num = 0.0
    for dt, v in zip(dts, vals[1:]):
        sim.t += dt
        box["v"] = v
        wta(sim)
        num += dt * v
    assert wta.result().item() == num / sum(dts)
    assert wta.result().item() == vals[-1]  # reset: the latest sample
    sched = T.AveragedTimeInterval(10.0, window=4.0, stride=2)
    sim = TinySim()
    wta = T.WindowedTimeAverage(lambda s: torch.tensor([box["v"]], dtype=torch.float64),
                                schedule=sched)
    kept = []
    for k in range(11):
        sim.t = box["v"] = float(k)
        wta(sim)
        if sched.collecting(sim.t):
            kept.append(sim.t)
    kept = kept[::2]
    num = sum((t1 - t0) * t1 for t0, t1 in zip(kept[:-1], kept[1:]))
    assert wta.result().item() == pytest.approx(num / (kept[-1] - kept[0]), rel=1e-15)


@pytest.mark.parametrize("averaged", [False, True], ids=["every-iteration", "window-stride"])
def test_windowed_time_average_is_bitwise_the_jax_object(averaged):
    """fp32 samples at uneven times: the port's tensor sum and the JAX
    object's numpy sum give the same bits at every firing."""
    rng = np.random.default_rng(3)
    t, samples = 0.0, []
    for _ in range(40):
        t += float(rng.uniform(0.01, 0.3))
        samples.append((t, rng.standard_normal((5, 4, 3)).astype(np.float32)))
    make = (lambda m: m.AveragedTimeInterval(2.0, window=1.1, stride=2)) if averaged \
        else (lambda m: m.TimeInterval(1.2))
    from clima_oceananigans_jl_torch.utils import schedules as ts
    from clima_oceananigans_jl_tpu.utils import schedules as js
    ref = drive_average(jwriters, make(js), samples, as_tensor=False)
    got = drive_average(T, make(ts), samples, as_tensor=True)
    assert len(got) == len(ref) > 3
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype == np.float32 and r.tobytes() == g.tobytes()


def test_averaged_time_interval_outputs_are_wrapped(tmp_path):
    import h5py
    paths = {}
    for side in ("jax", "torch"):
        sim = sw_sim(side, stop=12)
        paths[side] = str(tmp_path / f"{side}.h5")
        w = P(side).HDF5OutputWriter(dict(h="h"), paths[side],
                                     schedule=P(side).AveragedTimeInterval(5e-3, window=3e-3))
        sim.output_writers["avg"] = w
        sim.run()
        assert isinstance(w.outputs["h"], P(side).WindowedTimeAverage)
        assert sim.diagnostics["_wta_avg_h"] is w.outputs["h"]
    with h5py.File(paths["jax"], "r") as fj, h5py.File(paths["torch"], "r") as ft:
        assert sorted(ft["timeseries/h"]) == sorted(fj["timeseries/h"]) == ["0", "1", "2"]
        for i in ft["timeseries/h"]:
            assert ft[f"timeseries/t/{i}"][()] == fj[f"timeseries/t/{i}"][()]
            close(fj[f"timeseries/h/{i}"][()], ft[f"timeseries/h/{i}"][()])


# -- checkpoints -------------------------------------------------------------------------------
def nh_model(kind):
    kw = dict(advection=T.WENO5(), buoyancy=T.BuoyancyTracer())
    topology = ("periodic", "periodic", "bounded")
    if kind == "ab2 general":  # a bounded x: the general AB2 branch
        topology = ("bounded", "periodic", "bounded")
    if kind == "rk3":
        kw.update(timestepper="RungeKutta3", coriolis=T.FPlane(f=1e-4),
                  closure=T.ScalarDiffusivity(nu=1e-5, kappa=1e-5))
    g = T.RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                          topology=topology, dtype=torch.float64, device=DEVICE)
    m = T.NonhydrostaticModel(g, **kw)
    rng = np.random.default_rng(0)
    return m, m.initial_state(**{n: 0.05 * rng.standard_normal(g.shape) for n in "uvb"}), 0.02


def hydrostatic_model(size=(16, 8, 6), dt=600.0):
    g = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-75, 75),
                                z=(-3000.0, 0.0), dtype=torch.float64, device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(
        g, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T",),
        free_surface=T.SplitExplicitFreeSurface(substeps=8),
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer())
    rng = np.random.default_rng(1)
    s = m.initial_state(u=0.1 * rng.standard_normal(g.shape), T=rng.standard_normal(g.shape),
                        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    return m, s, dt


def sw_model():
    sim = sw_sim("torch")
    return sim.model, sim.state, 1e-3


CONTINUATION = {"ab2 fused": lambda: nh_model("ab2 fused"),
                "ab2 general": lambda: nh_model("ab2 general"),
                "rk3": lambda: nh_model("rk3"),
                "split-explicit": hydrostatic_model, "shallow water": sw_model}


@pytest.mark.parametrize("kind", list(CONTINUATION))
def test_checkpoint_continues_bit_for_bit(kind, tmp_path):
    m, s, dt = CONTINUATION[kind]()
    if kind == "ab2 fused":
        assert m.fused_step and m.g_interior
    if kind == "ab2 general":
        assert not m.fused_step
    a = T.Simulation(m, state=s, dt=dt, stop_iteration=10)
    a.run()
    m, s, dt = CONTINUATION[kind]()
    b = T.Simulation(m, state=s, dt=dt, stop_iteration=5)
    ckp = T.Checkpointer(schedule=T.IterationInterval(5), dir=str(tmp_path / "ckp"))
    b.output_writers["checkpointer"] = ckp
    b.run()
    m, s, dt = CONTINUATION[kind]()
    c = T.Simulation(m, state=s, dt=dt, stop_iteration=10)
    c.output_writers["checkpointer"] = ckp
    c.run(pickup=True)
    assert c.model_iteration() == 10
    ref, got = tck._flatten_state(a.state), tck._flatten_state(c.state)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and np.array_equal(ref[k], got[k]), k


def test_pickup_by_iteration_and_path_and_keep(tmp_path):
    sim = sw_sim("torch", stop=8)
    ckp = T.Checkpointer(schedule=T.IterationInterval(2), dir=str(tmp_path / "c"), keep=3)
    sim.output_writers["checkpointer"] = ckp
    sim.run()
    names = sorted(os.path.basename(p) for p in ckp._all())
    assert names == [f"checkpoint_iteration{i}.npz" for i in (4, 6, 8)]
    assert ckp.latest() == ckp.checkpoint_path(8)
    sim2 = sw_sim("torch", stop=10)
    sim2.output_writers["checkpointer"] = ckp
    assert tck.pickup_latest(sim2, 4) and sim2.model_iteration() == 4
    assert tck.pickup_latest(sim2, ckp.checkpoint_path(6)) and sim2.model_iteration() == 6
    assert not tck.pickup_latest(sim2, 2)  # pruned
    with np.load(ckp.checkpoint_path(8)) as f:
        assert str(f["__state_layout"]) == "natural"
        assert str(f["__package"]) == "clima_oceananigans_jl_torch"
        assert f["state/clock/__clock_time"].dtype == np.float64
        assert {"state/solution/h", "state/clock/__clock_iteration"} <= set(f.files)


# -- JAX checkpoints in the port, and back ----------------------------------------------------------
def jax_hydrostatic(size, fused):
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
    g = LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-60, 60),
                              z=(-1000.0, 0), dtype=jnp.float64)
    return J.HydrostaticFreeSurfaceModel(
        g, momentum_advection=J.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=J.WENO5(), tracers=("T",),
        free_surface=J.SplitExplicitFreeSurface(substeps=8),
        coriolis=J.HydrostaticSphericalCoriolis(), buoyancy=J.BuoyancyTracer(),
        fused_advection=fused)


def port_hydrostatic(size):
    g = T.LatitudeLongitudeGrid(size=size, longitude=(0, 360), latitude=(-60, 60),
                                z=(-1000.0, 0), dtype=torch.float64, device=DEVICE)
    return T.HydrostaticFreeSurfaceModel(
        g, momentum_advection=T.VectorInvariant(scheme="weno_velocity"),
        tracer_advection=T.WENO5(), tracers=("T",),
        free_surface=T.SplitExplicitFreeSurface(substeps=8),
        coriolis=T.HydrostaticSphericalCoriolis(), buoyancy=T.BuoyancyTracer())


JAX_CHECKPOINTS = {
    # (size, the JAX fused path, its layout, whether its state carries w and pHY′)
    "natural": ((16, 16, 8), False, None, True),
    "xzy": ((32, 64, 8), True, "xzy", False),
    "no w, pHY": ((16, 16, 8), True, None, False),
}


def centred(a, shape):
    """The centred ``shape`` block of a with-halo array."""
    a = np.asarray(a)
    return a[tuple(slice((t - n) // 2, (t - n) // 2 + n) for t, n in zip(a.shape, shape))]


class StubSim:
    def __init__(self, model, state):
        self.model, self.state = model, state

    def model_iteration(self):
        return int(self.state["clock"].iteration)


@pytest.mark.parametrize("case", list(JAX_CHECKPOINTS))
def test_jax_hydrostatic_checkpoint_restarts_in_the_port(case, tmp_path, monkeypatch):
    size, fused, layout, with_w = JAX_CHECKPOINTS[case]
    monkeypatch.delenv("CLIMA_NO_XZY", raising=False)
    jm = jax_hydrostatic(size, fused)
    assert jm.state_layout == layout and (fused or not jm.wphy_in_kernel)
    cos = lambda lam, phi, z: 0.05 * jnp.cos(jnp.deg2rad(phi))
    js = jm.initial_state(u=cos, T=lambda lam, phi, z: 10.0 + 1e-3 * z,
                          b=lambda lam, phi, z: 2e-5 * (z + 1000.0) / 1000.0)
    step = jax.jit(jm.step)
    for _ in range(2):
        js = step(js, jnp.float64(100.0))
    assert ("w" in js and "pHY" in js) == with_w
    ckp = J.Checkpointer(schedule=J.IterationInterval(1), dir=str(tmp_path))
    ckp.write(StubSim(jm, js))
    path = ckp.checkpoint_path(2)
    tm = port_hydrostatic(size)
    ts = tck.restore_state(tm.initial_state(), path, model=tm)
    assert ts["clock"].iteration == 2 and ts["previous_dt"] == 100.0
    js = jck.restore_state(jm.initial_state(), path, model=jm)
    # the JAX arrays' interiors, (x, z, y) ones transposed back
    nat = lambda a: centred(np.transpose(a, (0, 2, 1)) if layout else a, size)
    for name in tm.prognostic_names():
        assert np.array_equal(tm.grid.interior(ts["solution"][name]).numpy(),
                              nat(js["solution"][name])), name
    for _ in range(3):
        js = step(js, jnp.float64(100.0))
        ts = tm.step(ts, 100.0)
    for name in tm.prognostic_names():
        ref = nat(js["solution"][name])
        got = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), name


def test_jax_nonhydrostatic_checkpoint_restarts_in_the_port(tmp_path):
    jg = J.RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                           topology=("periodic", "periodic", "bounded"), dtype=jnp.float64)
    jm = J.NonhydrostaticModel(jg, advection=J.WENO5(), buoyancy=J.BuoyancyTracer(),
                               fused_advection=False)
    tm, _, dt = nh_model("ab2 fused")
    rng = np.random.default_rng(0)
    js = jm.initial_state(**{n: 0.05 * rng.standard_normal((8, 8, 8)) for n in "uvb"})
    step = jax.jit(jm.step)
    for _ in range(3):
        js = step(js, dt)
    ckp = J.Checkpointer(schedule=J.IterationInterval(1), dir=str(tmp_path))
    ckp.write(StubSim(jm, js))
    sim = T.Simulation(tm, state=tm.initial_state(), dt=dt, stop_iteration=6)
    sim.output_writers["checkpointer"] = T.Checkpointer(dir=str(tmp_path))
    sim.run(pickup=3)
    for _ in range(3):
        js = step(js, dt)
    for name in tm.prognostic_names():
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(sim.state["solution"][name]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), name


def test_port_checkpoint_restarts_the_jax_plain_path(tmp_path):
    tg = T.RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=torch.float64, device=DEVICE)
    tm = T.NonhydrostaticModel(tg, advection=T.WENO5(), buoyancy=T.BuoyancyTracer(),
                               fused_advection=False)
    jg = J.RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                           topology=("periodic", "periodic", "bounded"), dtype=jnp.float64)
    jm = J.NonhydrostaticModel(jg, advection=J.WENO5(), buoyancy=J.BuoyancyTracer(),
                               fused_advection=False)
    rng = np.random.default_rng(2)
    sim = T.Simulation(tm, state=tm.initial_state(
        **{n: 0.05 * rng.standard_normal((8, 8, 8)) for n in "uvb"}), dt=0.02, stop_iteration=3)
    ckp = T.Checkpointer(schedule=T.IterationInterval(3), dir=str(tmp_path))
    sim.output_writers["checkpointer"] = ckp
    sim.run()
    js = jck.restore_state(jm.initial_state(), ckp.checkpoint_path(3), model=jm)
    assert int(js["clock"].iteration) == 3
    step = jax.jit(jm.step)
    ts = sim.state
    for _ in range(3):
        js = step(js, 0.02)
        ts = tm.step(ts, 0.02)
    for name in tm.prognostic_names():
        ref = np.asarray(jm.grid.interior(js["solution"][name]))
        got = tm.grid.interior(ts["solution"][name]).numpy()
        assert np.abs(ref - got).max() <= RTOL * np.abs(ref).max(), name


# -- readers ------------------------------------------------------------------------------
def test_readers_read_both_packages_files(tmp_path):
    paths = {}
    for side in ("jax", "torch"):
        sim = sw_sim(side)
        paths[side] = str(tmp_path / f"{side}.h5")
        sim.output_writers["fields"] = P(side).HDF5OutputWriter(
            dict(h="h", uh="uh"), paths[side], schedule=P(side).IterationInterval(2))
        sim.run()
    for path in paths.values():
        for name in ("h", "uh"):
            ref = jreaders.FieldTimeSeries(path, name)
            got = T.FieldTimeSeries(path, name)
            disk = T.FieldTimeSeries(path, name, backend="disk")
            assert len(got) == len(ref) == len(disk) == 4
            np.testing.assert_array_equal(got.times, ref.times)
            np.testing.assert_array_equal(got.iterations, ref.iterations)
            np.testing.assert_array_equal(got.data, ref.data)
            np.testing.assert_array_equal(disk.data, ref.data)
            np.testing.assert_array_equal(disk[2], ref[2])
        assert set(T.FieldDataset(path).keys()) == {"h", "uh"}
    close(jreaders.FieldTimeSeries(paths["jax"], "uh").data,
          T.FieldTimeSeries(paths["torch"], "uh").data)


# -- without h5py ---------------------------------------------------------------------------
NO_H5PY = """
import json, os, sys, tempfile
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "h5py":
            raise ImportError("no h5py here")
        return None
sys.meta_path.insert(0, Refuse())
import numpy as np, torch
import clima_oceananigans_jl_torch as T
out = {}
with tempfile.TemporaryDirectory() as d:
    def sim(stop):
        g = T.RectilinearGrid(size=(4, 4, 4), extent=(1, 1, 1),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=torch.float64, device="cpu")
        m = T.NonhydrostaticModel(g, advection=T.WENO5(), buoyancy=T.BuoyancyTracer())
        rng = np.random.default_rng(0)
        s = T.Simulation(m, state=m.initial_state(u=0.01 * rng.standard_normal((4, 4, 4))),
                         dt=0.01, stop_iteration=stop)
        s.output_writers["checkpointer"] = T.Checkpointer(T.IterationInterval(2), dir=d)
        return s
    a = sim(4)
    nc = T.NetCDFOutputWriter(dict(u="u"), os.path.join(d, "u.nc"), format="classic",
                              schedule=T.IterationInterval(2))
    a.output_writers["nc"] = nc
    a.run()
    nc.close()
    b = sim(4)
    b.run(pickup=2)
    out["continued"] = bool(torch.equal(a.state["solution"]["u"], b.state["solution"]["u"]))
    from scipy.io import netcdf_file
    with netcdf_file(os.path.join(d, "u.nc"), "r", mmap=False) as f:
        out["records"] = int(f.variables["u"].shape[0])
    w = T.HDF5OutputWriter(dict(u="u"), os.path.join(d, "u.h5"))
    try:
        w.write(a)
        out["hdf5"] = "wrote"
    except ImportError as e:
        out["hdf5"] = str(e)
out["h5py_loaded"] = "h5py" in sys.modules
print(json.dumps(out))
"""


def test_the_package_runs_without_h5py():
    res = subprocess.run([sys.executable, "-c", NO_H5PY], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"continued": True, "records": 3, "hdf5": "no h5py here",
                   "h5py_loaded": False}
