"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at 256³ fp32 through
``clima_oceananigans_jl_torch`` on the card, in phases; each prints one
line or a few:

1. device: the card's name and power limit as nvidia-smi gives them, on a
   line of their own; no card → error;
2. build: compiles ``csrc/fused_ab2_advance.cu`` (K1) and
   ``csrc/fused_advective_tendencies.cu`` (K2) with nvcc (sm_90a), one
   process each, both at once;
3. K1 against its plain PyTorch version on the same inputs: the ``bench.py``
   configuration at 256³ fp32 (Euler and AB2 form) and 64³ fp64, then with
   its options, ``FPlane(f=1e-4)`` + ``ScalarDiffusivity(nu=1e-5,
   kappa=1e-5)`` at 256³ fp32 and ``BetaPlane`` + the same diffusivity at
   64³ fp64; max|Δ| ≤ 1e-6·max|ref| in fp32 and ≤ 1e-13·max|ref| in fp64;
   K1's time (CUDA events, 20 calls) and the plain version's (3 calls);
4. K2 against its plain version: 256³ fp32 WENO5/WENO5 with u, v, w, b and
   64³ fp64 WENO5 momentum with two centred tracers, same bounds; times;
5. AB2 path: the ``bench.py`` configuration built through the public API,
   2 warm-up and 20 timed steps at Δt = 1e-4, with K1 and then with the
   plain version; fields finite, one K1 launch per step (no K2),
   max|∇·u|·Δx/max|u| ≤ 1e-5, and the two runs agree to ≤ 1e-4;
6. RK3 path: the flagship configuration of ``__graft_entry__.py``
   (WENO5, BuoyancyTracer, FPlane(f=1e-4), ScalarDiffusivity(nu=1e-5,
   kappa=1e-5), RK3), 2 warm-up and 10 timed steps at Δt = 1e-3, with K2
   and then with its plain version; the same checks, with exactly 3 K2
   launches per step (no K1).

Then a JSON line with each kernel's record, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. The port is imported first, so a copy of this file
outside the repository fails at once.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from clima_oceananigans_jl_torch import (BOUNDED, PERIODIC, BetaPlane,
                                         BuoyancyTracer, CenteredSecondOrder,
                                         FPlane, NonhydrostaticModel,
                                         RectilinearGrid, ScalarDiffusivity,
                                         WENO5)
from clima_oceananigans_jl_torch.ops import _build
from clima_oceananigans_jl_torch.ops.fused_step import (
    fused_ab2_advance, fused_ab2_advance_reference)
from clima_oceananigans_jl_torch.ops.fused_tendencies import (
    fused_advective_tendencies, fused_advective_tendencies_reference)

N = 256
DEVICE = "cuda"
K1, K2 = "fused_ab2_advance", "fused_advective_tendencies"
WRAPPERS = {K1: fused_ab2_advance, K2: fused_advective_tendencies}
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
#: (timestepper, Δt, warm-up steps, timed steps, Coriolis and closure)
PATHS = {
    "AB2": ("QuasiAdamsBashforth2", 1e-4, 2, 20, {}),
    "RK3": ("RungeKutta3", 1e-3, 2, 10,
            dict(coriolis=FPlane(f=1e-4),
                 closure=ScalarDiffusivity(nu=1e-5, kappa=1e-5))),
}
#: kernel launches per step of each path
PER_STEP = {"AB2": {K1: 1, K2: 0}, "RK3": {K1: 0, K2: 3}}


def model_for(n, dtype, **kw):
    grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=dtype, device=DEVICE)
    return NonhydrostaticModel(grid, advection=WENO5(),
                               buoyancy=BuoyancyTracer(), **kw)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


def phase_build():
    t0 = time.perf_counter()
    _build.build(K1, K2)
    for k in (K1, K2):
        print(f"build: {k} in {_build.build_seconds[k]:.1f} s "
              f"({_build.library_path(k).name})")
    print(f"build: both in {time.perf_counter() - t0:.1f} s")


def hold(label, got, ref, dtype, interior=None):
    """max|Δ| of each pair of dicts of tensors against its bound; raises
    on the first one over it. Returns the largest max|Δ|."""
    tol = TOL[dtype]
    worst, rel, bitwise = 0.0, 0.0, True
    for kind in got:
        for name, r in ref[kind].items():
            g = got[kind][name]
            if interior is not None:
                g, r = interior(g), interior(r)
            err = float((g - r).abs().max())
            scale = float(r.abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"{label} {kind}[{name}]: max|diff| "
                                     f"{err:.3e} > {tol * scale:.3e}")
            worst = max(worst, err)
            rel = max(rel, err / scale if scale else 0.0)
            bitwise &= torch.equal(g, r)
    print(f"{label}: max|diff| {worst:.3e}, {rel:.3e} of max|ref| (bound "
          f"{tol:g}), bitwise={bitwise}")
    return worst


def random_state(model, seed):
    rng = np.random.default_rng(seed)
    shape = model.grid.shape
    rand = lambda s: s * rng.standard_normal(shape)
    state = model.initial_state(u=rand(1e-2), v=rand(1e-2), w=rand(1e-3),
                                b=rand(1e-4))
    g_shape = shape if model.g_interior else model.grid.total_shape
    state["G_prev"] = {
        k: torch.as_tensor(1e-2 * rng.standard_normal(g_shape),
                           dtype=model.grid.dtype, device=DEVICE)
        for k in model.prognostic_names()}
    return state


def phase_k1():
    """K1 against its plain version, without and with its options; returns
    (max_abs_err, ms, plain_ms) at 256³ fp32, the times of the bench
    configuration."""
    options = dict(coriolis=FPlane(f=1e-4),
                   closure=ScalarDiffusivity(nu=1e-5, kappa=1e-5))
    beta = dict(coriolis=BetaPlane(f0=1e-4, beta=1e-2),
                closure=ScalarDiffusivity(nu=1e-5, kappa=1e-5))
    worst, times = 0.0, {}
    for n, dtype, name, kw in ((N, torch.float32, "bench", {}),
                               (64, torch.float64, "bench", {}),
                               (N, torch.float32, "fplane+diffusion", options),
                               (64, torch.float64, "betaplane+diffusion", beta)):
        model = model_for(n, dtype, **kw)
        if not model.fused_step:
            raise AssertionError(f"K1 {name}: the model does not take K1")
        state = random_state(model, 1)
        interior = None if model.g_interior else model.grid.interior
        for euler in (True, False):
            psi_k, g_k = fused_ab2_advance(model, state, 1e-4, euler)
            psi_r, g_r = fused_ab2_advance_reference(model, state, 1e-4, euler)
            err = hold(f"K1 {name} {n}^3 {str(dtype)[6:]} "
                       f"{'euler' if euler else 'ab2'}",
                       {"psi'": psi_k, "G": g_k}, {"psi'": psi_r, "G": g_r},
                       dtype, interior)
            if n == N:
                worst = max(worst, err)
        if n == N:
            ms = cuda_ms(lambda: fused_ab2_advance(model, state, 1e-4, False), 20)
            plain_ms = cuda_ms(lambda: fused_ab2_advance_reference(
                model, state, 1e-4, False), 3)
            times[name] = (ms, plain_ms)
            print(f"K1 {name} {n}^3 fp32 ab2 time: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (CUDA events)")
        del model, state
        torch.cuda.empty_cache()
    return (worst, *times["bench"])


def phase_k2():
    """K2 against its plain version; returns (max_abs_err, ms, plain_ms)
    at 256³ fp32."""
    model = model_for(N, torch.float32)
    sol = random_state(model, 2)["solution"]
    grid = model.grid
    args = (grid, WENO5(), WENO5(), sol["u"], sol["v"], sol["w"],
            {"b": sol["b"]})
    worst = hold(f"K2 WENO5/WENO5 {N}^3 fp32",
                 {"G": fused_advective_tendencies(*args)},
                 {"G": fused_advective_tendencies_reference(*args)},
                 torch.float32, grid.interior)
    ms = cuda_ms(lambda: fused_advective_tendencies(*args), 20)
    plain_ms = cuda_ms(lambda: fused_advective_tendencies_reference(*args), 3)
    print(f"K2 WENO5/WENO5 {N}^3 fp32 time: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (CUDA events)")
    del model, sol, args
    torch.cuda.empty_cache()
    grid = RectilinearGrid(size=(64, 64, 64), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    rng = np.random.default_rng(3)
    f = [torch.as_tensor(rng.standard_normal(grid.total_shape), device=DEVICE)
         for _ in range(5)]
    args = (grid, WENO5(), CenteredSecondOrder(), f[0], f[1], f[2],
            {"c1": f[3], "c2": f[4]})
    hold("K2 WENO5/centred 64^3 fp64, two tracers",
         {"G": fused_advective_tendencies(*args)},
         {"G": fused_advective_tendencies_reference(*args)},
         torch.float64, grid.interior)
    return worst, ms, plain_ms


def drive(path, plain):
    """Build the path's model at 256³ fp32 and run its warm-up and timed
    steps, with the kernels or (``plain``) their plain versions. Every
    launch count is set to 0 just before the run and read just after."""
    timestepper, dt, warmup, steps, kw = PATHS[path]
    model = model_for(N, torch.float32, timestepper=timestepper, **kw)
    rng = np.random.default_rng(0)
    shape = model.grid.shape
    state = model.initial_state(u=1e-2 * rng.standard_normal(shape),
                                v=1e-2 * rng.standard_normal(shape),
                                b=1e-4 * rng.standard_normal(shape))
    advance, advect = ((fused_ab2_advance_reference,
                        fused_advective_tendencies_reference) if plain
                       else (fused_ab2_advance, fused_advective_tendencies))
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    for _ in range(warmup):
        state = model.step(state, dt, advance=advance, advect=advect)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = model.step(state, dt, advance=advance, advect=advect)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    expected = {k: 0 if plain else n * (warmup + steps)
                for k, n in PER_STEP[path].items()}
    if launches != expected:
        raise AssertionError(f"{path} path: kernel launches {launches}, "
                             f"expected {expected}")
    return model, state, per_step, launches


def divergence_ratio(model, state):
    """max|∇·u|·Δx / max|u| over the interior of a filled state."""
    g = model.grid
    sol = state["solution"]
    (hx, hy, hz), (nx, ny, nz) = g.halo, g.shape
    cut = lambda a, di=0, dj=0, dk=0: a[hx + di:hx + di + nx,
                                        hy + dj:hy + dj + ny,
                                        hz + dk:hz + dk + nz]
    u, v, w = sol["u"], sol["v"], sol["w"]
    div = ((cut(u, di=1) - cut(u)) / (g.Lx / nx)
           + (cut(v, dj=1) - cut(v)) / (g.Ly / ny)
           + (cut(w, dk=1) - cut(w)) / (g.Lz / nz))
    umax = max(float(cut(a).abs().max()) for a in (u, v, w))
    return float(div.abs().max()) * (g.Lx / nx) / umax


def phase_path(path):
    """One path with the kernels, checked, then with the plain versions;
    returns the kernel run's launch counts."""
    model, state, per_step, launches = drive(path, plain=False)
    for name, a in state["solution"].items():
        if tuple(a.shape) != model.grid.total_shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{path} {name}: shape {tuple(a.shape)} or "
                                 "non-finite values")
    for key in ("pHY", "pNHS"):
        if not bool(torch.isfinite(state[key]).all()):
            raise AssertionError(f"{path} {key}: non-finite values")
    ratio = divergence_ratio(model, state)
    if not ratio <= 1e-5:
        raise AssertionError(f"{path}: max|div u|*dx/max|u| = {ratio:.3e} > 1e-5")
    _, _, warmup, steps, _ = PATHS[path]
    print(f"{path} path: {N}^3 fp32, {steps} steps: {per_step * 1e3:.3f} ms/step, "
          f"{N ** 3 / per_step:.6e} grid points/s, launches {launches} in "
          f"{warmup + steps} steps, max|div u|*dx/max|u| {ratio:.3e}")
    kernel_u = {k: model.grid.interior(a) for k, a in state["solution"].items()}
    del state
    model, state, plain_step, _ = drive(path, plain=True)
    worst = max(float((kernel_u[k] - model.grid.interior(a)).abs().max())
                / float(model.grid.interior(a).abs().max())
                for k, a in state["solution"].items())
    if not worst <= 1e-4:
        raise AssertionError(f"{path}: kernel and plain runs differ by "
                             f"{worst:.3e} of max|field| after "
                             f"{warmup + steps} steps")
    print(f"{path} path: plain versions: {plain_step * 1e3:.3f} ms/step, "
          f"{N ** 3 / plain_step:.6e} grid points/s; kernel and plain runs "
          f"agree to {worst:.3e} of max|field|")
    del model, state, kernel_u
    torch.cuda.empty_cache()
    return launches


def main():
    phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches = {K1: phase_path("AB2")[K1], K2: phase_path("RK3")[K2]}
    records = []
    for name, (err, ms, plain_ms), replaces in (
            (K1, k1, "clima_oceananigans_jl_tpu/ops/fused_step.py:129"),
            (K2, k2, "clima_oceananigans_jl_tpu/ops/fused_tendencies.py:397")):
        records.append({
            "name": name, "route": "cuda",
            "source": f"clima_oceananigans_jl_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
