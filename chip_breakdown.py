"""Where the time of the port's hydrostatic ¼° step goes, on one NVIDIA GPU.

    python3 chip_breakdown.py [steps]

Builds the ¼° flagship of ``benchmark/bench_hydro_flagship.py`` through
the public API (as ``chip_smoke.py`` does), takes 3 warm-up steps, then
times ``steps`` steps (default 5) with CUDA events around each part of
the split-explicit step: K4b's advance, the barotropic modes, K5 (with
its wrapper), the corrector, K4a, and K6's two halo fills of
``update_state``; "the rest" is the step's CUDA-event time minus their
sum (c₁G − c₂G⁻, the η̅ fill's clone, Python). Then ``torch.profiler`` over 3 more steps gives
the device's busy time (kernel durations summed) against the host clock:
the idle share. Prints the card's name and power limit first. Needs a
card; without one it exits with an error.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch

from clima_oceananigans_jl_torch.models import hydrostatic as hm
from clima_oceananigans_jl_torch.models.free_surface import SplitExplicitFreeSurface

import chip_smoke


def timed(events, name, fn):
    """``fn`` with a pair of CUDA events recorded around each call."""
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events[name].append((start, end))
        return out
    return run


def main(steps=5):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this breakdown needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    model = chip_smoke.latlon_flagship()
    dt = chip_smoke.HYDRO["dt"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = model.initial_state(
        u=0.1 * torch.randn(model.grid.shape, generator=gen, device="cuda"),
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    for _ in range(3):
        state = model.step(state, dt)
    torch.cuda.synchronize()

    events = collections.defaultdict(list)
    kernels = {k: timed(events, label, hm.KERNELS[k]) for k, label in (
        ("tendencies", "K4b (advance)"), ("columns", "K4a"),
        ("barotropic", "K5 and its wrapper"), ("fill", "K6 fills"))}
    patches = [(hm, "barotropic_mode"), (SplitExplicitFreeSurface, "corrector")]
    labels = {"barotropic_mode": "barotropic modes", "corrector": "corrector"}
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, fn in saved:
        setattr(obj, name, timed(events, labels[name], fn))
    total = []
    try:
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = model.step(state, dt, kernels)
            end.record()
            total.append((start, end))
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    step_ms = sum(s.elapsed_time(e) for s, e in total) / steps
    parts = {name: sum(s.elapsed_time(e) for s, e in pairs) / steps
             for name, pairs in events.items()}
    parts["the rest"] = step_ms - sum(parts.values())
    print(f"hydrostatic 1/4 deg step, {steps} steps, CUDA events: "
          f"{step_ms:.4f} ms/step")
    for name, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.4f} ms ({100 * ms / step_ms:.1f}%)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state = model.step(state, dt)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if busy > 0:
        print(f"torch.profiler, 3 steps: {elapsed / 3:.4f} ms/step elapsed, "
              f"{busy / 3:.4f} ms/step in kernels, device idle "
              f"{100 * (1 - busy / elapsed):.1f}%")
    else:
        print("torch.profiler saw no device time: idle share not measured")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 3e3:.4f} ms/step, "
              f"{e.count // 3} calls/step")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
