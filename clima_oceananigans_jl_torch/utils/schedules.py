"""Schedules: when a diagnostic, an output writer or a callback fires.

Counterpart of ``clima_oceananigans_jl_tpu/utils/schedules.py``
(Oceananigans' ``TimeInterval``, ``IterationInterval``,
``WallTimeInterval``, ``SpecifiedTimes``, ``AndSchedule``, ``OrSchedule``
and ``AveragedTimeInterval``). Host logic only: a schedule reads the
simulation's host clock (``sim.model_time()``, ``sim.model_iteration()``)
and never the device.
"""
from __future__ import annotations

import time as _time


class Schedule:
    def aligned_time_step(self, clock_time, dt):
        """The largest Δt ≤ dt that does not step over the next actuation."""
        return dt

    def __call__(self, sim) -> bool:
        raise NotImplementedError


class TimeInterval(Schedule):
    def __init__(self, interval):
        self.interval = float(interval)
        self.previous_actuation_time = 0.0

    def __call__(self, sim):
        t = float(sim.model_time())
        if t >= self.previous_actuation_time + self.interval - 1e-12 * max(1.0, abs(t)):
            # realign to the schedule's lattice when t sits on it
            if t % self.interval < 10 * max(t, 1.0) * 1e-15:
                self.previous_actuation_time = t - t % self.interval
            else:
                self.previous_actuation_time = t
            return True
        return False

    def aligned_time_step(self, clock_time, dt):
        nxt = self.previous_actuation_time + self.interval
        return min(dt, max(nxt - clock_time, 0.0)) if nxt > clock_time else dt


class AveragedTimeInterval(TimeInterval):
    """A ``TimeInterval`` whose actuations deliver a time average over the
    trailing ``window`` (default: the whole interval), sampled every
    ``stride`` iterations. ``Simulation.initialize`` wraps the outputs of a
    writer on this schedule in ``WindowedTimeAverage`` accumulators."""

    def __init__(self, interval, window=None, stride=1):
        super().__init__(interval)
        self.window = float(window) if window is not None else float(interval)
        self.stride = int(stride)

    def collecting(self, t):
        """True when ``t`` lies in the window before the next actuation."""
        nxt = self.previous_actuation_time + self.interval
        return t >= nxt - self.window - 1e-12 * max(1.0, abs(t))


class IterationInterval(Schedule):
    def __init__(self, interval):
        self.interval = int(interval)

    def __call__(self, sim):
        return int(sim.model_iteration()) % self.interval == 0


class WallTimeInterval(Schedule):
    def __init__(self, interval):
        self.interval = float(interval)
        self.previous_actuation_time = _time.monotonic()

    def __call__(self, sim):
        now = _time.monotonic()
        if now - self.previous_actuation_time >= self.interval:
            self.previous_actuation_time = now
            return True
        return False


class SpecifiedTimes(Schedule):
    def __init__(self, *times):
        self.times = sorted(float(t) for t in times)
        self.previous_actuation = 0  # how many times it has fired

    def __call__(self, sim):
        if self.previous_actuation >= len(self.times):
            return False
        if float(sim.model_time()) >= self.times[self.previous_actuation] - 1e-12:
            self.previous_actuation += 1
            return True
        return False

    def aligned_time_step(self, clock_time, dt):
        if self.previous_actuation >= len(self.times):
            return dt
        nxt = self.times[self.previous_actuation]
        return min(dt, max(nxt - clock_time, 0.0)) if nxt > clock_time else dt


class AndSchedule(Schedule):
    def __init__(self, *schedules):
        self.schedules = schedules

    def __call__(self, sim):
        return all(s(sim) for s in self.schedules)

    def aligned_time_step(self, clock_time, dt):
        for s in self.schedules:
            dt = s.aligned_time_step(clock_time, dt)
        return dt


class OrSchedule(Schedule):
    def __init__(self, *schedules):
        self.schedules = schedules

    def __call__(self, sim):
        return any(s(sim) for s in self.schedules)

    def aligned_time_step(self, clock_time, dt):
        for s in self.schedules:
            dt = s.aligned_time_step(clock_time, dt)
        return dt
