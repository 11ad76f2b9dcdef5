"""Simulation: the host loop around ``model.step``.

Counterpart of ``clima_oceananigans_jl_tpu/simulation/simulation.py``
(Oceananigans' ``Simulation``, ``run!``, ``TimeStepWizard``,
``NaNChecker`` and ``Callback``): schedules, Δt aligned with the stop time
and the scheduled activities, callbacks, diagnostics, output writers,
pickup from a checkpoint and the adaptive Δt. Each iteration rounds Δt to
the grid's dtype, as the JAX loop does, and calls ``model.step`` (the
kernels on the card); ``aligned_dt``, the stop checks and the clock are
host arithmetic and touch no device memory. Only the activities read the
device back (the wizard's and the NaN checker's reductions, a writer's
copy), each when its schedule fires.
"""
from __future__ import annotations

import logging
import time as _time
from collections import OrderedDict

import numpy as np
import torch

from ..timesteppers.steppers import host_scalar
from ..utils.schedules import IterationInterval, Schedule

logger = logging.getLogger("clima_oceananigans_jl_torch")


class Callback:
    def __init__(self, func, schedule=None):
        self.func = func
        self.schedule = schedule or IterationInterval(1)

    def __call__(self, sim):
        return self.func(sim)


class NaNChecker:
    """Stops the run (or raises, when ``erroring``) once a monitored field
    holds a NaN or an infinity; installed every 100 iterations."""

    def __init__(self, fields=("h", "u", "w"), erroring=False):
        self.fields = fields
        self.erroring = erroring

    def __call__(self, sim):
        sol = sim.state["solution"] if "solution" in sim.state else sim.state.get("fields", {})
        for name in self.fields:
            if name in sol and bool((~torch.isfinite(sol[name])).any()):
                msg = (f"time = {sim.model_time():.6g}, iteration = "
                       f"{sim.model_iteration()}: NaN found in field {name}. Aborting simulation.")
                if self.erroring:
                    raise FloatingPointError(msg)
                logger.error(msg)
                sim.running = False
                return


class TimeStepWizard:
    """Adaptive Δt: ``cfl`` times the advective timescale, capped by
    ``diffusive_cfl`` times the diffusive one, within ``max_change`` and
    ``min_change`` of the current Δt and within [``min_dt``, ``max_dt``]."""

    def __init__(self, cfl=0.2, diffusive_cfl=np.inf, max_change=1.1,
                 min_change=0.5, max_dt=np.inf, min_dt=0.0):
        self.cfl = cfl
        self.diffusive_cfl = diffusive_cfl
        self.max_change = max_change
        self.min_change = min_change
        self.max_dt = max_dt
        self.min_dt = min_dt

    def __call__(self, sim):
        new_dt = self.cfl * float(sim.model.cell_advection_timescale(sim.state))
        if np.isfinite(self.diffusive_cfl):
            diff_scale = float(sim.model.cell_diffusion_timescale(sim.state))
            new_dt = min(new_dt, self.diffusive_cfl * diff_scale)
        new_dt = min(self.max_change * sim.dt, new_dt)
        new_dt = max(self.min_change * sim.dt, new_dt)
        sim.dt = float(np.clip(new_dt, self.min_dt, self.max_dt))


class Simulation:
    """Runs ``model`` from ``state`` with Δt ``dt`` until ``stop_iteration``,
    ``stop_time`` or ``wall_time_limit`` (``run``), firing the activities
    in ``diagnostics``, ``callbacks`` and ``output_writers`` on their
    schedules. A ``NaNChecker`` of every prognostic field is installed as
    the callback ``"nan_checker"``."""

    def __init__(self, model, state=None, dt=None, stop_iteration=np.inf,
                 stop_time=np.inf, wall_time_limit=np.inf, verbose=False):
        if dt is None:
            raise ValueError("Simulation requires dt")
        self.model = model
        self.state = state if state is not None else model.initial_state()
        self.dt = float(dt)
        self.stop_iteration = stop_iteration
        self.stop_time = stop_time
        self.wall_time_limit = wall_time_limit
        self.callbacks = OrderedDict()
        self.output_writers = OrderedDict()
        self.diagnostics = OrderedDict()
        self.running = True
        self.initialized = False
        self.run_wall_time = 0.0
        self.verbose = verbose
        self.callbacks["nan_checker"] = Callback(
            NaNChecker(model.prognostic_names()), IterationInterval(100))

    # -- the clock (host numbers) -------------------------------------------------
    def model_time(self):
        return float(self.state["clock"].time)

    def model_iteration(self):
        return int(self.state["clock"].iteration)

    # -- stop criteria --------------------------------------------------------------
    def _check_stop(self):
        if self.model_iteration() >= self.stop_iteration:
            self.running = False
            logger.info("Simulation is stopping: model iteration %s ≥ stop_iteration %s",
                        self.model_iteration(), self.stop_iteration)
        if self.model_time() >= self.stop_time - 1e-12:
            self.running = False
            logger.info("Simulation is stopping: model time %.6g ≥ stop_time %.6g",
                        self.model_time(), self.stop_time)
        if self.run_wall_time >= self.wall_time_limit:
            self.running = False
            logger.info("Simulation is stopping: wall time limit exceeded")

    def aligned_dt(self):
        """Δt capped by the next actuation of every time schedule and by
        the stop time: a Python float."""
        t = self.model_time()
        dt = self.dt
        for coll in (self.callbacks, self.output_writers, self.diagnostics):
            for item in coll.values():
                sched = getattr(item, "schedule", None)
                if isinstance(sched, Schedule):
                    dt = sched.aligned_time_step(t, dt)
        if np.isfinite(self.stop_time):
            dt = min(dt, max(self.stop_time - t, 0.0))
        return dt

    # -- activities ---------------------------------------------------------------
    def _fire(self, initial=False):
        for coll in (self.diagnostics, self.callbacks, self.output_writers):
            for item in coll.values():
                sched = getattr(item, "schedule", None)
                fire = sched(self) if sched is not None else True
                if fire or initial:
                    item(self) if callable(item) else item.process(self)

    def _setup_time_averaging(self):
        """Wraps each output of a writer on an ``AveragedTimeInterval`` in a
        ``WindowedTimeAverage`` (registered as a diagnostic, so it samples
        every iteration) that accumulates on the device."""
        from ..output.writers import WindowedTimeAverage, fetch_tensor
        from ..utils.schedules import AveragedTimeInterval
        for wname, writer in self.output_writers.items():
            sched = getattr(writer, "schedule", None)
            if not isinstance(sched, AveragedTimeInterval):
                continue
            for name, spec in list(writer.outputs.items()):
                if isinstance(spec, WindowedTimeAverage):
                    continue
                wta = WindowedTimeAverage(
                    (lambda sim, n=name, s=spec, w=writer:
                     fetch_tensor(sim, n, s, w.indices)),
                    schedule=sched)
                writer.outputs[name] = wta
                self.diagnostics[f"_wta_{wname}_{name}"] = wta

    def initialize(self):
        self._setup_time_averaging()
        self._fire(initial=True)
        self.initialized = True

    # -- the loop -----------------------------------------------------------------------
    def time_step(self):
        if not self.initialized:
            self.initialize()
        t0 = _time.monotonic()
        dt = self.aligned_dt()
        if dt <= 0:
            self.running = False
            return
        self.state = self.model.step(self.state, host_scalar(self.model.grid.dtype, dt))
        self._fire()
        self._check_stop()
        self.run_wall_time += _time.monotonic() - t0

    def run(self, pickup=False):
        """Steps until a stop criterion holds; ``pickup`` (True for the
        latest checkpoint, an iteration number or a path) first restores
        the state from the first ``Checkpointer`` among the writers."""
        if pickup:
            from ..output.checkpointer import pickup_latest
            if pickup_latest(self, pickup):
                logger.info("Picked up checkpoint at iteration %s", self.model_iteration())
        self.running = True
        self._check_stop()
        while self.running:
            self.time_step()
        return self.state
