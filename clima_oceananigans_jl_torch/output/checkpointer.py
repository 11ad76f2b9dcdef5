"""Checkpoints: the whole state, for a restart that continues bit for bit.

Counterpart of ``clima_oceananigans_jl_tpu/output/checkpointer.py``
(Oceananigans' ``Checkpointer`` and ``run!``'s pickup). One ``.npz`` a
checkpoint, in the JAX package's format: a key ``state/<path>`` for every
leaf of the state's dicts (``state/solution/u``, ``state/G_prev/u``,
``state/pNHS``, ``state/previous_dt``, ...), ``state/clock/__clock_time``
and ``state/clock/__clock_iteration`` for the clock, and
``__state_layout``. A port checkpoint also carries ``__package`` (which
the JAX package's reader ignores), so each package reads the other's:

- a port checkpoint restores into the template state's structure leaf for
  leaf, as it was written: the solution with its halos, ``G_prev`` in the
  layout the model steps with, ``previous_dt`` and the clock in the grid's
  dtype, pNHS, pHY′, ``eta``, ``w``, the diffusivities (a tuple's entries
  under ``/0``, ``/1``, ...); a JAX ``restore_state`` reads one of a
  model without diffusivity tuples;
- a JAX checkpoint goes through ``interop.state_from_numpy`` for
  ``model`` with its ``__state_layout``: the natural layout, the
  hydrostatic (x, z, y) ``"xzy"`` one, an x/y-interior ``G_prev`` (the
  JAX fused advance), a hydrostatic state without ``w`` and pHY′.
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from ..timesteppers.steppers import Clock
from ..utils.schedules import IterationInterval

PACKAGE = "clima_oceananigans_jl_torch"


def _flatten_state(state):
    flat = {}

    def rec(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                rec(f"{prefix}/{k}", v)
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                rec(f"{prefix}/{i}", v)
        elif isinstance(obj, Clock):
            flat[f"{prefix}/__clock_time"] = np.asarray(obj.time)
            flat[f"{prefix}/__clock_iteration"] = np.asarray(obj.iteration)
        elif isinstance(obj, torch.Tensor):
            flat[prefix] = obj.detach().cpu().numpy()
        elif obj is not None:
            flat[prefix] = np.asarray(obj)

    rec("state", state)
    return flat


def _unflatten_state(template, flat):
    """``template``'s structure with the leaves of ``flat``: tensors on the
    template's device, host scalars as numpy scalars of their saved dtype."""
    def rec(prefix, obj):
        if isinstance(obj, dict):
            return {k: rec(f"{prefix}/{k}", v) for k, v in obj.items()}
        if isinstance(obj, (tuple, list)):
            return type(obj)(rec(f"{prefix}/{i}", v) for i, v in enumerate(obj))
        if isinstance(obj, Clock):
            return Clock(flat[f"{prefix}/__clock_time"][()],
                         int(flat[f"{prefix}/__clock_iteration"]), obj.stage)
        if obj is None:
            return None
        if isinstance(obj, torch.Tensor):
            return torch.as_tensor(flat[prefix], device=obj.device).to(obj.dtype)
        return flat[prefix][()]

    return rec("state", template)


def _nest(flat):
    """A JAX checkpoint's keys as a nested dict of numpy leaves (the clock
    a ``Clock`` of 0-d arrays)."""
    state = {}
    for key, arr in flat.items():
        parts = key.split("/")[1:]
        node = state
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    clock = state["clock"]
    state["clock"] = Clock(clock["__clock_time"], clock["__clock_iteration"])
    return state


class Checkpointer:
    """Writes ``{prefix}_iteration{i}.npz`` on a schedule and keeps the
    latest ``keep`` files (all when ``keep`` is 0 or None)."""

    def __init__(self, schedule=None, dir=".", prefix="checkpoint", keep=2,
                 verbose=False):
        self.schedule = schedule or IterationInterval(1000)
        self.dir = dir
        self.prefix = prefix
        self.keep = keep
        self.verbose = verbose
        os.makedirs(dir, exist_ok=True)

    def checkpoint_path(self, iteration):
        return os.path.join(self.dir, f"{self.prefix}_iteration{iteration}.npz")

    def __call__(self, sim):
        self.write(sim)

    def write(self, sim):
        path = self.checkpoint_path(sim.model_iteration())
        flat = _flatten_state(sim.state)
        flat["__state_layout"] = np.asarray("natural")
        flat["__package"] = np.asarray(PACKAGE)
        np.savez(path, **flat)
        if self.keep:
            for old in sorted(self._all(), key=self._iter_of)[:-self.keep]:
                os.remove(old)

    def _all(self):
        return glob.glob(os.path.join(self.dir, f"{self.prefix}_iteration*.npz"))

    @staticmethod
    def _iter_of(path):
        m = re.search(r"_iteration(\d+)\.npz$", path)
        return int(m.group(1)) if m else -1

    def latest(self):
        paths = self._all()
        return max(paths, key=self._iter_of) if paths else None


def restore_state(template_state, path, model=None):
    """The state of the checkpoint at ``path``: a port checkpoint in the
    structure of ``template_state``; a JAX checkpoint through
    ``interop.state_from_numpy`` for ``model`` (required then)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    layout = str(flat.pop("__state_layout", "natural"))
    if str(flat.pop("__package", "")) == PACKAGE:
        return _unflatten_state(template_state, flat)
    if model is None:
        raise ValueError(f"{path} was written by the JAX package: restoring it "
                         "needs the model")
    from ..interop import state_from_numpy
    return state_from_numpy(model, _nest(flat), layout)


def pickup_latest(sim, pickup=True):
    """Restores ``sim.state`` from the first ``Checkpointer`` among its
    writers: ``pickup`` True (the latest), an iteration number or a path.
    Returns whether a checkpoint was found."""
    ckps = [w for w in sim.output_writers.values() if isinstance(w, Checkpointer)]
    if not ckps:
        return False
    ckp = ckps[0]
    if pickup is True:
        path = ckp.latest()
    elif isinstance(pickup, (int, np.integer)):
        path = ckp.checkpoint_path(int(pickup))
    else:
        path = pickup
    if path is None or not os.path.exists(path):
        return False
    sim.state = restore_state(sim.state, path, model=getattr(sim, "model", None))
    return True
