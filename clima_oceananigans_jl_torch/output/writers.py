"""Output writers on schedules.

Counterpart of ``clima_oceananigans_jl_tpu/output/writers.py``
(Oceananigans' OutputWriters):

* ``HDF5OutputWriter``: the JLD2 writer's layout in an HDF5 file,
  ``timeseries/{name}/{i}`` for every output and ``timeseries/t/{i}``,
  ``timeseries/iteration/{i}``;
* ``NetCDFOutputWriter``: an unlimited time dimension, as NetCDF-4 in an
  HDF5 container through h5py (dimension scales, ``_NCProperties``, gzip)
  or as NetCDF classic through ``scipy.io.netcdf_file``;
* ``WindowedTimeAverage``: Σ f Δt / Σ Δt between firings of a schedule,
  usable as any writer's output.

Outputs are a dict ``name -> spec``: a field name (resolved through
``model.fields(state)``; the spec ``None`` or the output's own name is that
field), a callable ``spec(sim)``, or a ``WindowedTimeAverage``. A firing
slices each field's interior (or its ``indices`` window) on the device and
copies that slice to the host once. h5py and scipy are imported by the
methods that use them: without h5py the HDF5 and NetCDF-4 writers raise
``ImportError`` and the classic writer and the checkpoints still run.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.schedules import IterationInterval


def fetch_tensor(sim, name, spec, indices=None):
    """One output spec resolved on its device: the field's interior, or
    its ``indices`` window of the interior (axes of length 1 whole), a
    view; a callable's value; a time average's result."""
    if isinstance(spec, WindowedTimeAverage):
        return spec.result()
    if callable(spec):
        return spec(sim)
    field = sim.model.fields(sim.state)[name if spec is None else spec]
    grid = sim.model.grid
    data = field.data
    if indices is not None:
        from ..fields.field import regularize_indices
        win = regularize_indices(grid, indices)
        sl = tuple(slice(h + s.start, h + s.stop) if data.shape[a] > 1
                   else slice(None)
                   for a, (h, s) in enumerate(zip(grid.halo, win)))
    else:
        sl = tuple(slice(h, h + n) if data.shape[a] > 1 else slice(None)
                   for a, (h, n) in enumerate(zip(grid.halo, grid.shape)))
    return data[sl]


def to_numpy(x):
    """A host numpy copy of a tensor (one device-to-host copy); other
    values through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fetch(sim, name, spec, indices=None):
    """One output spec as a numpy array on the host."""
    return to_numpy(fetch_tensor(sim, name, spec, indices))


class AbstractOutputWriter:
    def __init__(self, outputs, schedule=None, verbose=False, indices=None):
        self.outputs = {k: (None if isinstance(v, str) and v == k else v)
                        for k, v in outputs.items()}
        self.schedule = schedule or IterationInterval(1)
        self.verbose = verbose
        self.indices = indices

    def __call__(self, sim):
        self.write(sim)

    def write(self, sim):  # pragma: no cover - abstract
        raise NotImplementedError


def _replace_file(filepath, overwrite):
    if overwrite and os.path.exists(filepath):
        os.remove(filepath)
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)


class HDF5OutputWriter(AbstractOutputWriter):
    """``file["timeseries/{name}/{i}"]``, the JLD2 writer's layout."""

    def __init__(self, outputs, filepath, schedule=None, overwrite=True,
                 verbose=False, indices=None):
        super().__init__(outputs, schedule, verbose, indices)
        self.filepath = filepath
        self._count = 0
        _replace_file(filepath, overwrite)

    def write(self, sim):
        import h5py
        i = self._count
        with h5py.File(self.filepath, "a") as f:
            f[f"timeseries/t/{i}"] = sim.model_time()
            f[f"timeseries/iteration/{i}"] = sim.model_iteration()
            for name, spec in self.outputs.items():
                f[f"timeseries/{name}/{i}"] = _fetch(sim, name, spec, self.indices)
        self._count += 1


class NetCDFOutputWriter(AbstractOutputWriter):
    """NetCDF with an unlimited time dimension, in one of two formats:

    * ``format="netcdf4"`` (the default): NetCDF-4 in an HDF5 container
      through h5py, each dimension an HDF5 dimension scale attached to the
      variables and the ``_NCProperties`` root attribute, so netCDF4,
      xarray and ncdump open it; gzip ``compression``; one chunk a record;
    * ``format="classic"``: NetCDF classic through scipy (no compression,
      32-bit offsets), for installations without h5py."""

    def __init__(self, outputs, filepath, schedule=None, overwrite=True,
                 verbose=False, indices=None, format="netcdf4",
                 compression=0):
        super().__init__(outputs, schedule, verbose, indices)
        self.filepath = filepath
        self.format = format
        self.compression = int(compression)
        self._initialized = False
        _replace_file(filepath, overwrite)

    def _init_file(self, sample):
        if self.format == "classic":
            return self._init_classic(sample)
        return self._init_nc4(sample)

    def _init_classic(self, sample):
        from scipy.io import netcdf_file
        f = netcdf_file(self.filepath, "w")
        f.createDimension("time", None)
        tvar = f.createVariable("time", "d", ("time",))
        tvar.units = "seconds"
        self._dims = {}
        for name, arr in sample.items():
            dims = ["time"]
            for a, letter in enumerate("xyz"):
                if arr.ndim > a:
                    dim = f"{letter}{arr.shape[a]}"
                    if dim not in self._dims:
                        f.createDimension(dim, arr.shape[a])
                        self._dims[dim] = True
                    dims.append(dim)
            f.createVariable(name, "d", tuple(dims))
        self._f = f
        self._tvar = tvar
        self._count = 0
        self._initialized = True

    def _init_nc4(self, sample):
        import h5py
        f = h5py.File(self.filepath, "w")
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.9.0,hdf5=1.12.0")
        tvar = f.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f8")
        tvar.make_scale("time")
        tvar.attrs["units"] = np.bytes_(b"seconds")
        self._dims = {"time": tvar}
        kw = ({"compression": "gzip", "compression_opts": self.compression}
              if self.compression else {})
        self._vars = {}
        for name, arr in sample.items():
            dims, dim_names = [tvar], ["time"]
            for a, letter in enumerate("xyz"):
                if arr.ndim > a:
                    dname = f"{letter}{arr.shape[a]}"
                    if dname not in self._dims:
                        d = f.create_dataset(dname, data=np.arange(arr.shape[a], dtype="f8"))
                        d.make_scale(dname)
                        self._dims[dname] = d
                    dims.append(self._dims[dname])
                    dim_names.append(dname)
            v = f.create_dataset(name, shape=(0,) + arr.shape,
                                 maxshape=(None,) + arr.shape,
                                 chunks=(1,) + arr.shape, dtype=arr.dtype, **kw)
            for axis, scale in enumerate(dims):
                v.dims[axis].attach_scale(scale)
            v.attrs["DIMENSION_LABELS"] = np.array(
                [n.encode() for n in dim_names], dtype=object)
            self._vars[name] = v
        self._f = f
        self._tvar = tvar
        self._count = 0
        self._initialized = True

    def write(self, sim):
        sample = {name: _fetch(sim, name, spec, self.indices)
                  for name, spec in self.outputs.items()}
        if not self._initialized:
            self._init_file(sample)
        i = self._count
        if self.format == "classic":
            self._tvar[i] = sim.model_time()
            for name, arr in sample.items():
                self._f.variables[name][i] = arr
        else:
            self._tvar.resize((i + 1,))
            self._tvar[i] = sim.model_time()
            for name, arr in sample.items():
                v = self._vars[name]
                v.resize((i + 1,) + v.shape[1:])
                v[i] = arr
        self._f.flush()
        self._count += 1

    def close(self):
        if self._initialized:
            self._f.close()


class WindowedTimeAverage:
    """The time mean of an output between firings of ``schedule``,
    accumulated every iteration (register it in ``sim.diagnostics``, and
    pass it as a writer's output): result = Σ f(tₖ)Δtₖ / Σ Δtₖ with f
    sampled at the new time. On an ``AveragedTimeInterval`` it collects
    only inside the trailing window, every ``stride``-th sample.

    ``fetch(sim)`` may return a tensor or a numpy array; the sum stays
    where the samples are, so a device output never leaves the device
    until a writer fires. It adds ``Δt·f`` to the sum as two operations in
    the output's dtype (no fused multiply-add, as numpy rounds it), and
    ``result`` divides by Σ Δt as a 0-d tensor of the sum's dtype on its
    device (PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal)."""

    def __init__(self, fetch, schedule=None):
        self.fetch = fetch
        self.schedule = IterationInterval(1)  # samples every iteration
        self.output_schedule = schedule
        self._sum = None
        self._wsum = 0.0
        self._last_t = None
        self._last_val = None
        self._n_seen = 0

    def __call__(self, sim):
        from ..utils.schedules import AveragedTimeInterval
        t = sim.model_time()
        out_sched = self.output_schedule
        if isinstance(out_sched, AveragedTimeInterval):
            self._n_seen += 1
            if not out_sched.collecting(t):
                if self._last_val is None:
                    # a snapshot for the writer's first (forced) firing
                    self._last_val = self.fetch(sim)
                self._last_t = None  # the integration restarts in the window
                return
            if (self._n_seen - 1) % out_sched.stride:
                return
        # the models write a solution tensor's interior only when they
        # make it, so the sample may stay a view of the state
        val = self.fetch(sim)
        self._last_val = val
        if self._last_t is None or self._sum is None:
            self._sum = _zeros_like(val)
            self._wsum = 0.0
        else:
            dt = t - self._last_t
            self._sum = self._sum + dt * val
            self._wsum += dt
        self._last_t = t

    def result(self):
        if self._wsum == 0.0:
            # fired before any accumulation (or just after a reset): the
            # latest sample
            if self._last_val is None:
                raise RuntimeError("WindowedTimeAverage.result() called "
                                   "before any sample was accumulated")
            return self._last_val
        s = self._sum
        if isinstance(s, torch.Tensor):
            out = s / torch.full((), self._wsum, dtype=s.dtype, device=s.device)
        else:
            out = s / self._wsum
        self._sum = _zeros_like(s)
        self._wsum = 0.0
        return out


def _zeros_like(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) else np.zeros_like(np.asarray(x))
