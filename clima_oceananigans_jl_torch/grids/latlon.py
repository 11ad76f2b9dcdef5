"""Latitude-longitude (spherical-shell) grids with precomputed metrics.

Counterpart of ``clima_oceananigans_jl_tpu/grids/latlon.py``
(Oceananigans' ``LatitudeLongitudeGrid``). Axis 0 is longitude λ and
axis 1 latitude φ, both in degrees; axis 2 is z in metres. The metrics
are the JAX grid's, computed the same way so they are bitwise its own:
from the axes' coordinate tensors (in the grid's type) taken to numpy
float64, then cast back:

- Δx[(lx, ly)] = R cos φ Δλ, shape (X, Y, 1);
- Δy[ly] = R Δφ, shape (1, Y, 1);
- Az[(lx, ly)] = R² Δλ (sin φ⁺ − sin φ⁻), the exact spherical patch.

The grid speaks the metric protocol of ``RectilinearGrid``
(``spacing``/``dx``/``dy``/``dz``/``Ax``/``Ay``/``Az``/``V`` of a location
triple), so every operator, fill and model works on it unchanged. A
regular λ axis makes every metric constant along x.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.location import C, F
from .rectilinear import RectilinearGrid, _build_axis, _bx, _host
from .topology import BOUNDED, FLAT, PERIODIC, Topology

R_EARTH = 6_371_000.0  # metres
DEG = np.pi / 180.0


def _interval(spec):
    """(interval, None) for a 2-element spec, else (None, spec)."""
    if spec is not None and not callable(spec) and np.ndim(spec) == 1 \
            and len(spec) == 2:
        return (float(spec[0]), float(spec[1])), None
    return None, spec


class LatitudeLongitudeGrid(RectilinearGrid):
    """Spherical-shell grid; axis 0 = longitude, 1 = latitude, 2 = z."""

    curvilinear = True

    def __init__(self, *, size, longitude, latitude, z=None, radius=R_EARTH,
                 topology=None, halo=None, dtype=torch.float32, device="cuda"):
        if len(size) != 3:
            raise ValueError("size must be a 3-tuple")
        if topology is None:
            lam_span = abs(float(longitude[-1]) - float(longitude[0]))
            lam_topo = PERIODIC if abs(lam_span - 360.0) < 1e-10 else BOUNDED
            z_topo = FLAT if size[2] == 1 and z is None else BOUNDED
            topology = (lam_topo, BOUNDED, z_topo)
        topology = tuple(Topology(t) for t in topology)
        if halo is None:
            halo = tuple(0 if t is FLAT else 3 for t in topology)
        halo = tuple(0 if t is FLAT else max(1, h) for h, t in zip(halo, topology))
        self._set_dtype_device(dtype, device)
        self.radius = float(radius)
        specs = (longitude, latitude, z if z is not None else (0.0, 1.0))
        self._axes = tuple(_build_axis(size[a], halo[a], topology[a],
                                       *_interval(specs[a]), dtype, self.device)
                           for a in range(3))
        self._init_static()
        self._precompute_metrics()

    def _precompute_metrics(self):
        R = self.radius
        lam, phi = self._axes[0], self._axes[1]
        dlam = {C: _host(lam.dc), F: _host(lam.df)}
        phi_at = {C: _host(phi.cc), F: _host(phi.cf)}
        dphi = {C: _host(phi.dc), F: _host(phi.df)}
        to = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self._dx_m = {}
        for lx in (C, F):
            for ly in (C, F):
                arr = (R * DEG * np.cos(DEG * phi_at[ly])[None, :]
                       * dlam[lx][:, None])
                self._dx_m[(lx, ly)] = to(arr[:, :, None])
        self._dy_m = {ly: to((R * DEG * dphi[ly])[None, :, None]) for ly in (C, F)}
        nyt = phi.cc.shape[0]
        sin_f = np.sin(DEG * phi_at[F])   # at faces j (lower face of cell j)
        sin_c = np.sin(DEG * phi_at[C])
        dsin = {}
        d = np.empty(nyt)                 # centred in φ: faces j, j+1 bracket cell j
        d[:-1] = sin_f[1:] - sin_f[:-1]
        d[-1] = d[-2] if nyt > 1 else 1.0
        dsin[C] = d
        d2 = np.empty(nyt)                # at faces: centres j-1, j bracket face j
        d2[1:] = sin_c[1:] - sin_c[:-1]
        d2[0] = d2[1] if nyt > 1 else 1.0
        dsin[F] = d2
        self._az_m = {}
        for lx in (C, F):
            for ly in (C, F):
                arr = R * R * DEG * dlam[lx][:, None] * dsin[ly][None, :]
                self._az_m[(lx, ly)] = to(arr[:, :, None])

    # -- metric protocol ---------------------------------------------------------
    def spacing(self, axis, loc):
        if axis == 0:
            return self.dx(loc)
        if axis == 1:
            return self.dy(loc)
        return _bx(self._axes[2].dc if loc[2] == C else self._axes[2].df, 2)

    def dx(self, loc):
        return self._dx_m[(loc[0], loc[1])]

    def dy(self, loc):
        return self._dy_m[loc[1]]

    def Az(self, loc):
        return self._az_m[(loc[0], loc[1])]

    def Ax(self, loc):  # face normal to λ: Δy · Δz
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):  # face normal to φ: Δx · Δz
        return self.dx(loc) * self.dz(loc)

    def V(self, loc):
        return self.Az(loc) * self.dz(loc)

    @property
    def all_regular(self):
        return False

    @property
    def hregular(self):
        return False

    def interior_h(self, arr):
        """Interior slice along the horizontal axes only (metrics are
        (X, Y, 1) or (1, Y, 1))."""
        sx = slice(self.Hx, self.Hx + self.Nx) if arr.shape[0] > 1 else slice(None)
        sy = slice(self.Hy, self.Hy + self.Ny) if arr.shape[1] > 1 else slice(None)
        return arr[sx, sy]

    def min_spacing(self):
        vals = [float(self.interior_h(m).abs().min())
                for m in (self._dx_m[(C, C)], self._dy_m[C])]
        if self.topology[2] is not FLAT:
            a = self._axes[2]
            vals.append(float(a.dc[a.h: a.h + a.n].min()))
        return min(vals)

    def with_halo(self, halo):
        halo = tuple(0 if t is FLAT else max(h, 1)
                     for h, t in zip(halo, self.topology))
        if halo == self.halo:
            return self
        new = self._rebuild_with_halo(halo)
        new.radius = self.radius
        new._precompute_metrics()
        return new

    def subgrid_along(self, axis, start, n_new):
        """The strip of ``RectilinearGrid.subgrid_along`` with the metric
        arrays sliced by the same with-halo window."""
        new = super().subgrid_along(axis, start, n_new)
        new.radius = self.radius
        sl = slice(start, start + n_new + 2 * self.halo[axis])

        def cut(v):
            if axis == 2 or v.shape[axis] == 1:
                return v
            idx = [slice(None)] * 3
            idx[axis] = sl
            return v[tuple(idx)]

        new._dx_m = {k: cut(v) for k, v in self._dx_m.items()}
        new._az_m = {k: cut(v) for k, v in self._az_m.items()}
        new._dy_m = {k: cut(v) for k, v in self._dy_m.items()}
        return new

    def __repr__(self):
        t = tuple(t.value for t in self.topology)
        return (f"LatitudeLongitudeGrid(size={self.shape}, halo={self.halo}, "
                f"topology={t}, radius={self.radius:g}, dtype={self.dtype}, "
                f"device={self.device})")
