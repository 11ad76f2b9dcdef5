"""Distributed Poisson solvers: pencil transposes between the shards.

Counterpart of ``clima_oceananigans_jl_tpu/parallel/distributed_fft.py``
(Oceananigans' PencilFFTs-based ``DistributedFFTBasedPoissonSolver``):
each axis is transformed while it is local to the shard, with
``all_to_all`` transposes between the pencil layouts (``parallel/
mesh.py``), never a gather to one shard. z is never cut, so the same
skeleton serves the FFT solve and the stretched-z Fourier-tridiagonal
solve (the batched tridiagonal solve, kernel T1 on the card, along the
always-local z). Layouts of a shard's interior block on an Rx × Ry mesh:

    (x/Rx, y/Ry, z) ──a2a(x: split z, gather x)──► (x, y/Ry, z/Rx)  transform x
                    ◄──a2a back──
    (x/Rx, y/Ry, z) ──a2a(y: split z, gather y)──► (x/Rx, y, z/Ry)  transform y
                    ◄──a2a back──

then the z transform (or solve) and the eigenvalue division at the
(x/Rx, y/Ry, z) layout, and the transforms in reverse. As in JAX, every
periodic axis takes a complex FFT (no real FFT: its N/2 + 1 modes would
not split over the shards) and every bounded one the orthonormal DCT-II,
of the real and imaginary parts apart. Nz must divide by Rx and Ry.
"""
from __future__ import annotations

import dataclasses

import torch

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..solvers.fft_poisson import dct2, idct2, poisson_eigenvalues
from ..solvers.tridiagonal import fourier_tridiagonal
from .mesh import all_to_all, axis_index, psum


def _global_axis(grid, axis):
    """(global N, global extent, global topology, mesh axis, shards)."""
    d = grid.dist[axis]
    ax = grid._axes[axis]
    if d is None:
        return ax.n, ax.extent, ax.topo, None, 1
    mesh_axis, n_shards, global_topo = d
    return ax.n * n_shards, ax.extent * n_shards, global_topo, mesh_axis, n_shards


def _real_parts(fn, b, axis):
    if b.is_complex():
        return torch.complex(fn(b.real.contiguous(), axis),
                             fn(b.imag.contiguous(), axis))
    return fn(b, axis)


def _fwd_1d(b, axis, topo):
    if topo is PERIODIC:
        return torch.fft.fft(b, dim=axis)
    if topo is BOUNDED:
        return _real_parts(dct2, b, axis)
    return b


def _inv_1d(b, axis, topo):
    if topo is PERIODIC:
        return torch.fft.ifft(b, dim=axis)
    if topo is BOUNDED:
        return _real_parts(idct2, b, axis)
    return b


def _transform_axis(b, axis, topo, mesh_axis, n_shards, inverse):
    """Transform ``axis``: gathered through an all_to_all against z,
    transformed, and scattered back."""
    fn = _inv_1d if inverse else _fwd_1d
    if mesh_axis is None or n_shards == 1:
        return fn(b, axis, topo)
    b = all_to_all(b, mesh_axis, split_axis=2, concat_axis=axis)
    b = fn(b, axis, topo)
    return all_to_all(b, mesh_axis, split_axis=axis, concat_axis=2)


def _axes_meta(grid, axes):
    """Per axis (topology, mesh axis, shards, local n) and the global
    eigenvalues."""
    meta, lams = [], []
    for a in axes:
        N, L, topo, mesh_axis, n_shards = _global_axis(grid, a)
        lams.append(poisson_eigenvalues(N, L if topo is not FLAT else 1.0,
                                        topo, grid.dtype, grid.device))
        meta.append((topo, mesh_axis, n_shards, grid._axes[a].n))
    return meta, lams


def _check_nz(grid, meta):
    rx, ry, nz = meta[0][2], meta[1][2], grid.Nz
    if nz % max(rx, 1) or nz % max(ry, 1):
        raise ValueError(f"Nz={nz} must divide the mesh {rx}x{ry} for the "
                         "pencil transposes (reference Nz>=Rx analog)")


class _Pencil:
    """The shared parts of the two solvers: the local eigenvalues, the
    origin shard, the horizontal transforms."""

    def _local_lam(self, lam, axis):
        _topo, mesh_axis, n_shards, n_local = self.meta[axis]
        if mesh_axis is not None and n_shards > 1:
            lam = lam.narrow(0, axis_index(mesh_axis) * n_local, n_local)
        shape = [1, 1, 1]
        shape[axis] = lam.shape[0]
        return lam.reshape(shape)

    def _is_origin(self):
        return all(axis_index(m) == 0 for _t, m, n, _l in self.meta[:2]
                   if m is not None and n > 1)

    def _horizontal(self, b, inverse):
        for axis in ((1, 0) if inverse else (0, 1)):
            topo, mesh_axis, n_shards, _ = self.meta[axis]
            b = _transform_axis(b, axis, topo, mesh_axis, n_shards, inverse)
        return b


@dataclasses.dataclass
class DistributedFFTPoissonSolver(_Pencil):
    """The eigenexpansion solve of (∇² + m)φ = b on a regular grid cut over
    a mesh, built from a shard's local grid; ``solve`` runs in the shard's
    thread on its interior block."""

    lam_x: torch.Tensor   # the global eigenvalues
    lam_y: torch.Tensor
    lam_z: torch.Tensor
    meta: tuple           # per axis (topology, mesh axis, shards, local n)
    dtype: torch.dtype

    @classmethod
    def build(cls, grid):
        meta, lams = _axes_meta(grid, (0, 1, 2))
        if meta[2][2] != 1:
            raise ValueError("z must not be distributed (mesh is (x, y))")
        _check_nz(grid, meta)
        return cls(*lams, tuple(meta), grid.dtype)

    def solve(self, rhs, m=0.0):
        b = self._horizontal(rhs, inverse=False)
        b = _fwd_1d(b, 2, self.meta[2][0])  # z is local
        lam = (self._local_lam(self.lam_x, 0) + self._local_lam(self.lam_y, 1)
               + self._local_lam(self.lam_z, 2))
        denom = lam - m
        phi = -b / torch.where(denom == 0, torch.ones_like(denom), denom)
        if m == 0.0 and self._is_origin():
            phi[0, 0, 0] = 0.0  # the undetermined global mean mode
        phi = _inv_1d(phi, 2, self.meta[2][0])
        phi = self._horizontal(phi, inverse=True)
        phi = phi.real if phi.is_complex() else phi
        return phi.to(self.dtype)


@dataclasses.dataclass
class DistributedFourierTridiagonalSolver(_Pencil):
    """The stretched-z solve on a grid cut over a mesh: the pencil
    transforms in x and y, then the batched tridiagonal solve of every
    horizontal mode along the local z (``fourier_tridiagonal``, T1 on the
    card, or the function ``solve`` is given)."""

    lam_x: torch.Tensor
    lam_y: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    dzc: torch.Tensor
    meta: tuple
    dtype: torch.dtype

    @classmethod
    def build(cls, grid):
        meta, lams = _axes_meta(grid, (0, 1))
        az = grid._axes[2]
        Nz, Hz = az.n, az.h
        dzc = az.dc[Hz:Hz + Nz]
        dzf = az.df[Hz:Hz + Nz]
        dzf_up = torch.cat([dzf[1:], torch.ones(1, dtype=grid.dtype,
                                                device=grid.device)])
        a_band = 1.0 / dzf
        c_band = 1.0 / dzf_up
        a_band[0] = 0.0
        c_band[-1] = 0.0
        meta.append((az.topo, None, 1, Nz))
        _check_nz(grid, meta)
        return cls(lams[0], lams[1], a_band.contiguous(), c_band.contiguous(),
                   dzc.contiguous(), tuple(meta), grid.dtype)

    def solve(self, rhs, m=0.0, tridiagonal=None):
        solve_modes = tridiagonal or fourier_tridiagonal
        b = self._horizontal(rhs, inverse=False)
        lam_x = self._local_lam(self.lam_x, 0).reshape(-1).contiguous()
        lam_y = self._local_lam(self.lam_y, 1).reshape(-1).contiguous()
        phi = solve_modes(lam_x, lam_y, m, self.lower, self.upper, self.dzc,
                          b.contiguous(), m == 0.0 and self._is_origin())
        phi = self._horizontal(phi, inverse=True)
        phi = (phi.real if phi.is_complex() else phi).to(self.dtype)
        if m == 0.0:
            # the zero-mean gauge over every shard
            w = self.dzc.reshape(1, 1, -1)
            names = [mm for _t, mm, n, _l in self.meta[:2] if mm is not None and n > 1]
            s = psum(torch.sum(phi * w), names)
            cnt = psum(torch.sum(torch.broadcast_to(w, phi.shape)), names)
            phi = phi - s / cnt
        return phi


def select_distributed_pressure_solver(grid):
    """The distributed counterpart of ``select_pressure_solver``: the
    pencil FFT solve on a regular grid, the pencil Fourier-tridiagonal one
    on a grid stretched in z alone."""
    if grid.all_regular:
        return DistributedFFTPoissonSolver.build(grid)
    if grid.hregular:
        return DistributedFourierTridiagonalSolver.build(grid)
    raise ValueError("distributed pressure solve needs regular x,y spacing")
