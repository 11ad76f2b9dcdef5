"""Fourier-tridiagonal Poisson solver for grids stretched in z.

Counterpart of ``clima_oceananigans_jl_tpu/solvers/fourier_tridiagonal.py``
(Oceananigans' ``FourierTridiagonalPoissonSolver``): transforms along the
regular horizontal axes, then a batched tridiagonal solve along the
(possibly stretched) z axis for every horizontal mode.

Vertical operator (staggered finite volumes, Neumann at top and bottom),
multiplied through by Δzᶜ(k) as the JAX solver does:
  a(k) = 1/Δzᶠ(k),  c(k) = 1/Δzᶠ(k+1),  b(k) = −a − c − λ_h Δzᶜ(k)
with a(0) = c(N−1) = 0.

The transforms are those of ``solvers/fft_poisson.py``: DCT-II on bounded
axes, a real FFT on the first periodic axis (which halves the modes and
the tridiagonal work) and complex FFTs on the others. The JAX solver runs
a complex FFT over every periodic axis (and on the TPU real matmul
transforms, which have no counterpart here); the solutions agree to
rounding. The bands, the (0, 0)-mode pin and the volume-mean gauge are
the JAX solver's. The tridiagonal solve is ``solvers/tridiagonal.py``'s
``fourier_tridiagonal`` (kernel T1 on the card) unless the caller passes
another function of the same signature (its plain version).
"""
from __future__ import annotations

import dataclasses

import torch

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from .fft_poisson import dct2, idct2, poisson_eigenvalues
from .tridiagonal import fourier_tridiagonal


@dataclasses.dataclass
class FourierTridiagonalSolver:
    lam_x: torch.Tensor   # (Nx,) eigenvalues along x
    lam_y: torch.Tensor   # (Ny,)
    lower: torch.Tensor   # a(k), (Nz,)
    upper: torch.Tensor   # c(k)
    dzc: torch.Tensor     # interior Δzᶜ, (Nz,)
    topology: tuple

    @classmethod
    def build(cls, grid):
        if not grid.hregular:
            raise ValueError("FourierTridiagonalSolver requires regular x, y")
        ax = grid._axes[2]
        Nz, Hz = ax.n, ax.h
        dzc = ax.dc[Hz: Hz + Nz]
        dzf = ax.df[Hz: Hz + Nz]   # Δzᶠ(k): centres k−1 to k (face k)
        dzf_up = torch.cat([dzf[1:], torch.ones(1, dtype=grid.dtype,
                                                device=grid.device)])
        a = 1.0 / dzf
        c = 1.0 / dzf_up
        a[0] = 0.0   # bottom Neumann
        c[-1] = 0.0  # top Neumann
        lam = []
        for i in (0, 1):
            topo = grid.topology[i]
            n = grid.shape[i]
            L = n * float(grid._axes[i].dc[0]) if topo is not FLAT else 1.0
            lam.append(poisson_eigenvalues(n, L, topo, grid.dtype, grid.device))
        return cls(lam[0], lam[1], a.contiguous(), c.contiguous(),
                   dzc.contiguous(), grid.topology)

    def solve(self, rhs, m=0.0, tridiagonal=None):
        """(∇² + m)φ = rhs on interior arrays (no halos); with m = 0 the
        mean mode is pinned and φ has zero volume mean. ``tridiagonal``
        replaces ``fourier_tridiagonal`` (its plain version, for instance)."""
        solve_modes = tridiagonal or fourier_tridiagonal
        topo = self.topology
        dct_axes = tuple(a for a in (0, 1) if topo[a] is BOUNDED)
        fft_axes = tuple(a for a in (0, 1) if topo[a] is PERIODIC)
        lam = [self.lam_x, self.lam_y]
        b = rhs
        for a in dct_axes:
            b = dct2(b, a)
        r_axis = fft_axes[0] if fft_axes else None
        c_axes = fft_axes[1:]
        if r_axis is not None:
            n_r = b.shape[r_axis]
            b = torch.fft.rfft(b, dim=r_axis)
            lam[r_axis] = lam[r_axis][: n_r // 2 + 1].contiguous()
        if c_axes:
            b = torch.fft.fftn(b, dim=c_axes)
        phi = solve_modes(lam[0], lam[1], m, self.lower, self.upper, self.dzc,
                          b.contiguous(), m == 0.0)
        if c_axes:
            phi = torch.fft.ifftn(phi, dim=c_axes)
        if r_axis is not None:
            phi = torch.fft.irfft(phi, n=n_r, dim=r_axis)
        phi = phi.real if phi.is_complex() else phi
        for a in reversed(dct_axes):
            phi = idct2(phi, a)
        if m == 0.0:
            # zero-mean gauge: the (0, 0) mode is singular up to a constant
            w = self.dzc.reshape(1, 1, -1)
            mean = (phi * w).sum() / (w.sum() * phi.shape[0] * phi.shape[1])
            phi = phi - mean
        return phi
