"""Batched tridiagonal (Thomas) solve along z: kernel T1.

Counterpart of ``clima_oceananigans_jl_tpu/solvers/tridiagonal.py``
(Oceananigans' ``BatchedTridiagonalSolver``): solves M φ = d column-wise
for every (i, j), M tridiagonal with lower/diagonal/upper bands (a, b, c)
that are 1D (z only) or 3D.

- ``solve_batched_tridiagonal_reference``: the plain version, the JAX
  function's two sweeps as Python loops over z levels on (Nx, Ny) planes,
  in its expression trees (``denom = b − a·cp⁻``, ``cp = c/denom``,
  ``dp = (d − a·dp⁻)/denom``, ``φ = dp − cp·φ⁺``); a complex right-hand
  side is two real solves with the same bands, as in the JAX
  Fourier-tridiagonal solver;
- ``fourier_tridiagonal_reference``: the bands of the Fourier-tridiagonal
  pressure solve formed as ``solvers/fourier_tridiagonal.py`` forms them
  (the diagonal −(lo + up) − λ_h·Δzᶜ, the right-hand side scaled by Δzᶜ,
  the (0, 0)-mode pin), then the plain solve.

``solve_batched_tridiagonal`` and ``fourier_tridiagonal`` are their
wrappers: on CUDA tensors they launch the hand-written kernel
``csrc/batched_tridiagonal.cu`` (T1; the second in its Fourier mode, which
forms those bands in the kernel) or raise, on CPU tensors they run the
plain version. Both count their launches in
``solve_batched_tridiagonal.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.fused_tendencies import check_tensor, kernel_fn, launch


def _level(band, k):
    """Band entries of level k: a 0-d tensor of a 1D band (broadcast over
    the plane), the (..., k) plane of a 3D one."""
    return band[k] if band.ndim == 1 else band[..., k]


def solve_batched_tridiagonal_reference(a, b, c, d):
    """Thomas algorithm along the last axis of ``d``; a[..., 0] and
    c[..., -1] enter as in the JAX function (multiplied by zeros). Bands are
    1D (Nz,) or broadcast against ``d``; a complex ``d`` is solved as its
    real and imaginary parts."""
    if d.is_complex():
        return torch.complex(solve_batched_tridiagonal_reference(a, b, c, d.real),
                             solve_batched_tridiagonal_reference(a, b, c, d.imag))
    nz = d.shape[-1]
    zeros = torch.zeros_like(d[..., 0])
    cp_prev, dp_prev = zeros, zeros
    cps, dps = [], []
    for k in range(nz):
        ak, bk, ck = (_level(x, k) for x in (a, b, c))
        denom = bk - ak * cp_prev
        cp_prev = ck / denom
        dp_prev = (d[..., k] - ak * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    phi = [None] * nz
    nxt = zeros
    for k in range(nz - 1, -1, -1):
        nxt = dps[k] - cps[k] * nxt
        phi[k] = nxt
    return torch.stack(phi, -1)


def fourier_tridiagonal_reference(lam_x, lam_y, m, lower, upper, dzc, b, pin):
    """The Fourier-tridiagonal solve of the transformed right-hand side
    ``b`` (nx', ny', nz), real or complex: the JAX solver's bands —
    λ_h = λx + λy − m, diag = −(lo + up) − λ_h·Δzᶜ, d = b·Δzᶜ (each part of
    a complex b scaled alone), and with ``pin`` the first row of mode
    (0, 0) set to φ = 0 — then ``solve_batched_tridiagonal_reference``.
    ``lam_x`` and ``lam_y`` are 1D (nx', ny'); the 1D bands (nz,)."""
    shape = b.shape
    lam_h = lam_x.reshape(-1, 1, 1) + lam_y.reshape(1, -1, 1) - m
    dz3 = dzc.reshape(1, 1, -1)
    lo = torch.broadcast_to(lower.reshape(1, 1, -1), shape)
    up = torch.broadcast_to(upper.reshape(1, 1, -1), shape)
    diag = torch.broadcast_to(-(lo + up) - lam_h * dz3, shape)
    parts = (b.real, b.imag) if b.is_complex() else (b,)
    ds = [p * dz3 for p in parts]
    if pin:
        sel = torch.zeros(shape, dtype=torch.bool, device=b.device)
        sel[0, 0, 0] = True
        diag = torch.where(sel, torch.ones_like(diag), diag)
        up = torch.where(sel, torch.zeros_like(up), up)
        ds = [torch.where(sel, torch.zeros_like(x), x) for x in ds]
    phis = [solve_batched_tridiagonal_reference(lo, diag, up, x) for x in ds]
    return torch.complex(*phis) if b.is_complex() else phis[0]


def _real_view(d):
    """(real dtype, values per point, contiguous real storage) of d."""
    if d.is_complex():
        return torch.view_as_real(d), 2
    return d, 1


def _check_band(name, band, d_real):
    nz = d_real.shape[2]
    if band.dtype != d_real.dtype or band.device != d_real.device:
        raise ValueError(f"{name}: expected {d_real.dtype} on {d_real.device}, "
                         f"got {band.dtype} on {band.device}")
    if tuple(band.shape) not in ((nz,), tuple(d_real.shape[:3])):
        raise ValueError(f"{name}: T1 takes a 1D band of {nz} levels or a 3D "
                         f"band of shape {tuple(d_real.shape[:3])}, got "
                         f"{tuple(band.shape)}")
    if not band.is_contiguous():
        raise ValueError(f"{name}: T1 takes contiguous bands")
    return int(band.ndim == 3)


def _check_rhs(d):
    if d.ndim != 3 or not d.is_contiguous():
        raise ValueError(f"T1 takes a contiguous 3D right-hand side, got "
                         f"shape {tuple(d.shape)}")
    real, nv = _real_view(d)
    if real.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"T1 takes float32/64 or complex64/128, got {d.dtype}")
    return real, nv


def _launch(a, b, c, d):
    real, nv = _check_rhs(d)
    flags = [_check_band(n, x, real) for n, x in (("a", a), ("b", b), ("c", c))]
    nx, ny, nz = d.shape
    out = torch.empty_like(d)
    cp = torch.empty((nx, ny, nz), dtype=real.dtype, device=d.device)
    fn = kernel_fn("batched_tridiagonal", "batched_tridiagonal", real.dtype,
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2)
    launch("batched_tridiagonal", fn, d.device, a.data_ptr(), b.data_ptr(),
           c.data_ptr(), *flags, d.data_ptr(), out.data_ptr(), cp.data_ptr(),
           nx * ny, nz, nv)
    solve_batched_tridiagonal.launches += 1
    return out


def solve_batched_tridiagonal(a, b, c, d):
    """φ with M(a, b, c) φ = d along the last axis. CUDA tensors go through
    the hand-written kernel T1 (a 3D ``d``, real or complex, and bands of
    its real type, each 1D (Nz,) or of d's shape; a failure raises and
    nothing falls back), CPU tensors through
    ``solve_batched_tridiagonal_reference``."""
    if d.device.type == "cuda":
        return _launch(a, b, c, d)
    if d.device.type != "cpu":
        raise ValueError(f"no solve_batched_tridiagonal for {d.device.type} tensors")
    return solve_batched_tridiagonal_reference(a, b, c, d)


def _launch_fourier(lam_x, lam_y, m, lower, upper, dzc, b, pin):
    real, nv = _check_rhs(b)
    nx, ny, nz = b.shape
    for name, x, n in (("lam_x", lam_x, nx), ("lam_y", lam_y, ny),
                       ("lower", lower, nz), ("upper", upper, nz),
                       ("dzc", dzc, nz)):
        check_tensor(name, x, (n,), real.dtype, b.device)
    out = torch.empty_like(b)
    cp = torch.empty((nx, ny, nz), dtype=real.dtype, device=b.device)
    fn = kernel_fn("batched_tridiagonal", "fourier_tridiagonal", real.dtype,
                   [ctypes.c_void_p] * 2 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)
    launch("fourier_tridiagonal", fn, b.device, lam_x.data_ptr(),
           lam_y.data_ptr(), float(m), lower.data_ptr(), upper.data_ptr(),
           dzc.data_ptr(), int(bool(pin)), b.data_ptr(), out.data_ptr(),
           cp.data_ptr(), nx, ny, nz, nv)
    solve_batched_tridiagonal.launches += 1
    return out


def fourier_tridiagonal(lam_x, lam_y, m, lower, upper, dzc, b, pin):
    """The Fourier-tridiagonal solve of the transformed right-hand side
    ``b`` (see ``fourier_tridiagonal_reference``). CUDA tensors go through
    T1's Fourier mode, which forms the bands in the kernel (a failure
    raises; nothing falls back), CPU tensors through
    ``fourier_tridiagonal_reference``."""
    if b.device.type == "cuda":
        return _launch_fourier(lam_x, lam_y, m, lower, upper, dzc, b, pin)
    if b.device.type != "cpu":
        raise ValueError(f"no fourier_tridiagonal for {b.device.type} tensors")
    return fourier_tridiagonal_reference(lam_x, lam_y, m, lower, upper, dzc, b,
                                         pin)


#: T1 launches since the last reset, by either wrapper (the plain versions
#: add nothing)
solve_batched_tridiagonal.launches = 0
