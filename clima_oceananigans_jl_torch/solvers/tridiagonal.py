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
``solve_batched_tridiagonal.launches`` (the Fourier mode's also in
``fourier_tridiagonal.launches``). ``solve_batched_tridiagonal`` reads and
writes strided views (a with-halo field's interior levels) through
``out=``, as its plain version does; ``plan`` asks the kernel's launcher
which of its forms a call takes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _build
from ..ops.fused_tendencies import check_tensor, kernel_fn, launch


def _level(band, k):
    """Band entries of level k: a 0-d tensor of a 1D band (broadcast over
    the plane), the (..., k) plane of a 3D one."""
    return band[k] if band.ndim == 1 else band[..., k]


def solve_batched_tridiagonal_reference(a, b, c, d, out=None):
    """Thomas algorithm along the last axis of ``d``; a[..., 0] and
    c[..., -1] enter as in the JAX function (multiplied by zeros). Bands are
    1D (Nz,) or broadcast against ``d``; a complex ``d`` is solved as its
    real and imaginary parts. With ``out`` (of d's shape and type, a view
    of a with-halo field for instance) the solution is copied into it and
    ``out`` returned."""
    if out is not None:
        return out.copy_(solve_batched_tridiagonal_reference(a, b, c, d))
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
    """(values per point: 2 for a complex d, else 1; its real type)."""
    if d.is_complex():
        return 2, torch.view_as_real(d).dtype
    return 1, d.dtype


def _column_strides(name, t, shape, nv):
    """The (x, y) strides of the (X, Y, Z) tensor ``t``, in elements of its
    real type, after checking its shape and that z is contiguous; an axis
    of one point has stride 0."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"{name}: T1 takes z contiguous (stride 1), got "
                         f"strides {t.stride()}")
    st = [t.stride(i) * nv if t.shape[i] > 1 else 0 for i in (0, 1)]
    if min(st) < 0:
        raise ValueError(f"{name}: T1 takes non-negative strides, got {t.stride()}")
    return st


def _check_band(name, band, dtype, device, shape):
    """(is 3D, its (x, y) strides) of a band for T1: 1D (nz,) and
    contiguous, or of d's shape with z contiguous; a 3D band broadcast
    from one column (x and y strides 0) is passed as the 1D band it is."""
    nz = shape[2]
    if band.dtype != dtype or band.device != device:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{band.dtype} on {band.device}")
    if tuple(band.shape) == (nz,):
        if nz > 1 and band.stride(0) != 1:
            raise ValueError(f"{name}: T1 takes contiguous 1D bands")
        return 0, [0, 0]
    if tuple(band.shape) != tuple(shape):
        raise ValueError(f"{name}: T1 takes a 1D band of {nz} levels or a 3D "
                         f"band of shape {tuple(shape)}, got {tuple(band.shape)}")
    st = _column_strides(name, band, shape, 1)
    return int(st != [0, 0]), st


def _check_rhs(d, out):
    """(values per point, real type, d's strides, out's strides) of a 3D
    right-hand side and the output it is solved into: z contiguous, out's
    columns apart (x slowest)."""
    if d.ndim != 3:
        raise ValueError(f"T1 takes a 3D right-hand side, got shape {tuple(d.shape)}")
    nv, real = _real_view(d)
    if real not in (torch.float32, torch.float64):
        raise ValueError(f"T1 takes float32/64 or complex64/128, got {d.dtype}")
    if out.dtype != d.dtype or out.device != d.device:
        raise ValueError(f"out: expected {d.dtype} on {d.device}, got "
                         f"{out.dtype} on {out.device}")
    nx, ny, nz = d.shape
    sd = _column_strides("d", d, d.shape, nv)
    so = _column_strides("out", out, d.shape, nv)
    if (ny > 1 and so[1] < nz * nv) or (nx > 1 and so[0] < max(ny * so[1], nz * nv)):
        raise ValueError(f"out: T1 writes columns that must not overlap, x "
                         f"slowest; got strides {out.stride()}")
    if (out.untyped_storage().data_ptr() == d.untyped_storage().data_ptr()
            and (out.data_ptr(), so) != (d.data_ptr(), sd)):
        raise ValueError("out: T1 writes in place only over d itself")
    return nv, real, sd, so


def plan(nz, nv, dtype, any3d=False, fourier=False):
    """T1's launch plan as its launcher makes it (``csrc/batched_tridiagonal.cu``
    ``batched_tridiagonal_plan``; loads the kernel's library): (mode: 0 the
    1D bands' table, 1 a column's own cp, 2 the Fourier mode; levels a
    chunk; dynamic shared memory a block, bytes)."""
    return _plan(nz, nv, dtype, bool(any3d), bool(fourier))


@functools.lru_cache(maxsize=None)
def _plan(nz, nv, dtype, any3d, fourier):
    fn = _build.load("batched_tridiagonal").batched_tridiagonal_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 3)()
    size = torch.finfo(dtype).bits // 8
    rc = fn(nz, nv, size, int(any3d), int(fourier), out)
    if rc != 0:
        raise ValueError(f"T1 has no plan for nz={nz}, nv={nv}, {dtype} (CUDA error {rc})")
    return tuple(out)


def _scratch(p, shape, real, device):
    """The cp scratch of a plan whose cp is a column's own and leaves the
    SM between the sweeps (more than one chunk), or None."""
    if p[0] == 0 or shape[2] <= p[1]:
        return None
    return torch.empty(tuple(shape), dtype=real, device=device)


def _launch(a, b, c, d, out=None):
    out = torch.empty_like(d) if out is None else out
    nv, real, sd, so = _check_rhs(d, out)
    shape = tuple(d.shape)
    checked = [_check_band(n, x, real, d.device, shape)
               for n, x in (("a", a), ("b", b), ("c", c))]
    flags = [f for f, _ in checked]
    strides = (ctypes.c_longlong * 10)(*[s for _, st in checked for s in st], *sd, *so)
    nx, ny, nz = shape
    cp = _scratch(plan(nz, nv, real, any(flags)), shape, real, d.device)
    fn = kernel_fn("batched_tridiagonal", "batched_tridiagonal", real,
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
    launch("batched_tridiagonal", fn, d.device, a.data_ptr(), b.data_ptr(),
           c.data_ptr(), *flags, strides, d.data_ptr(), out.data_ptr(),
           None if cp is None else cp.data_ptr(), nx, ny, nz, nv)
    solve_batched_tridiagonal.launches += 1
    return out


def solve_batched_tridiagonal(a, b, c, d, out=None):
    """φ with M(a, b, c) φ = d along the last axis, written into ``out``
    (a new tensor when None) and returned. CUDA tensors go through the
    hand-written kernel T1: a 3D ``d``, real or complex, whose z stride is
    1 and whose x and y strides are any (a view of a with-halo field's
    interior levels), an ``out`` of the same kind, bands of d's real type,
    each 1D (Nz,) and contiguous or of d's shape with z contiguous; a
    failure raises and nothing falls back. CPU tensors go through
    ``solve_batched_tridiagonal_reference``."""
    if d.device.type == "cuda":
        return _launch(a, b, c, d, out)
    if d.device.type != "cpu":
        raise ValueError(f"no solve_batched_tridiagonal for {d.device.type} tensors")
    return solve_batched_tridiagonal_reference(a, b, c, d, out)


def _launch_fourier(lam_x, lam_y, m, lower, upper, dzc, b, pin):
    if b.ndim != 3 or not b.is_contiguous():
        raise ValueError(f"T1's Fourier mode takes a contiguous 3D spectrum, "
                         f"got shape {tuple(b.shape)}")
    out = torch.empty_like(b)
    nv, real, _, _ = _check_rhs(b, out)
    nx, ny, nz = b.shape
    for name, x, n in (("lam_x", lam_x, nx), ("lam_y", lam_y, ny),
                       ("lower", lower, nz), ("upper", upper, nz),
                       ("dzc", dzc, nz)):
        check_tensor(name, x, (n,), real, b.device)
    cp = _scratch(plan(nz, nv, real, False, True), b.shape, real, b.device)
    fn = kernel_fn("batched_tridiagonal", "fourier_tridiagonal", real,
                   [ctypes.c_void_p] * 2 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)
    launch("fourier_tridiagonal", fn, b.device, lam_x.data_ptr(),
           lam_y.data_ptr(), float(m), lower.data_ptr(), upper.data_ptr(),
           dzc.data_ptr(), int(bool(pin)), b.data_ptr(), out.data_ptr(),
           None if cp is None else cp.data_ptr(), nx, ny, nz, nv)
    solve_batched_tridiagonal.launches += 1
    fourier_tridiagonal.launches += 1
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
#: add nothing); those of its Fourier mode also in ``fourier_tridiagonal``'s
solve_batched_tridiagonal.launches = 0
fourier_tridiagonal.launches = 0
