"""Fused advective tendencies: −∇·(vψ) of u, v, w and every tracer in one
kernel launch.

Counterpart of ``clima_oceananigans_jl_tpu/ops/fused_tendencies.py``
(``supports_fused_advection``, ``z_halo_free_ok`` and the Pallas kernel
``fused_advective_tendencies``). The result is what the JAX function
returns: a dict of with-halo tensors, valid on the interior.

``fused_advective_tendencies`` is the wrapper: on CUDA tensors it launches
the hand-written kernel ``csrc/fused_advective_tendencies.cu`` (or
raises), on CPU tensors it runs ``fused_advective_tendencies_reference``,
the same function in plain PyTorch (the ``div_*`` fluxes of
``advection/fluxes.py``). The kernel's halos are zero; the plain
version's hold whatever the whole-array stencils left there.
"""
from __future__ import annotations

import ctypes

import torch

from ..advection.fluxes import div_Uc, div_vu, div_vv, div_vw
from ..advection.schemes import CenteredSecondOrder, WENO5, reduced_order_masks
from ..grids.topology import BOUNDED, PERIODIC
from . import _build


def supports_fused_advection(grid):
    """The fused advection applies: x and y not bounded (the near-wall
    order reduction is z-only in the kernels)."""
    return (grid.topology[0] is not BOUNDED and grid.topology[1] is not BOUNDED
            and grid.Hy >= 1 and grid.Nz >= 1)


def z_halo_free_ok(grid, w_bcs=None):
    """The JAX package's test for z-halo-free kernel blocks: periodic z,
    or bounded z with impenetrable (zero open/value) w walls. The port's
    kernels read real z halos either way; the model uses this test only
    to choose the JAX package's ``G_prev`` layout."""
    if grid.shape[2] <= 1 or grid.halo[2] == 0:
        return False
    topo = grid.topology[2]
    if topo is PERIODIC:
        return True
    if topo is not BOUNDED or w_bcs is None:
        return False
    for bc in (w_bcs.bottom, w_bcs.top):
        if bc is None or bc.kind not in ("open", "value"):
            return False
        v = bc.value
        if not (v is None or (isinstance(v, (int, float)) and v == 0.0)):
            return False
    return True


def fused_advective_tendencies_reference(grid, scheme, tracer_scheme, u, v, w,
                                         tracers):
    """The plain-PyTorch version of the kernel: −div_vu, −div_vv, −div_vw
    and −div_Uc of each tracer, with halos."""
    out = dict(u=-div_vu(grid, scheme, u, v, w),
               v=-div_vv(grid, scheme, u, v, w),
               w=-div_vw(grid, scheme, u, v, w))
    for name, c in tracers.items():
        out[name] = -div_Uc(grid, tracer_scheme, u, v, w, c)
    return out


def kernel_scheme(scheme):
    """(weno flag, eps) of a scheme the kernels take; raises otherwise."""
    if type(scheme) is WENO5:
        return 1, float(scheme.eps)
    if type(scheme) is CenteredSecondOrder:
        return 0, 0.0
    raise ValueError("the kernels take WENO5 or CenteredSecondOrder "
                     f"advection, not {type(scheme).__name__}")


def advection_args(grid, scheme, tracer_scheme, nf):
    """The shared advection arguments of K1 and K2 after the pointer
    arrays: field count, sizes, halos, schemes, z masks, eps, spacings."""
    if not 3 <= nf <= 16:
        raise ValueError(f"the kernels take 3 to 16 fields, got {nf}")
    if not supports_fused_advection(grid):
        raise ValueError(f"the kernels take no bounded x or y axis: {grid}")
    weno_m, eps_m = kernel_scheme(scheme)
    weno_t, eps_t = kernel_scheme(tracer_scheme)
    # every WENO5 has the same near-wall bounds; centred schemes have none
    weno = scheme if weno_m else tracer_scheme
    masks = reduced_order_masks(grid, 2, weno)
    (_, (lo_l, hi_l), (lo_r, hi_r)) = masks or (None, (0, -1), (0, -1))
    return (nf, *grid.shape, *grid.halo, weno_m, weno_t,
            int(masks is not None), lo_l, hi_l, lo_r, hi_r, eps_m, eps_t,
            grid.Lx / grid.Nx, grid.Ly / grid.Ny, grid.Lz / grid.Nz)


#: ctypes types of ``advection_args``
ADVECTION_ARGTYPES = [ctypes.c_int] * 14 + [ctypes.c_double] * 5


def check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernels take contiguous tensors")


def pointers(ts):
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _kernel_fn(dtype):
    lib = _build.load("fused_advective_tendencies")
    fn = (lib.fused_advective_tendencies_f32 if dtype == torch.float32
          else lib.fused_advective_tendencies_f64)
    fn.argtypes = [ctypes.c_void_p] * 2 + ADVECTION_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(grid, scheme, tracer_scheme, u, v, w, tracers):
    names = ("u", "v", "w") + tuple(tracers)
    fields = [u, v, w] + list(tracers.values())
    device, dtype = u.device, grid.dtype
    args = advection_args(grid, scheme, tracer_scheme, len(fields))
    for n, f in zip(names, fields):
        check_tensor(n, f, grid.total_shape, dtype, device)
    out = [torch.zeros(grid.total_shape, dtype=dtype, device=device)
           for _ in names]
    fn = _kernel_fn(dtype)
    with torch.cuda.device(device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(pointers(fields), pointers(out), *args, stream)
    if rc != 0:
        raise RuntimeError("fused_advective_tendencies kernel launch failed: "
                           f"CUDA error {rc}")
    fused_advective_tendencies.launches += 1
    return dict(zip(names, out))


def fused_advective_tendencies(grid, scheme, tracer_scheme, u, v, w, tracers):
    """−∇·(advective fluxes) of u, v, w and every tracer → a dict of
    with-halo tensors valid on the interior. CUDA tensors go through the
    hand-written kernel (a failure raises; nothing falls back), CPU tensors
    through ``fused_advective_tendencies_reference``."""
    if u.device.type == "cuda":
        return _launch(grid, scheme, tracer_scheme, u, v, w, tracers)
    if u.device.type != "cpu":
        raise ValueError(f"no fused_advective_tendencies for {u.device.type} "
                         "tensors")
    return fused_advective_tendencies_reference(grid, scheme, tracer_scheme,
                                                u, v, w, tracers)


#: kernel launches since the last reset (the plain version adds nothing)
fused_advective_tendencies.launches = 0
