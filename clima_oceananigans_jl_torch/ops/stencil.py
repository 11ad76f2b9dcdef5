"""Index-space stencil micro-ops.

Counterpart of ``clima_oceananigans_jl_tpu/ops/stencil.py`` (Oceananigans'
difference and interpolation operators). Each op is a whole-array
expression of static shifts.

Shift convention: ``shift(f, n, axis)[i] = f[i + n]``, a ``torch.roll``.
Values wrapped across the array edge land in the halo region, which is
exactly right on periodic axes and overwritten by the next halo fill
otherwise. Stencil ops take arrays with valid halos and return arrays
whose interior is valid.

Naming follows the superscript convention: ``_c`` = result at centres
(input at faces), ``_f`` = result at faces (input at centres).
"""
from __future__ import annotations

import torch


def shift(f, n, axis):
    """shift(f, n, axis)[i] = f[i + n] (wrap into halos)."""
    if n == 0:
        return f
    return torch.roll(f, -n, axis)


# -- differences: δ ---------------------------------------------------------
def dc(f, axis):
    """δ onto centres: out[i] = f[i+1] - f[i] (f face-located)."""
    return shift(f, 1, axis) - f


def df(f, axis):
    """δ onto faces: out[i] = f[i] - f[i-1] (f centre-located)."""
    return f - shift(f, -1, axis)


# -- 2-point interpolations: ℑ ----------------------------------------------
def ic(f, axis):
    """ℑ onto centres: out[i] = (f[i+1] + f[i]) / 2 (f face-located)."""
    return 0.5 * (shift(f, 1, axis) + f)


def if_(f, axis):
    """ℑ onto faces: out[i] = (f[i] + f[i-1]) / 2 (f centre-located)."""
    return 0.5 * (f + shift(f, -1, axis))


def dxc(f):
    return dc(f, 0)


def dxf(f):
    return df(f, 0)


def dyc(f):
    return dc(f, 1)


def dyf(f):
    return df(f, 1)


def dzc(f):
    return dc(f, 2)


def dzf(f):
    return df(f, 2)


def ixc(f):
    return ic(f, 0)


def ixf(f):
    return if_(f, 0)


def iyc(f):
    return ic(f, 1)


def iyf(f):
    return if_(f, 1)


def izc(f):
    return ic(f, 2)


def izf(f):
    return if_(f, 2)


# -- 4th-order interpolations -------------------------------------------------
# The divisor 16 is a power of two: IEEE division by it and PyTorch's CUDA
# multiply by its reciprocal 1/16 round the same real number, so a Python
# scalar divisor gives the same bits on both devices (as the kernels' * 1/16).
def i4c(f, axis):
    """4th-order ℑ onto centres: (9(f[i]+f[i+1]) − (f[i−1]+f[i+2]))/16."""
    return (9.0 * (f + shift(f, 1, axis))
            - (shift(f, -1, axis) + shift(f, 2, axis))) / 16.0


def i4f(f, axis):
    """4th-order ℑ onto faces: (9(f[i−1]+f[i]) − (f[i−2]+f[i+1]))/16."""
    return (9.0 * (shift(f, -1, axis) + f)
            - (shift(f, -2, axis) + shift(f, 1, axis))) / 16.0
