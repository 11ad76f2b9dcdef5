"""Advection schemes: reconstruction operators.

Counterpart of ``clima_oceananigans_jl_tpu/advection/schemes.py``
(Oceananigans' ``Advection`` module), on regular, stretched and
immersed grids, all seven of the JAX package's schemes and its
``PositiveWENO5``: ``CenteredSecondOrder`` and ``CenteredFourthOrder``
(symmetric interpolation), ``UpwindBiasedFirstOrder``,
``UpwindBiasedThirdOrder`` and ``UpwindBiasedFifthOrder`` (the two-sided
form with their fixed stencils), ``WENO5`` (Jiang-Shu weights:
select-first upwinding on regular axes, and on a stretched axis the
two-sided form with the per-index tables of
``advection/reconstruction_tables.py``), ``BoundsPreservingWENO5``
(WENO5 with each reconstruction clipped to the range of the two cells
beside it) and ``PositiveWENO5`` (WENO5 with the Zhang-Shu flux limiter
of Oceananigans' PositiveWENO on its to-faces transports, reconstructed
two-sided by ``left_right_to_f``); WENO5's two bfloat16 options; next to
an immersed boundary the conditional fluxes (Oceananigans'
conditional_fluxes.jl).

Conventions: reconstructions "to F" give a value at face i from
cell-centred data (face i sits between cells i-1 and i); "to C" give a
value at centre i from face data (the to-F formulas shifted by +1).

The expression trees are those of the JAX package, term by term, with
``x ** 2`` written ``x * x`` and every divisor a tensor on the data's
device; the hand-written kernels (``csrc/weno5_advection.cuh``) repeat
them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..grids.topology import BOUNDED
from ..ops.stencil import i4c, i4f, ic, if_, shift
from .reconstruction_tables import weno5_tables


@dataclasses.dataclass(frozen=True)
class AdvectionScheme:
    """Base: symmetric = 2nd-order centred."""

    #: extra halo cells needed beyond 1 (Oceananigans' ``boundary_buffer``)
    buffer: int = 0
    is_upwind: bool = False

    def sym_to_f(self, c, axis):
        return if_(c, axis)

    def sym_to_c(self, u, axis):
        return ic(u, axis)

    def left_to_f(self, c, axis):
        raise NotImplementedError

    def right_to_f(self, c, axis):
        raise NotImplementedError

    def left_to_c(self, u, axis):
        return shift(self.left_to_f(u, axis), 1, axis)

    def right_to_c(self, u, axis):
        return shift(self.right_to_f(u, axis), 1, axis)

    @property
    def required_halo(self):
        return max(1, self.buffer + 1)


@dataclasses.dataclass(frozen=True)
class CenteredSecondOrder(AdvectionScheme):
    buffer: int = 0


@dataclasses.dataclass(frozen=True)
class CenteredFourthOrder(AdvectionScheme):
    """4th-order centred interpolation (Oceananigans'
    centered_fourth_order.jl); near a wall or an immersed boundary it
    drops to the 2nd-order mean."""

    buffer: int = 1

    def sym_to_f(self, c, axis):
        return i4f(c, axis)

    def sym_to_c(self, u, axis):
        return i4c(u, axis)


def _full(c, v):
    """The constant v as a 0-d tensor of c's type on c's device: a Python
    scalar divisor becomes a multiply by its reciprocal in PyTorch's CUDA
    kernels, which rounds differently from IEEE division."""
    return torch.full((), v, dtype=c.dtype, device=c.device)


@dataclasses.dataclass(frozen=True)
class UpwindBiasedFirstOrder(AdvectionScheme):
    """Donor-cell upwinding (Oceananigans' upwind_biased_first_order.jl):
    the value of the upwind cell."""

    buffer: int = 0
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        return shift(c, -1, axis)

    def right_to_f(self, c, axis):
        return c


@dataclasses.dataclass(frozen=True)
class UpwindBiasedThirdOrder(AdvectionScheme):
    """3rd-order upwind-biased reconstruction with fixed coefficients
    (Oceananigans' upwind_biased_third_order.jl); the divisor 6 is a
    tensor, as UB5's 60."""

    buffer: int = 1
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * c + 5.0 * s(-1) - s(-2)) / _full(c, 6.0)

    def right_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (-s(1) + 5.0 * c + 2.0 * s(-1)) / _full(c, 6.0)


@dataclasses.dataclass(frozen=True)
class UpwindBiasedFifthOrder(AdvectionScheme):
    """5th-order upwind-biased reconstruction with fixed coefficients
    (Oceananigans' upwind_biased_fifth_order.jl). The divisor 60 is a
    tensor on the data's device, as WENO5's 6: a Python scalar divisor
    becomes a multiply by its reciprocal in PyTorch's CUDA kernels."""

    buffer: int = 2
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * s(-3) - 13.0 * s(-2) + 47.0 * s(-1) + 27.0 * c
                - 3.0 * s(1)) / _full(c, 60.0)

    def right_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * s(2) - 13.0 * s(1) + 47.0 * c + 27.0 * s(-1)
                - 3.0 * s(-2)) / _full(c, 60.0)


@dataclasses.dataclass(frozen=True)
class WENO5(AdvectionScheme):
    """5th-order WENO with Jiang-Shu smoothness weights, uniform-grid
    coefficients.

    The JAX package's two bfloat16 options, each bf16 operation rounded as
    torch rounds it: ``fast_bf16`` evaluates the whole reconstruction in
    bfloat16 and casts the result back (about three decimal digits of the
    reconstruction); ``bf16_smoothness`` evaluates only the Jiang-Shu
    smoothness indicators and the nonlinear weights of fp32 data in
    bfloat16, the candidate stencils in full precision. The plain versions
    and the kernels (``csrc/weno5_advection.cuh``, the bf16 forms) run
    both, bit for bit."""

    buffer: int = 2
    is_upwind: bool = True
    eps: float = 1e-6
    fast_bf16: bool = False
    bf16_smoothness: bool = False

    def stream_reconstruct(self, a):
        """Left-biased reconstruction of an upwind-ordered 5-point stream
        ``a = (a0..a4)`` (see ``upwind_stream``). The right-biased formulas
        are the left ones on the reflected stream, so one evaluation on
        the sign-selected stream gives the upwind flux."""
        if self.fast_bf16:
            out = self._weno_stream(tuple(x.to(torch.bfloat16) for x in a))
            return out.to(a[0].dtype)
        return self._weno_stream(a)

    def _weno_stream(self, a):
        a0, a1, a2, a3, a4 = a
        d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
        if self.bf16_smoothness and a0.dtype == torch.float32:
            # the indicator branch (second differences, βs, weights) in
            # bfloat16; the candidates and num/den stay fp32
            e11, e12 = d11.to(torch.bfloat16), d12.to(torch.bfloat16)
            d20 = e11 - d10.to(torch.bfloat16)
            d21 = e12 - e11
            d22 = d13.to(torch.bfloat16) - e12
            s0, s1, s2 = d20 + 2.0 * e11, e11 + e12, d22 - 2.0 * e12
        else:
            d20, d21, d22 = d11 - d10, d12 - d11, d13 - d12
            s0, s1, s2 = d20 + 2.0 * d11, d11 + d12, d22 - 2.0 * d12
        b0 = (13.0 / 12.0) * d20 * d20 + 0.25 * (s0 * s0)
        b1 = (13.0 / 12.0) * d21 * d21 + 0.25 * (s1 * s1)
        b2 = (13.0 / 12.0) * d22 * d22 + 0.25 * (s2 * s2)
        return self._combine(*self._candidates(a2, d10, d11, d12, d13),
                             b0, b1, b2)

    @staticmethod
    def _candidates(a2, d10, d11, d12, d13):
        """The three candidate polynomials p0, p1, p2. The divisor 6 is a
        tensor on the data's device: PyTorch's CUDA kernels turn a Python
        scalar divisor into a multiply by its reciprocal, which rounds
        differently from the IEEE division of the JAX package and the
        kernels."""
        six = _full(a2, 6.0)
        return (a2 + (5.0 * d11 - 2.0 * d10) / six,
                a2 + (2.0 * d12 + d11) / six,
                a2 + (4.0 * d12 - d13) / six)

    def stream_reconstruct_smooth(self, a, smooth_streams):
        """``stream_reconstruct`` of the candidate stream ``a`` with
        nonlinear weights from the mean Jiang-Shu smoothness of the
        upwind-ordered ``smooth_streams`` (Oceananigans' VelocityStencil,
        weno_fifth_order.jl:405-440)."""
        a0, a1, a2, a3, a4 = a
        d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
        p0, p1, p2 = self._candidates(a2, d10, d11, d12, d13)
        bs = []
        for v0, v1, v2, v3, v4 in smooth_streams:
            e10, e11, e12, e13 = v1 - v0, v2 - v1, v3 - v2, v4 - v3
            e20, e21, e22 = e11 - e10, e12 - e11, e13 - e12
            s0, s1, s2 = e20 + 2.0 * e11, e11 + e12, e22 - 2.0 * e12
            bs.append(((13.0 / 12.0) * e20 * e20 + 0.25 * (s0 * s0),
                       (13.0 / 12.0) * e21 * e21 + 0.25 * (s1 * s1),
                       (13.0 / 12.0) * e22 * e22 + 0.25 * (s2 * s2)))
        count = _full(a2, float(len(bs)))
        b0 = sum(b[0] for b in bs) / count
        b1 = sum(b[1] for b in bs) / count
        b2 = sum(b[2] for b in bs) / count
        return self._combine(p0, p1, p2, b0, b1, b2)

    def _nl_weights(self, b0, b1, b2, d=(0.1, 0.6, 0.3)):
        """Un-normalised nonlinear weights gk = dk Π_{j≠k}(βj+ε)² with the
        optimal weights d (uniform (0.1, 0.6, 0.3), or per-index rows on a
        stretched axis): the single-division form of αk = dk/(βk+ε)²."""
        eps = self.eps
        t0 = (b0 + eps) * (b0 + eps)
        t1 = (b1 + eps) * (b1 + eps)
        t2 = (b2 + eps) * (b2 + eps)
        return d[0] * (t1 * t2), d[1] * (t0 * t2), d[2] * (t0 * t1)

    def _combine(self, p0, p1, p2, b0, b1, b2, d=(0.1, 0.6, 0.3)):
        if self.bf16_smoothness and p0.dtype == torch.float32:
            b0, b1, b2 = (b.to(torch.bfloat16) for b in (b0, b1, b2))
        g0, g1, g2 = self._nl_weights(b0, b1, b2, d)
        if g0.dtype != p0.dtype:
            g0, g1, g2 = (g.to(p0.dtype) for g in (g0, g1, g2))
        num = g0 * p0 + g1 * p1 + g2 * p2
        den = g0 + g1 + g2
        return num / den  # IEEE division, as on the JAX plain path

    def left_right_to_f(self, c, axis):
        """Both biased reconstructions at faces with shared first and
        second differences (d1, d2) and 13/12·d2² terms: the JAX package's
        ``_weno_lr``, another expression tree than the stream's, which
        ``transport`` takes for ``PositiveWENO5``'s to-faces transports.
        Returns (L, R): L at face i from cells i−3..i+1, R from
        i−2..i+2."""
        if self.fast_bf16:
            L, R = self._weno_lr(c.to(torch.bfloat16), axis)
            return L.to(c.dtype), R.to(c.dtype)
        return self._weno_lr(c, axis)

    def _weno_lr(self, c, axis):
        s = lambda a, n: shift(a, n, axis)
        six = _full(c, 6.0)
        d1 = c - s(c, -1)            # d1[i] = c[i] − c[i−1]
        d2 = s(d1, 1) - d1           # d2[i] = c[i+1] − 2c[i] + c[i−1]
        t = (13.0 / 12.0) * d2 * d2
        d1m2, d1m1, d10, d1p1 = s(d1, -2), s(d1, -1), d1, s(d1, 1)
        d2m2, d2m1, d20, d2p1 = s(d2, -2), s(d2, -1), d2, s(d2, 1)
        tm2, tm1, t0_, tp1 = s(t, -2), s(t, -1), t, s(t, 1)
        cm1, c0 = s(c, -1), c
        sq = lambda x: x * x
        b0L = tm2 + 0.25 * sq(d2m2 + 2.0 * d1m1)
        b1L = tm1 + 0.25 * sq(d1m1 + d10)
        b2L = t0_ + 0.25 * sq(d20 - 2.0 * d10)
        p0L = cm1 + (5.0 * d1m1 - 2.0 * d1m2) / six
        p1L = cm1 + (2.0 * d10 + d1m1) / six
        p2L = cm1 + (4.0 * d10 - d1p1) / six
        b0R = tp1 + 0.25 * sq(d2p1 - 2.0 * d1p1)
        b1R = t0_ + 0.25 * sq(d1p1 + d10)
        b2R = tm1 + 0.25 * sq(d2m1 + 2.0 * d10)
        p0R = c0 - (5.0 * d1p1 - 2.0 * s(d1, 2)) / six
        p1R = c0 - (2.0 * d10 + d1p1) / six
        p2R = c0 - (4.0 * d10 - d1m1) / six
        return (self._combine(p0L, p1L, p2L, b0L, b1L, b2L),
                self._combine(p0R, p1R, p2R, b0R, b1R, b2R))

    def left_right_to_c(self, u, axis):
        L, R = self.left_right_to_f(u, axis)
        return shift(L, 1, axis), shift(R, 1, axis)

    def table_reconstruct(self, v, axis, tables, side):
        """Biased reconstruction of ``v`` with the per-index coefficient
        tables of a stretched axis (``side`` "left" or "right"): the
        geometry-exact stencil polynomials and optimal weights, uniform
        Jiang–Shu smoothness indicators (``fast_bf16``: in bfloat16, the
        rows too)."""
        if self.fast_bf16:
            return self._table_eval(v.to(torch.bfloat16), axis, tables[side]).to(v.dtype)
        return self._table_eval(v, axis, tables[side])

    def _table_eval(self, v, axis, side_tables):
        def bx(row):
            shape = [1, 1, 1]
            shape[axis] = row.shape[0]
            return row.reshape(shape).to(v.dtype)

        ps, bs, ds = [], [], []
        for d, cj, voff, kind in side_tables:
            w0, w1, w2 = (shift(v, o, axis) for o in voff)
            ps.append(bx(cj[0]) * w0 + bx(cj[1]) * w1 + bx(cj[2]) * w2)
            if kind == 0:
                t2 = w0 - 4.0 * w1 + 3.0 * w2
            elif kind == 1:
                t2 = w0 - w2
            else:
                t2 = 3.0 * w0 - 4.0 * w1 + w2
            q = w0 - 2.0 * w1 + w2
            bs.append((13.0 / 12.0) * (q * q) + 0.25 * t2 * t2)
            ds.append(bx(d))
        return self._combine(*ps, *bs, d=tuple(ds))


@dataclasses.dataclass(frozen=True)
class BoundsPreservingWENO5(WENO5):
    """WENO5 with each face reconstruction clipped to the range of the two
    cells beside it, in the spirit of Oceananigans' positivity-preserving
    limiter: it limits the reconstruction's overshoot, not the fluxes
    (``PositiveWENO5`` gives the flux-level guarantee). ``transport``
    clips the stream's reconstruction on the select-first route and L and
    R on the stretched axis' table route, before the near-wall selects and
    the immersed fallback, the JAX order."""

    def _clip(self, rec, c, axis, to_f):
        """``jnp.clip(rec, lo, hi)`` as the JAX package evaluates it,
        ``minimum(hi, maximum(lo, rec))``, with lo and hi the minimum and
        maximum of the cells below and above the flux location."""
        a, b = (shift(c, -1, axis), c) if to_f else (c, shift(c, 1, axis))
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        return torch.minimum(hi, torch.maximum(lo, rec))

    def left_right_to_f(self, c, axis):
        L, R = super().left_right_to_f(c, axis)
        return self._clip(L, c, axis, True), self._clip(R, c, axis, True)

    def left_right_to_c(self, u, axis):
        L, R = super().left_right_to_c(u, axis)
        return self._clip(L, u, axis, False), self._clip(R, u, axis, False)


@dataclasses.dataclass(frozen=True)
class PositiveWENO5(WENO5):
    """WENO5 with the flux-level bound-preserving limiter of Oceananigans'
    PositiveWENO (the Zhang-Shu limiter): per cell and axis, the cell's two
    outward face reconstructions are scaled toward the cell mean by

        θ = min(|hi − c|/|M − c|, |lo − c|/|m − c|, 1),
        M/m = max/min(p̃, c₊ᴸ, c₋ᴿ),  p̃ = (c − ω̂(c₋ᴿ + c₊ᴸ))/(1 − 2ω̂),

    ω̂ = 5/18, which keeps a divergence-form tracer update inside
    ``bounds`` under the scheme's CFL restriction. ``transport`` applies it
    to the to-faces transports (cell-centred tracers); to centres the
    scheme is WENO5's stream."""

    bounds: tuple = (0.0, float("inf"))

    def limit_lr(self, c, L, R, axis):
        """(L, R) at faces → the limited (L, R). ``L[i]`` is cell i−1's
        outward (rightgoing) reconstruction, ``R[i]`` cell i's outward
        (leftgoing) one. ω̂ and the bounds round to the field's type as the
        JAX package's weak-typed constants do; the divisor 1 − 2ω̂ is a
        tensor, and ``torch.minimum``/``torch.maximum`` propagate NaN as
        ``jnp.minimum``/``jnp.maximum`` do."""
        omega = 5.0 / 18.0
        eps = 1e-20
        lo, hi = self.bounds
        full = lambda v: _full(c, v)
        Lp1 = shift(L, 1, axis)    # cell i's outward value at face i+1
        p = (c - omega * (R + Lp1)) / full(1.0 - 2.0 * omega)
        M = torch.maximum(torch.maximum(p, Lp1), R)
        m = torch.minimum(torch.minimum(p, Lp1), R)
        theta = torch.minimum(((hi - c) / (M - c + eps)).abs(),
                              ((lo - c) / (m - c + eps)).abs())
        theta = torch.minimum(theta, full(1.0))
        Lp1_lim = theta * (Lp1 - c) + c
        R_lim = theta * (R - c) + c
        return shift(Lp1_lim, -1, axis), R_lim


def upwind_stream(c, sel, axis, to_f):
    """Sign-selected upwind 5-point stream at the flux location: element k
    is the k-th cell of the left-biased stencil where ``sel`` (vel ≥ 0)
    and of the right-biased stencil otherwise, ordered so that the
    left-biased formulas apply to both."""
    s = lambda n: shift(c, n, axis)
    if to_f:
        left = (s(-3), s(-2), s(-1), c, s(1))
        right = (s(2), s(1), c, s(-1), s(-2))
    else:
        left = (s(-2), s(-1), c, s(1), s(2))
        right = (s(3), s(2), s(1), c, s(-1))
    return tuple(torch.where(sel, l, r) for l, r in zip(left, right))


def upwind_biased_product(vel, left, right):
    """vel·ψ upwind product ((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ)/2 (Oceananigans'
    upwind_biased_advective_fluxes.jl)."""
    return 0.5 * ((vel + vel.abs()) * left + (vel - vel.abs()) * right)


def reduced_order_masks(grid, axis, scheme):
    """Near-wall order reduction along a bounded axis (Oceananigans'
    topologically conditional interpolation). None when nothing reduces
    (periodic axis, or ``required_halo <= 1``); otherwise a
    ``(sym, left, right)`` triple of inclusive with-halo index bounds of
    the region where the full-order stencil reads only interior (and
    first-ghost) cells. Outside, ``transport`` falls back to 2nd-order
    centred interpolation."""
    Nb = scheme.required_halo
    if Nb <= 1 or grid.topology[axis] is not BOUNDED:
        return None
    N = grid.shape[axis]
    H = grid.halo[axis]
    # 1-based face/centre index i = idx-H+1:
    #   symmetric: Nb+1 ≤ i ≤ N-Nb;  left: Nb+1 ≤ i ≤ N+1-Nb;
    #   right: Nb ≤ i ≤ N-Nb
    return ((H + Nb, H + N - Nb - 1),
            (H + Nb, H + N - Nb),
            (H + Nb - 1, H + N - Nb - 1))


def _axis_index(shape, axis, device):
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(view)


def _in_bounds(bounds, like, axis):
    """True where the index along ``axis`` lies in the inclusive bounds."""
    idx = _axis_index(like.shape, axis, like.device)
    return (idx >= bounds[0]) & (idx <= bounds[1])


def _immersed_clear(imm, data_loc, axis, to_f, buffer):
    """True where every cell the high-order stencil reads is fluid (the
    conditional fluxes of Oceananigans' conditional_fluxes.jl): no solid
    cell in [−(buffer+1), buffer] along ``axis`` for a flux to faces, in
    [−buffer, buffer+1] to centres (with-halo rolls)."""
    solid = imm.mask_for(tuple(data_loc))
    lo, hi = (-(buffer + 1), buffer) if to_f else (-buffer, buffer + 1)
    near = solid
    for o in range(lo, hi + 1):
        if o:
            near = near | shift(solid, o, axis)
    return ~near


def transport(scheme, vel, c, axis, to_f, grid=None, data_loc=None):
    """Advective transport vel·ψ at the flux location along ``axis``.

    ``to_f=True``: flux at faces along ``axis`` (c centred there); else
    the reverse. ``vel`` already lives at the flux location. With a
    ``grid`` whose ``axis`` is bounded, high-order reconstructions drop to
    2nd-order centred within ``required_halo`` cells of the walls. On a
    stretched axis WENO5 reconstructs both sides with the axis' tables,
    applies the near-wall selects to each and takes the upwind product,
    the JAX tree; elsewhere WENO5 reconstructs select-first.
    ``BoundsPreservingWENO5`` clips what either route reconstructs before
    the selects. A scheme without a stream reconstruction (the fixed
    upwind-biased ones) takes the two-sided route with its
    ``left_to_f``/``right_to_f`` forms (to centres: those forms shifted
    by one), and so do ``PositiveWENO5``'s
    to-faces transports with ``left_right_to_f``, whose (L, R) pass
    through the near-wall selects and the immersed fallback into
    ``limit_lr`` before the upwind product, the JAX order. On a grid with
    an immersed boundary and the advected field's location ``data_loc``,
    a flux whose stencil reaches a solid cell drops to first-order upwind
    (``_immersed_clear``), a centred one to the 2nd-order mean; the
    2nd-order and first-order schemes read no cell beyond their two."""
    masks = reduced_order_masks(grid, axis, scheme) if grid is not None else None
    lo_val = lambda: if_(c, axis) if to_f else ic(c, axis)
    in_bounds = lambda b, like: _in_bounds(b, like, axis)
    imm = getattr(grid, "immersed", None) if grid is not None else None
    clear = None
    if imm is not None and data_loc is not None and scheme.buffer > 0:
        clear = _immersed_clear(imm, data_loc, axis, to_f, scheme.buffer)
    if not scheme.is_upwind:
        hi = scheme.sym_to_f(c, axis) if to_f else scheme.sym_to_c(c, axis)
        if masks is not None:
            hi = torch.where(in_bounds(masks[0], hi), hi, lo_val())
        if clear is not None:
            hi = torch.where(clear, hi, lo_val())
        return vel * hi
    tables = (weno5_tables(grid, axis, to_f)
              if grid is not None and isinstance(scheme, WENO5) else None)
    limited = isinstance(scheme, PositiveWENO5) and to_f
    clipped = isinstance(scheme, BoundsPreservingWENO5)
    if (tables is not None or not hasattr(scheme, "stream_reconstruct")
            or limited):
        if tables is not None:
            L = scheme.table_reconstruct(c, axis, tables, "left")
            R = scheme.table_reconstruct(c, axis, tables, "right")
            if clipped:
                L = scheme._clip(L, c, axis, to_f)
                R = scheme._clip(R, c, axis, to_f)
        elif hasattr(scheme, "left_right_to_f"):
            L, R = (scheme.left_right_to_f(c, axis) if to_f
                    else scheme.left_right_to_c(c, axis))
        elif to_f:
            L, R = scheme.left_to_f(c, axis), scheme.right_to_f(c, axis)
        else:
            L, R = scheme.left_to_c(c, axis), scheme.right_to_c(c, axis)
        if masks is not None:
            lo = lo_val()
            L = torch.where(in_bounds(masks[1], L), L, lo)
            R = torch.where(in_bounds(masks[2], R), R, lo)
        if clear is not None:  # first-order upwind next to the solid
            L = torch.where(clear, L, shift(c, -1, axis) if to_f else c)
            R = torch.where(clear, R, c if to_f else shift(c, 1, axis))
        if limited:  # the flux-level Zhang-Shu limiter
            L, R = scheme.limit_lr(c, L, R, axis)
        return upwind_biased_product(vel, L, R)
    # select-first upwinding: pick the upwind stencil by sign(vel) and
    # reconstruct once; vel·L or vel·R exactly, as the two-sided blend
    sel = vel >= 0
    a = upwind_stream(c, sel, axis, to_f)
    rec = scheme.stream_reconstruct(a)
    if clipped:
        rec = scheme._clip(rec, c, axis, to_f)
    if masks is not None:
        in_l, in_r = in_bounds(masks[1], rec), in_bounds(masks[2], rec)
        rec = torch.where((sel & in_l) | (~sel & in_r), rec, lo_val())
    if clear is not None:  # a[2]: first-order upwind
        rec = torch.where(clear, rec, a[2])
    return vel * rec
