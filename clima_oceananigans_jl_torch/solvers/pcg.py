"""Matrix-free preconditioned conjugate gradients.

Counterpart of ``clima_oceananigans_jl_tpu/solvers/pcg.py`` (Oceananigans'
preconditioned_conjugate_gradient_solver.jl): ``cg_solve(A, b, x0)`` with
a linear operator ``A(x)`` (a tensor function, e.g. the implicit
free-surface operator with its halo fills) and an optional
preconditioner ``M(r)``. The JAX package's ``lax.while_loop`` becomes a
Python loop whose stopping test reads the residual on the host once per
iteration. On a grid cut over a mesh of shards (``axis_names``) each
inner product is summed over the shards in shard order
(``parallel/mesh.py::psum``), so every shard reads the same residual and
stops at the same iteration.
"""
from __future__ import annotations

import torch


def cg_solve(A, b, x0, M=None, reltol=1e-8, abstol=0.0, maxiter=200,
             axis_names=()):
    """Solve A x = b (A symmetric positive definite) → (x, iterations,
    |r|²). ``axis_names``: the mesh axes to sum the inner products over
    when each shard holds a block of x and b."""
    if M is None:
        M = lambda r: r
    if axis_names:
        from ..parallel.mesh import psum
        dot = lambda a, c: psum(torch.sum(a * c), axis_names)
    else:
        dot = lambda a, c: torch.sum(a * c)
    x = x0
    r = b - A(x0)
    p = z = M(r)
    rho = dot(r, z)
    tol2 = max(reltol * reltol * float(dot(b, b)), abstol * abstol)
    it = 0
    while float(dot(r, r)) > tol2 and it < maxiter:
        Ap = A(p)
        alpha = rho / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rho_new = dot(r, z)
        beta = rho_new / rho
        p = z + beta * p
        rho = rho_new
        it += 1
    return x, it, float(dot(r, r))
