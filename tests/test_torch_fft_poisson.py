"""Port parity: the FFT Poisson solver and its DCT.

``dct2`` / ``idct2`` (the orthonormal DCT-II built from one FFT with
Makhoul's reordering) against ``scipy.fft.dct`` / ``idct`` with
``norm="ortho"``; the eigenvalues and ``FFTPoissonSolver.solve`` against
the JAX package's on (Periodic, Periodic, Bounded) and triply periodic
grids, f64. Tolerance: max|Δ| ≤ 1e-12·max|ref|. torch.fft and jnp.fft
(and scipy) are different FFT libraries and sum in different orders, so
the results agree to rounding, not bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.solvers import fft_poisson as tfp
from clima_oceananigans_jl_tpu.solvers import fft_poisson as jfp

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-12


def close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("n", [1, 2, 5, 8, 16, 31])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_dct2_and_inverse_match_scipy(n, dim):
    rng = np.random.default_rng(n + 10 * dim)
    shape = [3, 4, 5]
    shape[dim] = n
    x = rng.standard_normal(shape)
    X = sfft.dct(x, type=2, axis=dim, norm="ortho")
    close(X, tfp.dct2(torch.from_numpy(x), dim))
    close(sfft.idct(X, type=2, axis=dim, norm="ortho"),
          tfp.idct2(torch.from_numpy(X), dim))
    close(x, tfp.idct2(tfp.dct2(torch.from_numpy(x), dim), dim))


@pytest.mark.parametrize("topo", ["periodic", "bounded"])
def test_poisson_eigenvalues_match(topo):
    ref = jfp.poisson_eigenvalues(24, 2.0, J.Topology(topo), jnp.float64)
    got = tfp.poisson_eigenvalues(24, 2.0, T.Topology(topo), torch.float64)
    close(ref, got)


@pytest.mark.parametrize("topo", [("periodic", "periodic", "bounded"),
                                  ("periodic", "periodic", "periodic")],
                         ids=["PPB", "PPP"])
@pytest.mark.parametrize("size", [(16, 12, 10), (8, 8, 8)])
def test_fft_poisson_solve_matches(topo, size):
    jg = J.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5), topology=topo,
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5), topology=topo,
                           dtype=torch.float64, device=DEVICE)
    rhs = np.random.default_rng(3).standard_normal(size)
    rhs -= rhs.mean()
    ref = jfp.FFTPoissonSolver.build(jg).solve(jnp.asarray(rhs))
    got = tfp.FFTPoissonSolver.build(tg).solve(torch.from_numpy(rhs))
    assert got.dtype == torch.float64
    close(ref, got)


def test_fft_poisson_solve_inverts_the_laplacian():
    """The discrete staggered Laplacian of φ (periodic x, y; Neumann z)
    returns the zero-mean right-hand side."""
    size = (12, 10, 8)
    tg = T.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                           dtype=torch.float64, device=DEVICE)
    rhs = torch.from_numpy(np.random.default_rng(4).standard_normal(size))
    rhs = rhs - rhs.mean()
    phi = tfp.FFTPoissonSolver.build(tg).solve(rhs)
    dx, dy, dz = (L / n for L, n in zip((tg.Lx, tg.Ly, tg.Lz), size))
    lap = ((torch.roll(phi, -1, 0) - 2 * phi + torch.roll(phi, 1, 0)) / dx**2
           + (torch.roll(phi, -1, 1) - 2 * phi + torch.roll(phi, 1, 1)) / dy**2)
    pz = torch.cat([phi[:, :, :1], phi, phi[:, :, -1:]], 2)  # Neumann ghosts
    lap = lap + (pz[:, :, 2:] - 2 * phi + pz[:, :, :-2]) / dz**2
    close(rhs.numpy(), lap, rtol=1e-10)
