"""Port parity: the batched tridiagonal solve (T1's plain version) and the
Fourier-tridiagonal pressure solve of a grid stretched in z.

- ``solve_batched_tridiagonal_reference`` against the JAX
  ``solve_batched_tridiagonal`` (two ``lax.scan``s) with 1D, 3D and mixed
  bands, within ``1e-14`` of max|φ|: the same expression trees, but XLA's
  CPU backend may contract b − a·cp into one FMA where PyTorch rounds
  twice;
- 1D bands against the same bands broadcast to 3D, bit for bit (the
  port's counterpart of ``tests/test_implicit_diffusion.py:133``), and a
  complex right-hand side against its two real solves, bit for bit;
- ``fourier_tridiagonal`` (its plain version on the CPU) against its
  reference form, bit for bit;
- ``FourierTridiagonalSolver`` against the JAX solver on (P, P, B),
  (B, P, B) and (P, B, B) grids with a stretched z, with m = 0 and
  m ≠ 0, within ``1e-10`` of max|φ|: the horizontal transforms differ
  (the port's real FFT and FFT-based DCT against JAX's complex ``fftn``
  and scipy-style DCT), which leaves rounding of ~1e-14 that the
  tridiagonal sweeps carry;
- the discrete Poisson residual of the port's solve, as
  ``tests/test_poisson_solvers.py:42`` checks the JAX one (1e-8).

The ``cuda`` cases hold T1 on the card against its plain version, bit for
bit (``python -m pytest --noconftest -m cuda tests/test_torch_tridiagonal.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.ops import operators as top
from clima_oceananigans_jl_torch.solvers import tridiagonal as ttri
from clima_oceananigans_jl_torch.solvers.fourier_tridiagonal import (
    FourierTridiagonalSolver)

try:  # the cuda cases also run on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.solvers.fourier_tridiagonal import (
        FourierTridiagonalSolver as JFourier)
    from clima_oceananigans_jl_tpu.solvers.tridiagonal import (
        solve_batched_tridiagonal as jsolve)
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"


def bands(rng, shape, kinds, complex_rhs=False):
    """(a, b, c, d) numpy arrays: each band 1D (nz) or 3D after ``kinds``,
    diagonally dominant."""
    nz = shape[-1]
    out = []
    for k, off in zip(kinds, (0.0, 6.0, 0.0)):
        s = (nz,) if k == "1d" else shape
        out.append(rng.standard_normal(s) + off)
    d = rng.standard_normal(shape)
    if complex_rhs:
        d = d + 1j * rng.standard_normal(shape)
    return out + [d]


KINDS = {"1d": ("1d", "1d", "1d"), "3d": ("3d", "3d", "3d"),
         "mixed": ("1d", "3d", "1d"), "mixed2": ("3d", "1d", "3d")}


@pytest.mark.parametrize("shape", [(5, 4, 7), (8, 3, 16), (1, 1, 2)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_solve_matches_jax(kind, shape):
    a, b, c, d = bands(np.random.default_rng(1), shape, KINDS[kind])
    ref = np.asarray(jsolve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                            jnp.asarray(d)))
    got = ttri.solve_batched_tridiagonal_reference(
        *(torch.as_tensor(x) for x in (a, b, c, d))).numpy()
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(5, 4, 7), (9, 6, 12), (3, 3, 1)])
def test_1d_bands_bitwise_3d_bands(shape):
    a, b, c, d = (torch.as_tensor(x) for x in
                  bands(np.random.default_rng(2), shape, KINDS["1d"]))
    full = [torch.broadcast_to(x.reshape(1, 1, -1), shape).contiguous()
            for x in (a, b, c)]
    assert torch.equal(ttri.solve_batched_tridiagonal_reference(a, b, c, d),
                       ttri.solve_batched_tridiagonal_reference(*full, d))


@pytest.mark.parametrize("kind", ["1d", "mixed"])
def test_complex_rhs_is_two_real_solves(kind):
    a, b, c, d = (torch.as_tensor(x) for x in
                  bands(np.random.default_rng(3), (6, 5, 9), KINDS[kind], True))
    got = ttri.solve_batched_tridiagonal(a, b, c, d)
    assert torch.equal(got.real, ttri.solve_batched_tridiagonal_reference(
        a, b, c, d.real))
    assert torch.equal(got.imag, ttri.solve_batched_tridiagonal_reference(
        a, b, c, d.imag))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, b, c, d = (torch.as_tensor(x) for x in
                  bands(np.random.default_rng(4), (4, 4, 6), KINDS["mixed"]))
    n = ttri.solve_batched_tridiagonal.launches
    assert torch.equal(ttri.solve_batched_tridiagonal(a, b, c, d),
                       ttri.solve_batched_tridiagonal_reference(a, b, c, d))
    assert ttri.solve_batched_tridiagonal.launches == n


def stretched_faces(nz, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, nz))])


TOPOLOGIES = {"PPB": ("periodic", "periodic"), "BPB": ("bounded", "periodic"),
              "PBB": ("periodic", "bounded")}


def grids(topo, size=(8, 6, 10)):
    tx, ty = TOPOLOGIES[topo]
    z = stretched_faces(size[2])
    jg = J.RectilinearGrid(size=size, x=(0, 1.5), y=(0, 1), z=z,
                           topology=(tx, ty, "bounded"), dtype=jnp.float64)
    tg = T.RectilinearGrid(size=size, x=(0, 1.5), y=(0, 1), z=z,
                           topology=(T.Topology(tx), T.Topology(ty), T.BOUNDED),
                           dtype=torch.float64, device=DEVICE)
    return jg, tg


def mean_free_rhs(tg, seed):
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(tg.shape)
    w = torch.broadcast_to(tg.V(T.CENTER), tg.total_shape)[tg.interior_slices].numpy()
    return rhs - (rhs * w).sum() / w.sum()


@pytest.mark.parametrize("m", [0.0, -2.5])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_fourier_tridiagonal_matches_jax(topo, m):
    jg, tg = grids(topo)
    rhs = mean_free_rhs(tg, 7)
    ref = np.asarray(JFourier.build(jg).solve(jnp.asarray(rhs), m=m))
    got = FourierTridiagonalSolver.build(tg).solve(torch.as_tensor(rhs), m=m).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_fourier_tridiagonal_poisson_residual(topo):
    _, tg = grids(topo)
    rhs = mean_free_rhs(tg, 8)
    phi = tg.pad(FourierTridiagonalSolver.build(tg).solve(torch.as_tensor(rhs)))
    phi = T.fill_halos(phi, tg, T.CENTER)
    lap = tg.interior(top.laplacian(phi, tg)).numpy()
    assert np.allclose(lap, rhs, atol=1e-8)


@pytest.mark.parametrize("pin,m", [(True, 0.0), (False, -1.0)])
@pytest.mark.parametrize("complex_rhs", [True, False])
def test_fourier_modes_wrapper_is_its_reference(complex_rhs, pin, m):
    rng = np.random.default_rng(9)
    nx, ny, nz = 5, 4, 7
    r = lambda *s: torch.as_tensor(rng.standard_normal(s))
    b = torch.complex(r(nx, ny, nz), r(nx, ny, nz)) if complex_rhs else r(nx, ny, nz)
    args = (r(nx).abs(), r(ny).abs(), m, r(nz).abs(), r(nz).abs(),
            r(nz).abs() + 0.1, b, pin)
    got = ttri.fourier_tridiagonal(*args)
    assert torch.equal(got, ttri.fourier_tridiagonal_reference(*args))
    if pin:  # the pinned row of mode (0, 0) is φ = 0
        assert got[0, 0, 0] == 0


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_t1_is_bitwise_its_plain_version(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for shape, complex_rhs in (((67, 45, 29), False), ((33, 17, 40), True)):
        a, b, c, d = (torch.as_tensor(x, device="cuda") for x in
                      bands(rng, shape, KINDS[kind], complex_rhs))
        a, b, c = (x.to(dtype) for x in (a, b, c))
        d = d.to(torch.complex64 if dtype == torch.float32 else torch.complex128) \
            if complex_rhs else d.to(dtype)
        n = ttri.solve_batched_tridiagonal.launches
        got = ttri.solve_batched_tridiagonal(a, b, c, d)
        torch.cuda.synchronize()
        assert ttri.solve_batched_tridiagonal.launches == n + 1
        assert torch.equal(got, ttri.solve_batched_tridiagonal_reference(a, b, c, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_t1_fourier_mode_is_bitwise_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    nx, ny, nz = 67, 23, 29
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device="cuda")
    for pin, m in ((True, 0.0), (False, -1.0)):
        for b in (torch.complex(r(nx, ny, nz), r(nx, ny, nz)), r(nx, ny, nz)):
            args = (r(nx).abs(), r(ny).abs(), m, r(nz).abs(), r(nz).abs(),
                    r(nz).abs() + 0.1, b, pin)
            got = ttri.fourier_tridiagonal(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ttri.fourier_tridiagonal_reference(*args))
