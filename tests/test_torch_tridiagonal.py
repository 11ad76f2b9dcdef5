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
  ``tests/test_poisson_solvers.py:42`` checks the JAX one (1e-8);
- the ``out=`` interface of the plain route: views of with-halo fields
  (w's ``Hz+1 : Hz+Nz`` levels too) solved into a view of another
  with-halo field, bit for bit the contiguous route, its halos untouched;
  the wrapper's checks of strides, overlaps and broadcast bands;
- a numpy mirror of T1's launch plan (the table, column or Fourier mode;
  one chunk at nz <= KC, several above, by type and values per point;
  shared memory within a block's budget) at the
  constants parsed from ``csrc/batched_tridiagonal.cu``.

The ``cuda`` cases hold T1 on the card against its plain version, bit for
bit over NaN-filled outputs, each call one launch: every form (1D, 3D and
mixed bands, real and complex, fp32 and fp64, the Fourier mode with and
without the pin) at edge shapes (nz at and around each chunk length,
column counts off the tiles and the blocks, warps that walk several
tiles, 1D bands too long for the table), and strided views whose halos
keep their poison; and the launcher's plan against the mirror
(``python -m pytest --noconftest -m cuda tests/test_torch_tridiagonal.py``).
"""
import re
from pathlib import Path

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


# -- the out= interface and the wrapper's checks -----------------------------------

def with_halo(rng, shape, h, complex_rhs=False):
    """A with-halo field (nx, ny, nz + 2h) of random values."""
    big = (shape[0], shape[1], shape[2] + 2 * h)
    x = torch.as_tensor(rng.standard_normal(big))
    return torch.complex(x, torch.as_tensor(rng.standard_normal(big))) if complex_rhs else x


@pytest.mark.parametrize("levels", ["centred", "w"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("complex_rhs", [False, True])
def test_plain_solve_into_a_view_is_the_contiguous_route(complex_rhs, kind, levels):
    """d a view of a with-halo field's interior levels (w's ``Hz+1 : Hz+Nz``
    ones too), 3D bands views of another with-halo array, solved into a view
    of a third: bit for bit the solve of contiguous copies, every point of
    ``out`` outside the view untouched."""
    rng = np.random.default_rng(11)
    h, nz = 3, 9
    k0, k1 = (h, h + nz) if levels == "centred" else (h + 1, h + nz)
    n = k1 - k0
    data = with_halo(rng, (5, 4, nz), h, complex_rhs)
    a, b, c, _ = (torch.as_tensor(x) for x in bands(rng, (5, 4, nz + 2 * h), KINDS[kind]))
    a, b, c = (x[..., k0:k1] if x.ndim == 3 else x[k0:k1].contiguous() for x in (a, b, c))
    out = with_halo(rng, (5, 4, nz), h, complex_rhs)
    before = out.clone()
    view = out[:, :, k0:k1]
    got = ttri.solve_batched_tridiagonal(a, b, c, data[:, :, k0:k1], out=view)
    assert got is view
    ref = ttri.solve_batched_tridiagonal_reference(
        *(x.contiguous() for x in (a, b, c, data[:, :, k0:k1])))
    assert view.shape[2] == n and torch.equal(view, ref)
    assert torch.equal(out[:, :, :k0], before[:, :, :k0])
    assert torch.equal(out[:, :, k1:], before[:, :, k1:])


def test_plain_solve_in_place_over_d():
    rng = np.random.default_rng(12)
    a, b, c, d = (torch.as_tensor(x) for x in bands(rng, (4, 3, 8), KINDS["mixed"]))
    ref = ttri.solve_batched_tridiagonal_reference(a, b, c, d)
    assert torch.equal(ttri.solve_batched_tridiagonal(a, b, c, d, out=d), ref)
    assert torch.equal(d, ref)


def test_wrapper_checks_views_and_bands():
    """What T1's wrapper passes to the kernel: (x, y) strides in elements of
    the real type (an axis of one point 0), a 3D band broadcast from one
    column passed as 1D; and what it refuses: z not contiguous, columns of
    ``out`` that overlap, ``out`` over part of d."""
    big = torch.zeros((4, 5, 12), dtype=torch.complex128)
    view = big[:, :, 3:9]
    assert ttri._column_strides("d", view, (4, 5, 6), 2) == [120, 24]
    assert ttri._column_strides("d", big[:1, :, 3:9], (1, 5, 6), 2) == [0, 24]
    nv, real, sd, so = ttri._check_rhs(view, torch.empty((4, 5, 6), dtype=torch.complex128))
    assert (nv, real, sd, so) == (2, torch.float64, [120, 24], [60, 12])
    col = torch.arange(6.0, dtype=torch.float64)
    assert ttri._check_band("a", col, torch.float64, col.device, (4, 5, 6)) == (0, [0, 0])
    assert ttri._check_band("a", col.expand(4, 5, 6), torch.float64, col.device,
                            (4, 5, 6)) == (0, [0, 0])
    full = torch.zeros((4, 5, 12), dtype=torch.float64)[:, :, 3:9]
    assert ttri._check_band("a", full, torch.float64, col.device, (4, 5, 6)) == (1, [60, 12])
    d = torch.zeros((4, 5, 6))
    with pytest.raises(ValueError, match="z contiguous"):
        ttri._check_rhs(torch.zeros((4, 6, 5)).transpose(1, 2), torch.empty_like(d))
    with pytest.raises(ValueError, match="must not overlap"):
        ttri._check_rhs(d, torch.zeros((4, 6)).unsqueeze(1).expand(4, 5, 6))
    other = torch.zeros((4, 5, 7))
    assert ttri._check_rhs(other[:, :, :6], other[:, :, :6])[2] == [35, 7]
    with pytest.raises(ValueError, match="in place only"):
        ttri._check_rhs(other[:, :, :6], other[:, :, 1:])
    with pytest.raises(ValueError, match="contiguous 1D"):
        ttri._check_band("b", torch.zeros(12, dtype=torch.float64)[::2], torch.float64, col.device, (4, 5, 6))
    with pytest.raises(ValueError, match="1D band of 6 levels"):
        ttri._check_band("c", torch.zeros((4, 6), dtype=torch.float64), torch.float64, col.device, (4, 5, 6))


# -- T1's launch plan, mirrored in numpy ----------------------------------------------

SOURCE = Path(ttri.__file__).parent.parent / "csrc" / "batched_tridiagonal.cu"
#: a block's shared memory on an H100 (227 KB, by opt-in)
SMEM_LIMIT = 232448


def source_constants():
    """T1's compile-time constants, parsed from its source."""
    found = dict(re.findall(r"constexpr int (T1_[A-Z_]+) = (\d+);", SOURCE.read_text()))
    return {k: int(v) for k, v in found.items()}


def plan_mirror(nz, nv, size, any3d, fourier, K=None):
    """The launcher's ``t1_plan``: (mode: 0 the 1D bands' table, 1 a
    column's own cp, 2 Fourier; levels a chunk; dynamic shared memory a
    block)."""
    K = K or source_constants()
    kc = K["T1_ROW_BYTES"] // (size * nv)
    table_fits = 2 * nz * size <= K["T1_TABLE_BYTES"]
    mode = 2 if fourier else 1 if any3d or not table_fits else 0
    nb = (0, 3, 1)[mode]
    stage = 32 * (kc * nv + 1) + nb * 32 * (kc + 1) + 3 * kc
    table = 2 * nz if mode == 0 else 0
    return mode, kc, K["T1_WARPS"] * (table + K["T1_STAGES"] * stage) * size


def chunk_schedule(nz, kc):
    """The copies of one tile, in order: ("in" | "out", what, first level,
    levels), as the kernel's forward and back sweeps make them."""
    nch = -(-nz // kc)
    levels = lambda ch: min(kc, nz - ch * kc)
    ops = []
    for ch in range(nch):
        ops.append(("in", "d", ch * kc, levels(ch)))
        if ch + 1 < nch:
            ops.append(("out", "dp", ch * kc, levels(ch)))
    for ch in range(nch - 1, -1, -1):
        if ch < nch - 1:
            ops.append(("in", "dp", ch * kc, levels(ch)))
        ops.append(("out", "phi", ch * kc, levels(ch)))
    return ops


PLAN_NZ = [1, 2, 7, 8, 9, 15, 16, 17, 23, 24, 29, 31, 32, 33, 64, 65, 255, 256,
           257, 511, 512, 513, 1000, 1023, 1024, 1025, 4096]
PLAN_TYPES = [(4, 1), (4, 2), (8, 1), (8, 2)]


def test_plan_constants_in_the_source():
    K = source_constants()
    assert set(K) >= {"T1_ROW_BYTES", "T1_WARPS", "T1_STAGES", "T1_TABLE_BYTES"}
    assert K["T1_STAGES"] >= 2 and K["T1_WARPS"] >= 1
    assert f"__launch_bounds__(T1_WARPS * 32)" in SOURCE.read_text()


@pytest.mark.parametrize("size,nv", PLAN_TYPES)
def test_plan_mirror_chunks_and_shared_memory(size, nv):
    """At the source's constants: a chunk is one 128-byte run of d a
    column, its tile rows are an odd number of elements apart (the lanes'
    rows fall in different banks), the table (denom and cp) only for 1D
    bands whose two rows fit the warp's budget, and every plan's shared
    memory fits a block with T1_WARPS warps."""
    K = source_constants()
    for nz in PLAN_NZ:
        for any3d, fourier in ((False, False), (True, False), (False, True)):
            mode, kc, smem = plan_mirror(nz, nv, size, any3d, fourier, K=K)
            assert kc * size * nv == K["T1_ROW_BYTES"]
            assert (kc * nv + 1) % 2 == 1 and (kc + 1) % 2 == 1
            assert mode == (2 if fourier else 1 if any3d or 2 * nz * size > K["T1_TABLE_BYTES"]
                            else 0)
            assert 0 < smem <= SMEM_LIMIT, (nz, size, nv, mode, smem)
            if mode == 0:
                assert smem == plan_mirror(1, nv, size, False, False, K=K)[2] \
                    + K["T1_WARPS"] * 2 * (nz - 1) * size


@pytest.mark.parametrize("nz", [1, 2, 24, 29, 31, 32, 33, 63, 64, 65, 255, 256, 257])
@pytest.mark.parametrize("kc", [8, 16, 32])
def test_chunk_schedule_covers_each_level(nz, kc):
    """Each tile reads d and writes φ once at every level; dp leaves the SM
    and comes back only for the chunks before the last (a column of one
    chunk: never), each dp chunk read back after it was written."""
    ops = chunk_schedule(nz, kc)
    for what, op in (("d", "in"), ("phi", "out")):
        seen = np.zeros(nz, int)
        for o, w, k0, n in ops:
            if (o, w) == (op, what):
                seen[k0:k0 + n] += 1
        assert (seen == 1).all(), what
    out_dp = [(k0, n) for o, w, k0, n in ops if (o, w) == ("out", "dp")]
    in_dp = [(k0, n) for o, w, k0, n in ops if (o, w) == ("in", "dp")]
    assert sorted(out_dp) == sorted(in_dp)
    last = nz - (-(-nz // kc) - 1) * kc
    assert sum(n for _, n in out_dp) == nz - last
    assert (nz <= kc) == (not out_dp)
    for k0, n in in_dp:
        assert ops.index(("out", "dp", k0, n)) < ops.index(("in", "dp", k0, n))


# -- T1's forms at edge shapes, on the card -------------------------------------------

EDGE_NZ = [1, 2, 8, 9, 16, 17, 24, 29, 32, 33, 255, 256, 257]
REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def poisoned(like):
    """An uninitialised tensor like ``like`` with every value (both parts
    of a complex one) NaN."""
    out = torch.empty_like(like)
    (torch.view_as_real(out) if out.is_complex() else out).fill_(float("nan"))
    return out


def one_launch(call):
    n = ttri.solve_batched_tridiagonal.launches
    got = call()
    torch.cuda.synchronize()
    assert ttri.solve_batched_tridiagonal.launches == n + 1
    return got


def card_bands(rng, shape, kind, dtype, complex_rhs):
    a, b, c, d = (torch.as_tensor(x, device="cuda") for x in
                  bands(rng, shape, KINDS[kind], complex_rhs))
    a, b, c = (x.to(dtype) for x in (a, b, c))
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    return a, b, c, d.to(ctype if complex_rhs else dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_t1_edge_shapes_every_mode(kind, dtype, complex_rhs):
    """nz at and around every chunk length, 135 columns (off the 32 of a
    tile and the 128 of a block): bit for bit over NaN."""
    needs_card()
    rng = np.random.default_rng(13)
    for nz in EDGE_NZ:
        a, b, c, d = card_bands(rng, (5, 27, nz), kind, dtype, complex_rhs)
        got = one_launch(lambda: ttri.solve_batched_tridiagonal(a, b, c, d, out=poisoned(d)))
        assert torch.equal(got, ttri.solve_batched_tridiagonal_reference(a, b, c, d)), nz


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [24, 33])
@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_t1_warps_walk_several_tiles(dtype, complex_rhs, nz):
    """109,230 columns: more tiles than the card holds warps at once, so
    each warp walks several (the 1D table made in the first and read in the
    others); 1D and 3D bands."""
    needs_card()
    rng = np.random.default_rng(14)
    for kind in ("1d", "3d"):
        a, b, c, d = card_bands(rng, (331, 330, nz), kind, dtype, complex_rhs)
        got = one_launch(lambda: ttri.solve_batched_tridiagonal(a, b, c, d))
        assert torch.equal(got, ttri.solve_batched_tridiagonal_reference(a, b, c, d))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", ["centred", "w"])
@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_t1_strided_views_keep_the_halos(dtype, complex_rhs, levels):
    """d, the 3D bands and out views of with-halo fields (the interior
    levels, or w's ``Hz+1 : Hz+Nz``): bit for bit the plain version, every
    halo point of out still NaN."""
    needs_card()
    rng = np.random.default_rng(15)
    h = 3
    for nz in (24, 29, 33, 256):
        k0, k1 = (h, h + nz) if levels == "centred" else (h + 1, h + nz)
        big = (37, 29, nz + 2 * h)
        for kind in ("1d", "3d", "mixed"):
            a, b, c, data = card_bands(rng, big, kind, dtype, complex_rhs)
            a, b, c = (x[..., k0:k1] if x.ndim == 3 else x[k0:k1].contiguous()
                       for x in (a, b, c))
            d = data[:, :, k0:k1]
            out = poisoned(data)
            for _ in range(2):  # the second call over the first's output
                one_launch(lambda: ttri.solve_batched_tridiagonal(a, b, c, d, out=out[:, :, k0:k1]))
                assert torch.equal(out[:, :, k0:k1],
                                   ttri.solve_batched_tridiagonal_reference(a, b, c, d))
                rest = torch.cat([out[:, :, :k0], out[:, :, k1:]], 2)
                assert (torch.view_as_real(rest) if rest.is_complex() else rest).isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_t1_fourier_mode_edge_shapes(dtype, complex_rhs):
    """The Fourier mode with and without the pin at every edge nz, 67 × 23
    modes."""
    needs_card()
    rng = np.random.default_rng(16)
    nx, ny = 67, 23
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device="cuda")
    for nz in EDGE_NZ:
        b = torch.complex(r(nx, ny, nz), r(nx, ny, nz)) if complex_rhs else r(nx, ny, nz)
        for pin, m in ((True, 0.0), (False, -1.0)):
            args = (r(nx).abs(), r(ny).abs(), m, r(nz).abs(), r(nz).abs(),
                    r(nz).abs() + 0.1, b, pin)
            got = one_launch(lambda: ttri.fourier_tridiagonal(*args))
            assert torch.equal(got, ttri.fourier_tridiagonal_reference(*args)), (nz, pin)


@pytest.mark.cuda
@pytest.mark.parametrize("size,nv", PLAN_TYPES)
def test_cuda_t1_plan_is_its_mirror(size, nv):
    """The launcher's own plan (``batched_tridiagonal_plan``) against the
    numpy mirror."""
    needs_card()
    dtype = torch.float32 if size == 4 else torch.float64
    for nz in PLAN_NZ:
        for any3d, fourier in ((False, False), (True, False), (False, True)):
            assert ttri.plan(nz, nv, dtype, any3d, fourier) == \
                plan_mirror(nz, nv, size, any3d, fourier)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_t1_1d_bands_past_the_table(dtype, complex_rhs):
    """Three 1D bands whose table does not fit a warp's budget take the
    column mode (its cp through the scratch array): bit for bit over NaN."""
    needs_card()
    rng = np.random.default_rng(17)
    size = torch.finfo(dtype).bits // 8
    nz = source_constants()["T1_TABLE_BYTES"] // (2 * size) + 1
    nv = 2 if complex_rhs else 1
    assert ttri.plan(nz, nv, dtype)[0] == 1
    a, b, c, d = card_bands(rng, (7, 19, nz), "1d", dtype, complex_rhs)
    got = one_launch(lambda: ttri.solve_batched_tridiagonal(a, b, c, d, out=poisoned(d)))
    assert torch.equal(got, ttri.solve_batched_tridiagonal_reference(a, b, c, d))
