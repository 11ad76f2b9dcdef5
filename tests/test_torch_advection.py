"""Port parity: advective transport and flux divergences.

``transport`` and ``div_vu/vv/vw/Uc`` with ``WENO5`` and
``CenteredSecondOrder`` on a 16×12×10 (Periodic, Periodic, Bounded) f64
grid, on the same numpy-seeded fields, against the JAX package's plain
functions. Tolerance: max|Δ| ≤ 1e-12·max|ref|. The expression trees are
the same, but XLA's CPU backend may fuse and contract where eager
PyTorch does not (a WENO5 smoothness indicator differed by up to 3e-14
between the two), so parity is a stated tolerance, not bitwise. The
near-wall levels, where WENO5 drops to 2nd order, are checked on their
own as well as within the whole array.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.advection import fluxes as tfl
from clima_oceananigans_jl_torch.advection import schemes as tsc
from clima_oceananigans_jl_torch.boundary_conditions.bcs import fill_halos
from clima_oceananigans_jl_tpu.advection import fluxes as jfl
from clima_oceananigans_jl_tpu.advection import schemes as jsc

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-12
SIZE = (16, 12, 10)
SCHEMES = {"weno5": (J.WENO5(), T.WENO5()),
           "centered2": (J.CenteredSecondOrder(), T.CenteredSecondOrder())}


def setup(seed=0):
    jg = J.RectilinearGrid(size=SIZE, extent=(1.0, 0.75, 0.5),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=SIZE, extent=(1.0, 0.75, 0.5),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=torch.float64, device=DEVICE)
    rng = np.random.default_rng(seed)
    fields = {}
    for name, loc in (("u", T.U_LOC), ("v", T.V_LOC), ("w", T.W_LOC),
                      ("c", T.CENTER)):
        data = torch.from_numpy(rng.standard_normal(tg.total_shape))
        fields[name] = fill_halos(data, tg, loc).numpy()
    return jg, tg, fields


def close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = np.abs(ref).max()
    err = np.abs(ref - got).max()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("to_f", [True, False])
def test_transport_matches(scheme, axis, to_f):
    js, ts = SCHEMES[scheme]
    jg, tg, f = setup()
    ref = jsc.transport(js, jnp.asarray(f["u"]), jnp.asarray(f["c"]), axis,
                        to_f, jg)
    got = tsc.transport(ts, torch.from_numpy(f["u"]), torch.from_numpy(f["c"]),
                        axis, to_f, tg)
    close(ref, got)
    if axis == 2:  # the wall levels, where WENO5 reduces to 2nd order
        h, n = tg.Hz, tg.Nz
        for k in (h, h + 1, h + 2, h + 3, h + n - 3, h + n - 2, h + n - 1, h + n):
            close(np.asarray(ref)[:, :, k], got[:, :, k])


def test_reduced_order_masks_match():
    jg, tg, _ = setup()
    for axis in range(3):
        assert (jsc.reduced_order_masks(jg, axis, J.WENO5())
                == tsc.reduced_order_masks(tg, axis, T.WENO5()))
    assert tsc.reduced_order_masks(tg, 2, T.CenteredSecondOrder()) is None


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("div", ["div_vu", "div_vv", "div_vw", "div_Uc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flux_divergence_matches(scheme, div, seed):
    js, ts = SCHEMES[scheme]
    jg, tg, f = setup(seed)
    args = ["u", "v", "w"] + (["c"] if div == "div_Uc" else [])
    ref = getattr(jfl, div)(jg, js, *[jnp.asarray(f[a]) for a in args])
    got = getattr(tfl, div)(tg, ts, *[torch.from_numpy(f[a]) for a in args])
    ref_i = np.asarray(jg.interior(ref))
    got_i = tg.interior(got)
    close(ref_i, got_i)
    for k in (0, 1, 2, SIZE[2] - 3, SIZE[2] - 2, SIZE[2] - 1):  # wall levels
        close(ref_i[:, :, k], got_i[:, :, k])


def test_weno5_stream_reconstruct_matches():
    """The select-first WENO5 reconstruction on raw 5-point streams, with
    both signs and the smooth and discontinuous cases."""
    rng = np.random.default_rng(2)
    a = [rng.standard_normal(4096) for _ in range(5)]
    a[2][:100] += 10.0  # jumps: the nonlinear weights switch stencils
    ref = J.WENO5().stream_reconstruct(tuple(jnp.asarray(x) for x in a))
    got = T.WENO5().stream_reconstruct(tuple(torch.from_numpy(x) for x in a))
    close(ref, got)


def test_weno5_stream_reconstruct_smooth_matches():
    """The mean-smoothness WENO5 reconstruction of the vector-invariant
    "weno_velocity" scheme, bitwise."""
    rng = np.random.default_rng(3)
    a, s1, s2 = ([rng.standard_normal(4096) for _ in range(5)] for _ in range(3))
    a[2][:100] += 10.0
    ref = J.WENO5().stream_reconstruct_smooth(
        tuple(jnp.asarray(x) for x in a),
        [tuple(jnp.asarray(x) for x in s) for s in (s1, s2)])
    got = T.WENO5().stream_reconstruct_smooth(
        tuple(torch.from_numpy(x) for x in a),
        [tuple(torch.from_numpy(x) for x in s) for s in (s1, s2)])
    assert np.array_equal(np.asarray(ref), got.numpy())


class _NoScalarDivision(torch.Tensor):
    """A tensor that refuses division by a Python number."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if (func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.div)
                and isinstance(args[1], (int, float))):
            raise AssertionError(f"division by the Python scalar {args[1]}")
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("smooth", [False, True], ids=["own", "velocity"])
def test_weno5_divides_by_no_python_scalar(smooth):
    """PyTorch's CUDA kernels turn a Python scalar divisor into a multiply
    by its reciprocal, so the plain reconstruction would round differently
    on the card from the JAX package's and the kernels' IEEE division: on
    the 16384² shallow-water path that difference grew to 1.5e-2 of
    max|vh| between the kernel and plain runs. Every divisor is a tensor."""
    rng = np.random.default_rng(4)
    stream = lambda: tuple(torch.from_numpy(rng.standard_normal(64))
                           .as_subclass(_NoScalarDivision) for _ in range(5))
    with pytest.raises(AssertionError, match="Python scalar"):
        stream()[0] / 6.0
    w = T.WENO5()
    out = (w.stream_reconstruct_smooth(stream(), [stream(), stream()])
           if smooth else w.stream_reconstruct(stream()))
    assert out.shape == (64,)
