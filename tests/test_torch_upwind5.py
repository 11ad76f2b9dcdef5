"""Port parity: ``UpwindBiasedFifthOrder`` (UB5).

UB5 has no stream form, so ``transport`` takes the JAX package's
two-sided route: ``left_to_f``/``right_to_f`` (to centres, those forms
shifted by one), each side's near-wall fallback on a bounded axis, and the
upwind product ((u + |u|) L + (u − |u|) R)/2. Its / 60 divides by a tensor
(a Python scalar divisor becomes a multiply by the reciprocal in
PyTorch's CUDA kernels). Held against the JAX package in float64:

- ``transport`` on every axis, to faces and to centres, periodic and
  bounded, bit for bit (every point of the with-halo result);
- the three configurations of the examples that run UB5
  (``two_dimensional_turbulence``, ``kelvin_helmholtz_instability``,
  ``tilted_bottom_boundary_layer``; ``test_torch_flat_bounded.py``'s
  ``CONFIGS``) over 10 RK3 steps and 10 quasi-AB2 steps on both of the
  port's branches, within 1e-9 of max|field|;
- the hydrostatic model and K4's gate take UB5 (K4b's ANY form); K3a
  takes it (its code, and on the card
  a step against the plain one).

The ``cuda`` cases hold K2 and K1 with UB5 against their plain versions
on the card bit for bit (``python -m pytest --noconftest -m cuda
tests/test_torch_upwind5.py``).
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import schemes as tsch
from clima_oceananigans_jl_torch.ops import fused_tendencies as tft
from test_torch_flat_bounded import (UB5_CONFIGS, card_fields, check_configuration,
                                     grid_pair, hold_k2, needs_card)

try:  # the cuda cases also run on a machine without JAX
    import jax.numpy as jnp

    import clima_oceananigans_jl_tpu as J
    from clima_oceananigans_jl_tpu.advection import schemes as jsch
except ImportError:
    pass

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"


@pytest.mark.parametrize("to_f", [True, False], ids=["to_faces", "to_centres"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("code", ["PPP", "BBB"])
def test_transport_matches_jax_bitwise(code, axis, to_f):
    jg, tg = grid_pair(code, (11, 10, 9))
    rng = np.random.default_rng(axis)
    vel, c = rng.standard_normal((2,) + tg.total_shape)
    ref = jsch.transport(J.UpwindBiasedFifthOrder(), jnp.asarray(vel), jnp.asarray(c),
                         axis, to_f, jg)
    got = tsch.transport(T.UpwindBiasedFifthOrder(), torch.as_tensor(vel),
                         torch.as_tensor(c), axis, to_f, tg)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_reconstructions_match_jax_bitwise():
    """left_to_f, right_to_f and their to-centres shifts, alone."""
    c = np.random.default_rng(7).standard_normal((12, 11, 10))
    js, ts = J.UpwindBiasedFifthOrder(), T.UpwindBiasedFifthOrder()
    for name in ("left_to_f", "right_to_f", "left_to_c", "right_to_c"):
        for axis in range(3):
            ref = getattr(js, name)(jnp.asarray(c), axis)
            got = getattr(ts, name)(torch.as_tensor(c), axis)
            assert np.array_equal(np.asarray(ref), got.numpy()), (name, axis)


@pytest.mark.parametrize("branch", ["RK3", "AB2", "AB2 general"])
@pytest.mark.parametrize("config", UB5_CONFIGS)
def test_configuration_matches_jax_over_ten_steps(config, branch):
    check_configuration(config, branch)


def test_kernel_scheme_code():
    """K1's, K2's and K3a's code for UB5; K3a takes it too."""
    assert tft.kernel_scheme(T.UpwindBiasedFifthOrder()) == (2, 0.0)
    _, tg = grid_pair("PPF", (8, 8, 1))
    args = tft.shallow_water_args(tg, T.UpwindBiasedFifthOrder(), T.WENO5(), 3, 9.8)
    assert args[5:7] == (2, 1)


def test_hydrostatic_model_refuses_ub5_by_name():
    """The hydrostatic model and K4's gate take UB5 as flux-form momentum
    and as the tracer scheme, on a Flat y too (K4's Flat layouts; it was
    refused by name before them)."""
    from clima_oceananigans_jl_torch.ops import fused_hydrostatic as tfh
    g = T.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1), dtype=torch.float64,
                          device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(g, momentum_advection=T.UpwindBiasedFifthOrder(),
                                      tracer_advection=T.UpwindBiasedFifthOrder(),
                                      tracers=("b",))
    assert m.grid.halo == (3, 3, 3) and tfh.unsupported_reason(m) is None
    flat_y = T.RectilinearGrid(size=(8, 1, 4), extent=(1, 1, 1), dtype=torch.float64,
                               topology=(T.PERIODIC, T.FLAT, T.BOUNDED), device=DEVICE)
    m = T.HydrostaticFreeSurfaceModel(flat_y, tracer_advection=T.UpwindBiasedFifthOrder(),
                                      tracers=("b",), free_surface=T.ExplicitFreeSurface())
    assert m.grid.halo == (3, 0, 3) and tfh.unsupported_reason(m) is None


# -- on the card ---------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_shallow_water_takes_ub5():
    """K3a takes UB5 on the card: a step with the kernel equals one with
    its plain version."""
    needs_card()
    from clima_oceananigans_jl_torch.models import shallow_water as tsw
    g = T.RectilinearGrid(size=(40, 36, 1), extent=(1, 1),
                          topology=(T.PERIODIC, T.PERIODIC, T.FLAT), device="cuda")
    m = T.ShallowWaterModel(g, advection=T.UpwindBiasedFifthOrder())
    s = m.initial_state(uh=lambda x, y, z: 0.1 * torch.sin(6.3 * x), h=1.0)
    a, b = m.step(s, 1e-3), m.step(s, 1e-3, kernels=tsw.PLAIN)
    for name in a["solution"]:
        assert torch.equal(a["solution"][name], b["solution"][name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("tracer_scheme", ["UpwindBiasedFifthOrder", "WENO5",
                                           "CenteredSecondOrder"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_k2_with_ub5_momentum_matches_plain_version(dtype, tracer_scheme):
    """Periodic and bounded axes, sizes off the tiles, two tracers."""
    needs_card()
    for code, size in (("PPB", (20, 13, 40)), ("BBP", (17, 25, 33))):
        _, tg = grid_pair(code, size, dtype=dtype, device="cuda")
        hold_k2(tg, T.UpwindBiasedFifthOrder(), getattr(T, tracer_scheme)(),
                card_fields(tg, 5))
