"""Port parity: flux boundary conditions with values (``apply_flux_bcs``).

Every form of a flux value — a scalar, a boundary-plane array on the
interior points, a callable of the boundary nodes and t, and the discrete
form ``value(grid, t, fields)`` returning a full-shape array — on each
side of each bounded axis, for a field at each location, on a regular
(Bounded, Bounded, Bounded) grid, on the same grid with stretched z faces
and on a (8, 8, 4) lat-lon grid (periodic longitude, so its bounded axes
are latitude and z). The same random tendency goes through the JAX
package's ``apply_flux_bcs`` and the port's, in f64 on the CPU, and must
come back bitwise: the contribution is q·A/V at the boundary cell, its
sign, then one add, in both packages' order. (On the lat-lon grid a halo
column past the last latitude face has zero volume, so both packages put
the same NaN there; NaNs compare equal.)

The callable values and the discrete forms are written twice, once with
``jnp`` for the JAX package and once with ``torch`` for the port, with
the same arithmetic (no transcendental functions, so both round alike).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid as JLL

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"
LOCS = {"ccc": ("c", "c", "c"), "fcc": ("f", "c", "c"),
        "cfc": ("c", "f", "c"), "ccf": ("c", "c", "f")}
SIDES = ("west", "east", "south", "north", "bottom", "top")
FORMS = ("scalar", "plane", "callable", "discrete")


def stretched_faces(n):
    k = np.arange(n + 1)
    return -50.0 * (1.0 - k / n) ** 1.5


def grids(kind):
    """The same grid in both packages (JAX, port)."""
    if kind == "latlon":
        kw = dict(size=(8, 8, 4), longitude=(0, 360), latitude=(-60, 60),
                  z=stretched_faces(4))
        return (JLL(dtype=jnp.float64, **kw),
                T.LatitudeLongitudeGrid(dtype=torch.float64, device=DEVICE, **kw))
    z = stretched_faces(5) if kind == "stretched" else (-50.0, 0.0)
    kw = dict(size=(6, 7, 5), x=(0.0, 60.0), y=(0.0, 35.0), z=z)
    return (J.RectilinearGrid(topology=("bounded",) * 3, dtype=jnp.float64, **kw),
            T.RectilinearGrid(topology=(T.BOUNDED,) * 3, dtype=torch.float64,
                              device=DEVICE, **kw))


def plane_shape(grid, axis):
    return tuple(n for a, n in enumerate(grid.shape) if a != axis)


def values(form, grid, axis, seed):
    """(JAX value, port value, discrete) of a flux BC of ``form``."""
    if form == "scalar":
        return 2.5e-3, 2.5e-3, False
    if form == "plane":
        q = 1e-3 * np.random.default_rng(seed).standard_normal(plane_shape(grid, axis))
        return q, q.copy(), False
    if form == "callable":
        # the same polynomial of the boundary nodes and t, once in jnp
        # and once in torch
        def jq(a, b, t):
            return 1e-4 * a - 3e-6 * b * b + 1e-3 * t + jnp.zeros_like(a * b)

        def tq(a, b, t):
            return 1e-4 * a - 3e-6 * b * b + 1e-3 * t + torch.zeros_like(a * b)
        return jq, tq, False
    # discrete: a field-dependent flux, once in jnp and once in torch
    return ((lambda grid, t, fields: -1e-3 * fields["c"] * jnp.abs(fields["c"])),
            (lambda grid, t, fields: -1e-3 * fields["c"] * torch.abs(fields["c"])),
            True)


CASES = [(kind, loc, side, form) for kind in ("regular", "stretched", "latlon")
         for loc in LOCS for side in SIDES for form in FORMS
         if not (kind == "latlon" and side in ("west", "east"))]


@pytest.mark.parametrize("kind,loc,side,form", CASES,
                         ids=["-".join(c) for c in CASES])
def test_apply_flux_bcs_matches_jax_bitwise(kind, loc, side, form):
    jg, tg = grids(kind)
    axis = SIDES.index(side) // 2
    jv, tv, discrete = values(form, tg, axis, seed=SIDES.index(side))
    jloc = tuple(J.C if c == "c" else J.F for c in LOCS[loc])
    tloc = tuple(T.C if c == "c" else T.F for c in LOCS[loc])
    jb = jbcs.regularize_bcs(jg, jloc, jbcs.FieldBCs(
        **{side: jbcs.FluxBC(jv, discrete=discrete)}))
    tb = tbcs.regularize_bcs(tg, tloc, tbcs.FieldBCs(
        **{side: tbcs.FluxBC(tv, discrete=discrete)}))
    rng = np.random.default_rng(7)
    G = rng.standard_normal(tg.total_shape)
    c = rng.standard_normal(tg.total_shape)
    t = 30.0
    ref = jbcs.apply_flux_bcs(jnp.asarray(G), jg, jloc, jb, t,
                              {"c": jnp.asarray(c)})
    Gt = torch.as_tensor(G.copy())
    got = tbcs.apply_flux_bcs(Gt, tg, tloc, tb, t, {"c": torch.as_tensor(c)})
    assert np.array_equal(np.asarray(ref), got.numpy(), equal_nan=True)
    # the input is left as it was, and a boundary cell changed
    assert np.array_equal(Gt.numpy(), G)
    assert not np.array_equal(got.numpy(), G)


@pytest.mark.parametrize("kind", ["regular", "latlon"])
def test_several_flux_values_on_one_field_match_jax_bitwise(kind):
    """A scalar on one side, a plane on another and a callable on a third
    of the same field, and a value-less flux BC (adds nothing)."""
    jg, tg = grids(kind)
    names = (("south", "scalar"), ("north", "plane"), ("bottom", "callable"),
             ("top", None))
    jkw, tkw = {}, {}
    for side, form in names:
        if form is None:
            jkw[side], tkw[side] = jbcs.FluxBC(), tbcs.FluxBC()
            continue
        jv, tv, _ = values(form, tg, SIDES.index(side) // 2, 3)
        jkw[side], tkw[side] = jbcs.FluxBC(jv), tbcs.FluxBC(tv)
    G = np.random.default_rng(8).standard_normal(tg.total_shape)
    ref = jbcs.apply_flux_bcs(jnp.asarray(G), jg, J.CENTER,
                              jbcs.regularize_bcs(jg, J.CENTER, jbcs.FieldBCs(**jkw)),
                              5.0)
    got = tbcs.apply_flux_bcs(torch.as_tensor(G), tg, T.CENTER,
                              tbcs.regularize_bcs(tg, T.CENTER, tbcs.FieldBCs(**tkw)),
                              5.0)
    assert np.array_equal(np.asarray(ref), got.numpy(), equal_nan=True)


def test_flux_bc_keeps_the_discrete_keyword():
    bc = T.FluxBC(lambda grid, t, fields: fields["c"], discrete=True)
    assert bc.kind == "flux" and bc.discrete
    assert not T.FluxBC(1.0).discrete and T.FluxBC().value is None
    assert tbcs.BC("flux", 1.0, True) == tbcs.BC("flux", 1.0, discrete=True)


def test_periodic_and_valueless_sides_add_nothing():
    _, tg = grids("regular")
    G = torch.as_tensor(np.random.default_rng(9).standard_normal(tg.total_shape))
    bcs = tbcs.regularize_bcs(tg, T.CENTER, None)
    assert tbcs.apply_flux_bcs(G, tg, T.CENTER, bcs) is G
    assert tbcs.apply_flux_bcs(G, tg, T.CENTER, None) is G
