"""Port parity: operators, Coriolis terms and scalar diffusion.

``ops/operators.py``, ``coriolis/coriolis.py`` (FPlane, BetaPlane) and
``closures/scalar_diffusivity.py`` (``div_kappa_grad`` and the closure
front ends) against the JAX package's functions of the same names, on
the same numpy-seeded with-halo arrays of a 12×10×8 grid in f64 (a
non-cubic grid, so a swapped axis cannot pass), at every location.
Tolerance: max|Δ| ≤ 1e-12·max|ref| over the interior, because XLA's CPU
backend may fuse and contract where eager PyTorch does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.closures import scalar_diffusivity as tsd
from clima_oceananigans_jl_torch.ops import operators as top
from clima_oceananigans_jl_tpu.closures import scalar_diffusivity as jsd
from clima_oceananigans_jl_tpu.coriolis import coriolis as jcor
from clima_oceananigans_jl_tpu.ops import operators as jop
from clima_oceananigans_jl_tpu.utils import location as jloc

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

RTOL = 1e-12
SIZE = (12, 10, 8)
LOCS = {"C": T.CENTER, "U": T.U_LOC, "V": T.V_LOC, "W": T.W_LOC}


def jloc_of(loc):
    return tuple(jloc.C if l == T.C else jloc.F for l in loc)


def grids(topology=("periodic", "periodic", "bounded")):
    jg = J.RectilinearGrid(size=SIZE, x=(0.0, 1.0), y=(-0.5, 1.5), z=(-1.0, 0.0),
                           topology=topology, halo=(3, 3, 3), dtype=jnp.float64)
    tg = T.RectilinearGrid(size=SIZE, x=(0.0, 1.0), y=(-0.5, 1.5), z=(-1.0, 0.0),
                           topology=topology, halo=(3, 3, 3), dtype=torch.float64,
                           device=DEVICE)
    return jg, tg


def field(tg, seed):
    return np.random.default_rng(seed).standard_normal(tg.total_shape)


def close(tg, ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    ref = np.broadcast_to(ref, tg.total_shape)[tg.interior_slices]
    got = np.broadcast_to(got, tg.total_shape)[tg.interior_slices]
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_delta_interp_dd_match(loc, axis):
    jg, tg = grids()
    a = field(tg, 1)
    t = torch.as_tensor(a)
    l = LOCS[loc]
    assert top.flip_loc(l, axis) == tuple(
        T.C if x is jloc.C else T.F for x in jop.flip_loc(jloc_of(l), axis))
    close(tg, jop.delta(jnp.asarray(a), axis, jloc_of(l)),
          top.delta(t, axis, l), "delta")
    close(tg, jop.interp(jnp.asarray(a), axis, jloc_of(l)),
          top.interp(t, axis, l), "interp")
    close(tg, jop.dd(jnp.asarray(a), jg, axis, jloc_of(l)),
          top.dd(t, tg, axis, l), "dd")


@pytest.mark.parametrize("src,dst", [("C", "U"), ("U", "V"), ("W", "C"),
                                     ("V", "W")])
def test_interp_to_matches(src, dst):
    jg, tg = grids()
    a = field(tg, 2)
    close(tg, jop.interp_to(jnp.asarray(a), jloc_of(LOCS[src]),
                            jloc_of(LOCS[dst])),
          top.interp_to(torch.as_tensor(a), LOCS[src], LOCS[dst]), "interp_to")


@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("axes", [(0, 1, 2), (0, 1)])
def test_div_ccc_and_laplacian_match(loc, axes):
    jg, tg = grids()
    u, v, w, c = (field(tg, s) for s in (3, 4, 5, 6))
    close(tg, jop.div_ccc(*map(jnp.asarray, (u, v, w)), jg),
          top.div_ccc(*map(torch.as_tensor, (u, v, w)), tg), "div_ccc")
    l = LOCS[loc]
    close(tg, jop.laplacian(jnp.asarray(c), jg, jloc_of(l), axes=axes),
          top.laplacian(torch.as_tensor(c), tg, l, axes=axes), "laplacian")


@pytest.mark.parametrize("kind", ["fplane", "betaplane"])
def test_coriolis_terms_match(kind):
    jg, tg = grids()
    if kind == "fplane":
        jc, tc = jcor.FPlane(f=1.3e-4), T.FPlane(f=1.3e-4)
    else:
        jc, tc = (jcor.BetaPlane(f0=1e-4, beta=2.5e-5),
                  T.BetaPlane(f0=1e-4, beta=2.5e-5))
    u, v, w = (field(tg, s) for s in (7, 8, 9))
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    tu, tv, tw = map(torch.as_tensor, (u, v, w))
    for term in ("x_f_cross_U", "y_f_cross_U", "z_f_cross_U"):
        ref = getattr(jc, term)(jg, ju, jv, jw)
        got = getattr(tc, term)(tg, tu, tv, tw)
        if term == "z_f_cross_U":
            assert not got.any() and not np.asarray(ref).any()
        else:
            close(tg, ref, got, term)


COEFFS = {
    "isotropic": dict(kappa=2e-3),
    "split": dict(kappa=2e-3, kappa_z=5e-4),
    "horizontal": dict(kappa=2e-3, kappa_z=0.0),
    "vertical": dict(kappa=0.0, kappa_z=5e-4),
}


@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("coeff", COEFFS)
def test_div_kappa_grad_matches(loc, coeff):
    jg, tg = grids()
    c = field(tg, 10)
    kw = COEFFS[coeff]
    l = LOCS[loc]
    for vertical in (True, False):
        close(tg, jsd.div_kappa_grad(jnp.asarray(c), jg, jloc_of(l),
                                     vertical=vertical, **kw),
              tsd.div_kappa_grad(torch.as_tensor(c), tg, l, vertical=vertical,
                                 **kw), coeff)


@pytest.mark.parametrize("which", ["scalar", "dict", "horizontal", "vertical"])
def test_closure_front_ends_match(which):
    jg, tg = grids()
    make = {
        "scalar": lambda m: m.ScalarDiffusivity(nu=1e-3, kappa=2e-3, nu_z=4e-4),
        "dict": lambda m: m.ScalarDiffusivity(nu=1e-3, kappa={"b": 2e-3,
                                                               "c": 3e-4}),
        "horizontal": lambda m: m.HorizontalScalarDiffusivity(nu=1e-3,
                                                              kappa=2e-3),
        "vertical": lambda m: m.VerticalScalarDiffusivity(nu=1e-3, kappa=2e-3),
    }[which]
    jc, tc = make(jsd), make(tsd)
    a = field(tg, 12)
    for loc in (T.U_LOC, T.V_LOC, T.W_LOC):
        close(tg, jsd.momentum_diffusion(jnp.asarray(a), jg, jloc_of(loc), jc),
              tsd.momentum_diffusion(torch.as_tensor(a), tg, loc, tc), "nu")
    for name in ("b", "c"):
        close(tg, jsd.tracer_diffusion(jnp.asarray(a), jg, name, jc),
              tsd.tracer_diffusion(torch.as_tensor(a), tg, name, tc), name)
    assert tsd.compute_closure_diffusivities(tc, tg, {}, None, {}) is None
    assert not tsd.tracer_diffusion(torch.as_tensor(a), tg, "b", None).any()


def test_unported_closures_raise():
    """A closure the port lacks (an object that is none of the JAX
    package's closures) is refused by the model at construction, naming
    its ROADMAP item, where CATKE, the other vertical-mixing closures and
    GM/Redi construct and add CATKE's ``e``; closure tuples sum their
    members' terms, and a closure without diffusivity fields gives None, as
    in the JAX package."""
    tg = grids()[1]
    with pytest.raises(NotImplementedError, match="item 7"):
        T.NonhydrostaticModel(tg, closure=object())
    for cl in (T.CATKEVerticalDiffusivity(), T.ConvectiveAdjustmentVerticalDiffusivity(),
               T.RiBasedVerticalDiffusivity(), T.IsopycnalSkewSymmetricDiffusivity()):
        m = T.NonhydrostaticModel(tg, closure=(T.ScalarDiffusivity(nu=1e-3), cl),
                                  buoyancy=T.BuoyancyTracer())
        assert m.tracer_names == (("b", "e") if isinstance(cl, T.CATKEVerticalDiffusivity)
                                  else ("b",))
    a = torch.as_tensor(field(tg, 13))
    one = tsd.ScalarDiffusivity(nu=1e-3, kappa=2e-3)
    assert torch.equal(tsd.tracer_diffusion(a, tg, "b", (one,)),
                       torch.zeros_like(a) + tsd.tracer_diffusion(a, tg, "b", one))
    assert tsd.compute_closure_diffusivities(object(), tg, {}, None, {}) is None
