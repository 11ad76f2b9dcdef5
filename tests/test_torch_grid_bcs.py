"""Port parity: grids and halo fills against the JAX package.

The same inputs, made with numpy from a seed, go through
``clima_oceananigans_jl_tpu`` and ``clima_oceananigans_jl_torch`` in f64.
Grid metrics are built from the same float64 numpy arrays, and halo
fills are pure copies and ``2b - x`` / ``x - b·d`` formulas, so both are
held to exact equality (no tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_torch.boundary_conditions import bcs as tbcs
from clima_oceananigans_jl_tpu.boundary_conditions import bcs as jbcs

torch.set_num_threads(1)

#: grids default to the card; these tests ask for the CPU
DEVICE = "cpu"

SIZE = (16, 12, 10)
EXTENT = (1.0, 2.0, 0.5)
LOCS = {"ccc": J.CENTER, "fcc": J.U_LOC, "cfc": J.V_LOC, "ccf": J.W_LOC}
TOPOS = {"PPB": ("periodic", "periodic", "bounded"),
         "PPP": ("periodic", "periodic", "periodic")}


def grids(topo, halo=None):
    t = TOPOS[topo]
    jg = J.RectilinearGrid(size=SIZE, extent=EXTENT, topology=t, halo=halo,
                           dtype=jnp.float64)
    tg = T.RectilinearGrid(size=SIZE, extent=EXTENT, topology=t, halo=halo,
                           dtype=torch.float64, device=DEVICE)
    return jg, tg


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("halo", [None, (3, 4, 2)])
def test_grid_metrics_match(topo, halo):
    jg, tg = grids(topo, halo)
    assert tg.shape == jg.shape and tg.total_shape == jg.total_shape
    assert tg.halo == jg.halo
    for ja, ta in zip(jg._axes, tg._axes):
        for name in ("cf", "cc", "dc", "df"):
            assert same(getattr(ja, name), getattr(ta, name)), name
        assert ja.extent == ta.extent
    for loc in LOCS.values():
        for m in ("dx", "dy", "dz", "Ax", "Ay", "Az", "V"):
            assert same(getattr(jg, m)(loc), getattr(tg, m)(loc)), (m, loc)
        for jn, tn in zip(jg.nodes(loc, with_halo=True),
                          tg.nodes(loc, with_halo=True)):
            assert same(jn, tn)
        for jn, tn in zip(jg.nodes(loc), tg.nodes(loc)):
            assert same(jn, tn)


def test_grid_interior_with_halo_and_refusals():
    jg, tg = grids("PPB")
    data = np.random.default_rng(0).standard_normal(tg.total_shape)
    assert same(jg.interior(jnp.asarray(data)), tg.interior(torch.from_numpy(data)))
    assert tg.interior(torch.zeros(tg.shape)).shape == tg.shape
    jh, th = jg.with_halo((4, 4, 4)), tg.with_halo((4, 4, 4))
    assert th.halo == jh.halo == (4, 4, 4)
    for ja, ta in zip(jh._axes, th._axes):
        assert same(ja.cf, ta.cf) and same(ja.cc, ta.cc)
    # a stretched axis is ported now (it raised NotImplementedError before):
    # it builds as the JAX one does, and unordered faces are refused
    faces = [0.0, 0.1, 0.3, 0.6, 1.0]
    js = J.RectilinearGrid(size=(4, 4, 4), x=(0, 1), y=(0, 1), z=faces,
                           dtype=jnp.float64)
    ts = T.RectilinearGrid(size=(4, 4, 4), x=(0, 1), y=(0, 1), z=faces,
                           dtype=torch.float64, device=DEVICE)
    assert ts.regular == (True, True, False) and not ts.all_regular
    for ja, ta in zip(js._axes, ts._axes):
        for name in ("cf", "cc", "dc", "df"):
            assert same(getattr(ja, name), getattr(ta, name)), name
    with pytest.raises(ValueError):
        T.RectilinearGrid(size=(4, 4, 4), x=(0, 1), y=(0, 1),
                          z=[0.0, 0.3, 0.1, 0.6, 1.0], device=DEVICE)


def _bc_cases():
    """(label, loc name, factory of (bottom, top) BC pairs as (J, T))."""
    nx, ny = SIZE[0], SIZE[1]
    plane = np.random.default_rng(7).standard_normal((nx, ny))
    fn = lambda x, y, t: 0.5 * x - 2.0 * y + t
    cases = [
        ("default", "ccc", None),
        ("default", "ccf", None),
        ("default", "fcc", None),
        ("value", "ccc", ("value", 0.3)),
        ("value_plane", "ccc", ("value", plane)),
        ("value_fn", "ccc", ("value", fn)),
        ("gradient", "ccc", ("gradient", -1.5)),
        ("gradient_fn", "cfc", ("gradient", fn)),
        ("flux", "ccc", ("flux", None)),
        ("open", "ccf", ("open", 0.0)),
        ("open_value", "ccf", ("open", 0.2)),
        ("value_face", "ccf", ("value", plane)),
        ("flux_face", "ccf", ("flux", None)),
    ]
    return cases


@pytest.mark.parametrize("label,locname,spec", _bc_cases(),
                         ids=[c[0] + "-" + c[1] for c in _bc_cases()])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_fill_halos_match(topo, label, locname, spec):
    jg, tg = grids(topo)
    loc = LOCS[locname]
    if spec is None or topo == "PPP":
        jb = tb = None
    else:
        kind, value = spec
        jb = jbcs.FieldBCs(bottom=jbcs.BC(kind, value), top=jbcs.BC(kind, value))
        tb = tbcs.FieldBCs(bottom=tbcs.BC(kind, value), top=tbcs.BC(kind, value))
    jbc = jbcs.regularize_bcs(jg, loc, jb)
    tbc = tbcs.regularize_bcs(tg, loc, tb)
    data = np.random.default_rng(3).standard_normal(tg.total_shape)
    got = tbcs.fill_halos(torch.from_numpy(data.copy()), tg, loc, tbc, t=0.25)
    ref = jbcs.fill_halos(jnp.asarray(data), jg, loc, jbc, t=0.25)
    assert same(ref, got)


def test_fill_halos_axes_subset_and_flux_value_refused():
    jg, tg = grids("PPB")
    data = np.random.default_rng(4).standard_normal(tg.total_shape)
    got = tbcs.fill_halos(torch.from_numpy(data.copy()), tg, J.CENTER,
                          axes=(0, 1))
    ref = jbcs.fill_halos(jnp.asarray(data), jg, J.CENTER, axes=(0, 1))
    assert same(ref, got)
    G = torch.zeros(tg.total_shape, dtype=torch.float64)
    assert tbcs.apply_flux_bcs(G, tg, J.CENTER,
                               tbcs.regularize_bcs(tg, J.CENTER)) is G
    # a flux value, refused before flux values were ported, now adds what
    # the JAX package adds (tests/test_torch_flux_bcs.py holds every form)
    got = tbcs.apply_flux_bcs(G, tg, J.CENTER, tbcs.regularize_bcs(
        tg, J.CENTER, tbcs.FieldBCs(top=tbcs.FluxBC(1e-3))))
    ref = jbcs.apply_flux_bcs(jnp.zeros(tg.total_shape), jg, J.CENTER,
                              jbcs.regularize_bcs(jg, J.CENTER, jbcs.FieldBCs(
                                  top=jbcs.FluxBC(1e-3))))
    assert same(ref, got) and got.abs().max() > 0 and not G.any()


@pytest.mark.parametrize("value", ["scalar", "interior", "with_halo", "callable"])
def test_set_field_matches(value):
    from clima_oceananigans_jl_torch.fields import field as tf
    from clima_oceananigans_jl_tpu.fields import field as jf
    jg, tg = grids("PPB")
    rng = np.random.default_rng(5)
    val = {"scalar": 0.7, "interior": rng.standard_normal(SIZE),
           "with_halo": rng.standard_normal(tg.total_shape),
           "callable": lambda x, y, z: x * y - 3.0 * z}[value]
    for loc in LOCS.values():
        ref = jf.set_field(jf.new_field(jg, loc), jg, val).data
        got = tf.set_field(tf.new_field(tg, loc), tg, val).data
        assert same(ref, got), loc
