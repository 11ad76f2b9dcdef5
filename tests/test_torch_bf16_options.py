"""Port parity: WENO5's two bfloat16 options, ``fast_bf16`` and
``bf16_smoothness``.

The port evaluates them on its plain path, each bf16 operation rounded as
torch rounds it; XLA's CPU backend evaluates some bf16 chains in fp32 and
rounds once, so the two packages differ by bf16 roundings, not bit for bit.
Held to the accuracy gates of the JAX suite's ``tests/test_bf16_smoothness.py``:

- ``bf16_smoothness``: the port's reconstruction differs from its fp32 one
  by at most the spread of the candidate stencils and stays inside their
  hull, on a smooth and a rough field, and so does JAX's: the two differ
  by at most that spread; on a smooth field its error from the fp64 truth
  stays below max(10·err₃₂, 2e-5);
- ``fast_bf16``: the whole reconstruction in bf16, within four bf16 units
  of JAX's, through the stream, ``left_right_to_f`` and the stretched
  axis' tables;
- 3 AB2 steps of the 16³ benchmark configuration with
  ``bf16_smoothness``: finite, within 5e-3 of each field's scale from the
  fp32 run, and from the JAX run with the option.

The kernels' bf16 forms are held on the card in
``tests/test_torch_bf16_kernels.py``.
"""
import numpy as np
import pytest
import torch

import clima_oceananigans_jl_torch as T
from clima_oceananigans_jl_torch.advection import schemes as tsch
from clima_oceananigans_jl_torch.advection.reconstruction_tables import weno5_tables

import jax
import jax.numpy as jnp

import clima_oceananigans_jl_tpu as J
from clima_oceananigans_jl_tpu.advection import schemes as jsch
from clima_oceananigans_jl_tpu.advection.reconstruction_tables import (
    weno5_tables as j_tables)
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer as JB
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel as JN

torch.set_num_threads(1)

DEVICE = "cpu"
OPTIONS = {"smoothness": dict(bf16_smoothness=True), "fast": dict(fast_bf16=True)}


def fields():
    x = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    rng = np.random.default_rng(0)
    return {"smooth": np.sin(x) + 0.3 * np.cos(3 * x),
            "rough": np.where(x < np.pi, 1.0, 0.0) + 0.1 * rng.standard_normal(x.shape)}


def streams(c):
    """The left-biased stream of ``c`` (a column along x) in both
    packages."""
    j = jsch.upwind_stream(jnp.asarray(c), jnp.ones(c.shape, bool), 0, True)
    t = tsch.upwind_stream(torch.as_tensor(c), torch.ones(c.shape, dtype=torch.bool), 0, True)
    return j, t


def hull(a):
    """The candidate stencils' min and max (numpy, fp32)."""
    a0, a1, a2, a3, a4 = (np.asarray(x, dtype=np.float64) for x in a)
    d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
    p = (a2 + (5.0 * d11 - 2.0 * d10) / 6.0, a2 + (2.0 * d12 + d11) / 6.0,
         a2 + (4.0 * d12 - d13) / 6.0)
    return np.minimum(p[0], np.minimum(p[1], p[2])), np.maximum(p[0], np.maximum(p[1], p[2]))


@pytest.mark.parametrize("field", ["smooth", "rough"])
def test_bf16_smoothness_stays_within_the_candidate_spread(field):
    c = fields()[field].astype(np.float32)[:, None, None]
    ja, ta = streams(c)
    rec32 = T.WENO5().stream_reconstruct(ta).numpy()
    got = T.WENO5(bf16_smoothness=True).stream_reconstruct(ta).numpy()
    ref = np.asarray(J.WENO5(bf16_smoothness=True).stream_reconstruct(ja))
    assert got.dtype == np.float32
    lo, hi = hull(ta)
    spread = hi - lo
    assert np.all(np.abs(got - rec32) <= spread + 1e-6)
    assert np.all(got <= hi + 1e-5) and np.all(got >= lo - 1e-5)
    assert np.all(np.abs(got - ref) <= spread + 1e-6)


def test_bf16_smoothness_is_accurate_on_a_smooth_field():
    x = np.linspace(0, 2 * np.pi, 128, endpoint=False)
    c64 = np.sin(x)[:, None, None]
    _, t64 = streams(c64)
    rec64 = T.WENO5().stream_reconstruct(t64).numpy()
    _, t32 = streams(c64.astype(np.float32))
    err32 = np.abs(T.WENO5().stream_reconstruct(t32).numpy().astype(np.float64) - rec64)
    errbf = np.abs(T.WENO5(bf16_smoothness=True).stream_reconstruct(t32).numpy()
                   .astype(np.float64) - rec64)
    assert err32.max() < 5e-6
    assert errbf.max() < max(10 * err32.max(), 2e-5), (errbf.max(), err32.max())


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("field", ["smooth", "rough"])
def test_reconstructions_match_jax_within_bf16_roundings(field, option):
    """The stream and ``left_right_to_f``: ``bf16_smoothness`` within the
    candidate spread of JAX's; ``fast_bf16`` within four bf16 units."""
    c = fields()[field].astype(np.float32)[:, None, None]
    ja, ta = streams(c)
    kw = OPTIONS[option]
    tol = (4 * 2.0 ** -8 * np.abs(c).max() if option == "fast"
           else (lambda s: s[1] - s[0])(hull(ta)) + 1e-6)
    got = T.WENO5(**kw).stream_reconstruct(ta).numpy()
    ref = np.asarray(J.WENO5(**kw).stream_reconstruct(ja))
    assert got.dtype == np.float32 and np.all(np.abs(got - ref) <= tol)
    for r, g in zip(J.WENO5(**kw).left_right_to_f(jnp.asarray(c), 0),
                    T.WENO5(**kw).left_right_to_f(torch.as_tensor(c), 0)):
        lim = 4 * 2.0 ** -8 * np.abs(c).max() if option == "fast" else 1e-3
        assert g.dtype == torch.float32
        assert np.abs(np.asarray(r) - g.numpy()).max() <= lim


def test_fast_bf16_on_a_stretched_axis_matches_jax():
    """The tables route casts the rows to bf16 with the field."""
    size = (6, 5, 24)
    z = np.cumsum(np.r_[-1.0, np.linspace(0.02, 0.06, size[2])])
    kw = dict(size=size, x=(0, 1), y=(0, 1), z=z, topology=("periodic", "periodic", "bounded"))
    jg, tg = J.RectilinearGrid(dtype=jnp.float32, **kw), T.RectilinearGrid(
        dtype=torch.float32, device=DEVICE, **kw)
    c = np.sin(np.linspace(0, 6, tg.total_shape[2]))[None, None, :] * np.ones(tg.total_shape)
    c = c.astype(np.float32)
    for side in ("left", "right"):
        ref = J.WENO5(fast_bf16=True).table_reconstruct(jnp.asarray(c), 2, j_tables(jg, 2, True),
                                                        side)
        got = T.WENO5(fast_bf16=True).table_reconstruct(torch.as_tensor(c), 2,
                                                        weno5_tables(tg, 2, True), side)
        assert got.dtype == torch.float32
        assert np.abs(np.asarray(ref) - got.numpy()).max() <= 4 * 2.0 ** -8


def test_full_model_close_and_stable():
    """``tests/test_bf16_smoothness.py``'s third case in the port: 3 AB2
    steps of the 16³ benchmark configuration, fp32."""
    n = 16
    rng = np.random.default_rng(0)
    vals = dict(u=1e-2 * rng.standard_normal((n, n, n)), v=1e-2 * rng.standard_normal((n, n, n)),
                b=1e-4 * rng.standard_normal((n, n, n)))
    kw = dict(size=(n, n, n), extent=(1., 1., 1.), topology=("periodic", "periodic", "bounded"))
    sols = {}
    for bf in (False, True):
        m = T.NonhydrostaticModel(T.RectilinearGrid(dtype=torch.float32, device=DEVICE, **kw),
                                  advection=T.WENO5(bf16_smoothness=bf),
                                  buoyancy=T.BuoyancyTracer())
        s = m.initial_state(**vals)
        for _ in range(3):
            s = m.step(s, 1e-3)
        sols[bf] = {k: m.grid.interior(v).numpy() for k, v in s["solution"].items()}
        for k, v in sols[bf].items():
            assert np.all(np.isfinite(v)), k
    jm = JN(J.RectilinearGrid(dtype=jnp.float32, **kw), advection=J.WENO5(bf16_smoothness=True),
            buoyancy=JB(), fused_advection=False)
    js = jm.initial_state(**vals)
    step = jax.jit(jm.step)
    for _ in range(3):
        js = step(js, jnp.float32(1e-3))
    for k in sols[True]:
        scale = np.abs(sols[False][k]).max() + 1e-12
        assert np.abs(sols[True][k] - sols[False][k]).max() < 5e-3 * scale, k
        ref = np.asarray(jm.grid.interior(js["solution"][k]))
        assert np.abs(sols[True][k] - ref).max() < 5e-3 * scale, k
