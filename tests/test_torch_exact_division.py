"""The rule of ``ieee_div`` (``clima_oceananigans_jl_torch/csrc/
weno5_advection.cuh``), which every division of the K1, K2, K3a and K4b
kernels goes through, gives IEEE's own quotient bit for bit.

``ieee_div(x, y)`` returns x itself when y > 0 and x is ±0, and
(x·2⁶⁴)/(y·2⁶⁴) when 0 < y < 2⁴⁸ and |x| < 2⁻⁶⁴; otherwise x / y.
``ieee_div_by(x, c)``, for WENO5's constant divisors c = 6 and 2, returns
x itself when x is ±0 and x / c otherwise. Here numpy's float32 and float64 division (IEEE, correctly
rounded, no flush to zero) stands for the card's ``div.rn``: the rule,
case for case, must equal ``x / y`` in every bit over ε-sized, zero, subnormal,
huge, negative and random operands, and over the WENO5 weights and
candidate stencils of smooth, flat and random streams in the plain
version's expression tree (``advection/schemes.py``).
"""
import numpy as np
import pytest

DTYPES = [np.float32, np.float64]
UINT = {np.float32: np.uint32, np.float64: np.uint64}


def ieee_div(x, y):
    """The kernels' rule, case for case."""
    t = x.dtype.type
    zero = (x == 0) & (y > 0)
    tiny = (y > 0) & (y < t(2.0 ** 48)) & (np.abs(x) < t(2.0 ** -64))
    with np.errstate(all="ignore"):
        q = (np.where(tiny, x * t(2.0 ** 64), x)
             / np.where(tiny, y * t(2.0 ** 64), y))
    return np.where(zero, x, q)


def ieee_div_by(x, c):
    """``ieee_div_by``: x / c for a constant c > 0, the zero case only."""
    with np.errstate(all="ignore"):
        return np.where(x == 0, x, x / c)


def assert_bitwise(got, ref):
    """Equal in every bit; two NaNs count as equal (their payload is not
    part of the rule)."""
    both_nan = np.isnan(got) & np.isnan(ref)
    u = UINT[got.dtype.type]
    same = got.view(u) == ref.view(u)
    bad = ~(same | both_nan)
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


def quotient(x, y):
    with np.errstate(all="ignore"):
        return x / y


def classes(dtype, rng, n=20000):
    t = dtype
    tiny = np.finfo(t).smallest_subnormal
    big = np.finfo(t).max
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(t)
    den_eps = (1e-24 * u(1.0, 3.0)).astype(t)
    return {
        "random": (rng.standard_normal(n).astype(t), u(0.5, 2.0)),
        "eps-sized den, p ~ 0.1": ((0.1 * u(-1, 1) * den_eps).astype(t), den_eps),
        "eps-sized den, p ~ 1e-6": ((1e-6 * u(-1, 1) * den_eps).astype(t), den_eps),
        "zero over 6": (np.zeros(n, t), np.full(n, 6.0, t)),
        "minus zero over eps": (-np.zeros(n, t), den_eps),
        "zero over negative or zero": (np.zeros(n, t), (-u(0, 2)).astype(t)),
        "subnormal num": ((tiny * rng.integers(1, 1000, n)).astype(t), u(1e-3, 1e3)),
        "subnormal den": (u(-1, 1), (tiny * rng.integers(1, 1000, n)).astype(t)),
        "tiny num, den near 2^48": ((1e-30 * u(-1, 1)).astype(t),
                                    (2.0 ** 48 * u(0.5, 1.5)).astype(t)),
        "num near 2^-64": ((2.0 ** -64 * u(0.5, 1.5)).astype(t), u(1e-20, 1e20)),
        "subnormal quotient": ((2.0 ** -140 * u(-1, 1)).astype(t), u(0.5, 2.0)),
        "quotient near 2^-126": ((2.0 ** -100 * u(-1, 1)).astype(t),
                                 (2.0 ** 26 * u(0.5, 2.0)).astype(t)),
        "huge": ((big * u(-1, 1)).astype(t), u(1e-30, 1e30)),
        "signs": (rng.standard_normal(n).astype(t), rng.standard_normal(n).astype(t)),
        "tiny products": ((u(-1, 1) * 1e-7 * u(-1, 1) * 1e-30).astype(t), u(0.9, 1.1)),
        "specials": (np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 1e-40, 0.0] * (n // 8),
                              dtype=t),
                     np.array([np.inf, 1e-30, 1e-30, 2.0, 1.0, np.nan, 0.0, 0.0] * (n // 8),
                              dtype=t)),
    }


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(classes(np.float32, np.random.default_rng(0))))
def test_rule_is_ieee_division(dtype, case):
    x, y = classes(dtype, np.random.default_rng(1))[case]
    assert_bitwise(ieee_div(x, y), quotient(x, y))


def weno_weights(a, eps):
    """num, den and the candidate numerators of WENO5._weno_stream, in the
    kernels' (and the plain version's) expression tree."""
    t = a.dtype.type
    a0, a1, a2, a3, a4 = a
    d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
    d20, d21, d22 = d11 - d10, d12 - d11, d13 - d12
    s0, s1, s2 = d20 + t(2) * d11, d11 + d12, d22 - t(2) * d12
    k = t(13.0 / 12.0)
    b0 = k * d20 * d20 + t(0.25) * (s0 * s0)
    b1 = k * d21 * d21 + t(0.25) * (s1 * s1)
    b2 = k * d22 * d22 + t(0.25) * (s2 * s2)
    c = [t(5) * d11 - t(2) * d10, t(2) * d12 + d11, t(4) * d12 - d13]
    p = [a2 + ci / t(6) for ci in c]
    e0, e1, e2 = b0 + t(eps), b1 + t(eps), b2 + t(eps)
    t0, t1, t2 = e0 * e0, e1 * e1, e2 * e2
    g0, g1, g2 = t(0.1) * (t1 * t2), t(0.6) * (t0 * t2), t(0.3) * (t0 * t1)
    return g0 * p[0] + g1 * p[1] + g2 * p[2], g0 + g1 + g2, c


def streams(kind, dtype, rng, n=4000):
    x = np.linspace(0.0, 2 * np.pi, n + 4)
    if kind == "smooth":  # a slowly varying field of ~1e-6, like vh on the path
        f = 1e-6 * np.sin(x) * np.cos(0.3 * x)
    elif kind == "smooth-order-one":
        f = 0.1 * np.sin(x)
    elif kind == "flat":
        f = np.full(n + 4, 2e-5)
    elif kind == "zero":
        f = np.zeros(n + 4)
    else:
        f = rng.standard_normal(n + 4)
    f = f.astype(dtype)
    return np.stack([f[m:m + n] for m in range(5)])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["smooth", "smooth-order-one", "flat", "zero", "random"])
def test_rule_on_weno5_streams(dtype, kind):
    a = streams(kind, dtype, np.random.default_rng(2))
    with np.errstate(all="ignore"):
        num, den, cand = weno_weights(a, 1e-6)
    assert_bitwise(ieee_div(num, den), quotient(num, den))
    six = np.full_like(cand[0], 6.0)
    for c in cand:
        assert_bitwise(ieee_div(c, six), quotient(c, six))
        assert_bitwise(ieee_div_by(c, six), quotient(c, six))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "zero over 6", "subnormal num", "tiny products",
                                  "subnormal quotient", "specials"])
@pytest.mark.parametrize("c", [6.0, 2.0])
def test_division_by_a_constant_is_ieee_division(dtype, case, c):
    x, _ = classes(dtype, np.random.default_rng(3))[case]
    cs = np.full_like(x, c)
    assert_bitwise(ieee_div_by(x, cs), quotient(x, cs))
