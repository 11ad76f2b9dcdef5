"""Time, length and memory unit constants and ``prettytime``.

Counterpart of ``clima_oceananigans_jl_tpu/utils/units.py`` (Oceananigans'
``Units`` and ``prettytime``); the strings are the JAX package's.
"""
from __future__ import annotations

# time (seconds)
second = 1.0
seconds = second
minute = 60.0
minutes = minute
hour = 60.0 * minute
hours = hour
day = 24.0 * hour
days = day
year = 365.0 * day
years = year

# length (meters)
meter = 1.0
meters = meter
kilometer = 1000.0
kilometers = kilometer

# memory
KiB, MiB, GiB, TiB = 2.0 ** 10, 2.0 ** 20, 2.0 ** 30, 2.0 ** 40


def prettytime(t):
    """A time span in the largest unit that keeps it ≥ 1, three decimals."""
    t = float(t)
    if t < 1e-6:
        return f"{t * 1e9:.3f} ns"
    if t < 1e-3:
        return f"{t * 1e6:.3f} μs"
    if t < 1.0:
        return f"{t * 1e3:.3f} ms"
    if t < minute:
        return f"{t:.3f} seconds"
    if t < hour:
        return f"{t / minute:.3f} minutes"
    if t < day:
        return f"{t / hour:.3f} hours"
    if t < year:
        return f"{t / day:.3f} days"
    return f"{t / year:.3f} years"
