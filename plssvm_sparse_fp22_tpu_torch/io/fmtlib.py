"""{fmt}-compatible number formatting.

The reference writes model files with ``fmt::format("{}", double)`` (shortest
round-trip representation, integral values without a trailing ``.0``) and
feature values with ``fmt::format("{}:{:e}", idx, v)`` (``csvm.cpp:144-154``).
These helpers reproduce that byte format from Python so model files are
interchangeable with the reference's ``plssvm-predict`` (SURVEY.md §7 hard
part (e)).
"""

from __future__ import annotations

import math


def fmt_shortest(v: float) -> str:
    """Mimic ``fmt::format("{}", v)`` for ``float``/``double``.

    fmt uses the shortest representation that round-trips (Dragonbox), and
    prints integral doubles without a decimal point (``1.0`` -> ``"1"``).
    Python's ``repr`` is also shortest-round-trip, so only the integral case
    needs adjusting.
    """
    v = float(v)
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if v == int(v) and abs(v) < 1e16:
        return str(int(v))
    return repr(v)


def fmt_scientific(v: float) -> str:
    """Mimic ``fmt::format("{:e}", v)``: 6 fractional digits, e+NN exponent."""
    return f"{float(v):e}"
