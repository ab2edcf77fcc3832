"""Real roots of quadratic and cubic polynomials (port of
nautilus_tpu/utils/polynomial.py: the reference's math_util SolveQuadratic /
SolveCubic), closed form on the host.

Both return the real roots in ascending order.
"""

from __future__ import annotations

import math
from typing import List


def solve_quadratic(a: float, b: float, c: float) -> List[float]:
    """Real roots of a x^2 + b x + c, ascending.  Degenerates to linear."""
    if a == 0.0:
        if b == 0.0:
            return []
        return [-c / b]
    disc = b * b - 4.0 * a * c
    if disc < 0.0:
        return []
    if disc == 0.0:
        return [-b / (2.0 * a)]
    sq = math.sqrt(disc)
    # The stable form: no cancellation between -b and the root.
    q = -0.5 * (b + math.copysign(sq, b))
    r1, r2 = q / a, c / q
    return sorted((r1, r2))


def solve_cubic(a: float, b: float, c: float, d: float) -> List[float]:
    """Real roots of a x^3 + b x^2 + c x + d, ascending."""
    if a == 0.0:
        return solve_quadratic(b, c, d)
    # Depressed cubic t^3 + p t + q with x = t - b/(3a).
    inv_a = 1.0 / a
    b1, c1, d1 = b * inv_a, c * inv_a, d * inv_a
    shift = b1 / 3.0
    p = c1 - b1 * b1 / 3.0
    q = 2.0 * b1 ** 3 / 27.0 - b1 * c1 / 3.0 + d1
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    roots: List[float]
    if disc > 1e-15:
        u = _cbrt(-q / 2.0 + math.sqrt(disc))
        v = _cbrt(-q / 2.0 - math.sqrt(disc))
        roots = [u + v]
    elif disc < -1e-15:
        # Three real roots (trigonometric form).
        m = 2.0 * math.sqrt(-p / 3.0)
        theta = math.acos(max(-1.0, min(1.0, 3.0 * q / (p * m)))) / 3.0
        roots = [m * math.cos(theta - 2.0 * math.pi * k / 3.0)
                 for k in range(3)]
    else:
        if abs(p) < 1e-15:
            roots = [0.0]
        else:
            roots = [3.0 * q / p, -3.0 * q / (2.0 * p)]
    return sorted(r - shift for r in roots)


def _cbrt(x: float) -> float:
    return math.copysign(abs(x) ** (1.0 / 3.0), x)
