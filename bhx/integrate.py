"""Geodesic integrator steps: fixed-step Euler and adaptive Cash-Karp RK45.

Replaces the reference's per-pixel integrator (ray.wgsl:405-480) with
fully vectorized per-lane steppers.  The march loop itself lives in
:mod:`bhx.tracer` (jnp) and :mod:`bhx.kernels.march_pallas` (Pallas); both
call these step functions, which are pure elementwise math over batches of
rays.

Design notes vs the reference (SURVEY.md §2 row 15, §7 hard part 1):

* The reference's RK45 "adaptive" controller (ray.wgsl:422-462) uses
  eps=1, yscal=1, so every step is accepted immediately and the step size
  only drifts via ``h *= 0.9*e_max^-0.001`` — it is adaptive in name only.
  Ours is a real embedded-error controller.  Because an inner
  rejection-retry loop is poison for SIMD lanes, rejection is handled by the
  *outer* march loop: a rejected lane keeps its old state and retries with
  the shrunken h on the next march iteration (masked update, no divergence).

* The reference tableau has a typo — ``a_43 * k_2`` where Cash-Karp
  requires ``a_43 * k_3`` (ray.wgsl:431).  We use the correct tableau; our
  gradient-parity gate is against our own finite-difference reference
  (BASELINE.md), so we fix rather than match.

* Only the ray *direction* is an RK state variable (as in the reference);
  position advances linearly along the (old) direction.  The direction is
  re-normalized after each accepted step (null rays, |v| = 1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bhx.physics import angular_momentum_sq, geodesic_accel

# Cash-Karp embedded Runge-Kutta tableau (correct a43; see module docstring).
A21 = 1.0 / 5.0
A31, A32 = 3.0 / 40.0, 9.0 / 40.0
A41, A42, A43 = 3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0
A51, A52, A53, A54 = -11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0
A61, A62, A63, A64, A65 = (
    1631.0 / 55296.0,
    175.0 / 512.0,
    575.0 / 13824.0,
    44275.0 / 110592.0,
    253.0 / 4096.0,
)
# 5th-order solution weights.
B1, B2, B3, B4, B5, B6 = (
    37.0 / 378.0,
    0.0,
    250.0 / 621.0,
    125.0 / 594.0,
    0.0,
    512.0 / 1771.0,
)
# Embedded 4th-order weights.
BH1, BH2, BH3, BH4, BH5, BH6 = (
    2825.0 / 27648.0,
    0.0,
    18575.0 / 48384.0,
    13525.0 / 55296.0,
    277.0 / 14336.0,
    1.0 / 4.0,
)
# Error weights (b - b_hat).
E1, E2, E3, E4, E5, E6 = (
    B1 - BH1,
    B2 - BH2,
    B3 - BH3,
    B4 - BH4,
    B5 - BH5,
    B6 - BH6,
)


def _normalize(v, eps=1e-12):
    return v * jnp.reciprocal(jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True)) + eps)


def euler_step(pos, direction, h, bh_pos, mass):
    """One fixed-step Euler update (reference next_ray_euler, ray.wgsl:467-480).

    pos, direction: (..., 3); h: (...,) or scalar.
    Returns (new_pos, new_dir).  Position advances along the *new* direction
    (matching the reference).
    """
    rel = pos - bh_pos
    h2 = angular_momentum_sq(rel, direction)
    acc = geodesic_accel(rel, h2, mass)
    hh = jnp.asarray(h)[..., None]
    new_dir = _normalize(direction + acc * hh)
    new_pos = pos + new_dir * hh
    return new_pos, new_dir


class RKResult(NamedTuple):
    pos: jnp.ndarray  # proposed new position (..., 3)
    direction: jnp.ndarray  # proposed new direction (..., 3)
    h_used: jnp.ndarray  # (...,) step size this proposal used
    h_next: jnp.ndarray  # (...,) controller-updated step size
    accept: jnp.ndarray  # (...,) bool — whether the proposal meets tolerance


def rk45_step(
    pos,
    direction,
    h,
    bh_pos,
    mass,
    rtol: float = 1e-3,
    safety: float = 0.9,
    min_factor: float = 0.2,
    max_factor: float = 1.5,
    h_min: float = 1e-3,
    h_max: float = 1.0,
) -> RKResult:
    """One adaptive Cash-Karp RK45 proposal for the ray direction.

    The caller applies the update only where ``accept``; rejected lanes keep
    their state and retry with ``h_next`` (masked-lane adaptivity, no inner
    loop).  h2 (conserved) is computed once per step; the radial distance
    entering the acceleration is recomputed at every stage.
    """
    rel = pos - bh_pos
    h2 = angular_momentum_sq(rel, direction)
    hh = jnp.asarray(h)[..., None]

    def f(p):
        return geodesic_accel(p - bh_pos, h2, mass)

    k1 = f(pos)
    k2 = f(pos + (A21 * k1) * hh)
    k3 = f(pos + (A31 * k1 + A32 * k2) * hh)
    k4 = f(pos + (A41 * k1 + A42 * k2 + A43 * k3) * hh)
    k5 = f(pos + (A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4) * hh)
    k6 = f(pos + (A61 * k1 + A62 * k2 + A63 * k3 + A64 * k4 + A65 * k5) * hh)

    incr = B1 * k1 + B3 * k3 + B4 * k4 + B6 * k6  # B2 = B5 = 0
    err_vec = hh * (E1 * k1 + E3 * k3 + E4 * k4 + E5 * k5 + E6 * k6)  # E2 = 0
    err = jnp.max(jnp.abs(err_vec), axis=-1)

    new_dir = _normalize(direction + hh * incr)
    # Reference advances position along the *old* direction for RK
    # (ray.wgsl:456) — kept for parity.
    new_pos = pos + direction * hh

    err_ratio = err / rtol
    accept = err_ratio <= 1.0
    # Controller: the -0.25 exponent is used for both grow and shrink so the
    # factor is two hardware rsqrts (rsqrt(rsqrt(x))) in the Pallas kernel —
    # slightly conservative growth vs the textbook -0.2, identical clamps.
    factor_raw = safety * jax.lax.rsqrt(jax.lax.rsqrt(err_ratio + 1e-12))
    grow = factor_raw
    shrink = factor_raw
    factor = jnp.where(
        accept,
        jnp.clip(grow, 1.0, max_factor),
        jnp.clip(shrink, min_factor, 1.0),
    )
    h_next = jnp.clip(h * factor, h_min, h_max)

    return RKResult(
        pos=new_pos, direction=new_dir, h_used=jnp.asarray(h), h_next=h_next, accept=accept
    )
