"""Analytic ray intersections, fully vectorized and branch-free.

Replaces the reference's per-ray WGSL hit functions
(hit_sphere ray.wgsl:725-766, hit_torus2d :668-701, hit_aabb :703-723,
hit_triangle :768-847) with batched jnp versions: misses are encoded as
``t = MISS_T`` instead of branches, so everything is elementwise with no
divergence.  All functions broadcast over arbitrary leading ray dims.
"""

from __future__ import annotations

import jax.numpy as jnp

# Sentinel distance for "no intersection".  Large but finite so that
# arithmetic on it stays well-behaved in float32.
MISS_T = 1e8
# Reference uses t_min = 1e-8, t_max = 1e5 (ray.wgsl:492-493).
T_MIN = 1e-8
T_MAX = 1e5


def hit_sphere(origin, direction, center, radius, t_min=T_MIN, t_max=T_MAX):
    """Nearest valid intersection distance with a sphere.

    origin/direction: (..., 3). Returns (t, hit) with t = MISS_T on miss.
    Matches reference hit_sphere (ray.wgsl:725-766): both roots are tested
    against (t_min, t_max) and the nearest valid one wins.
    """
    oc = origin - center
    a = jnp.sum(direction * direction, axis=-1)
    b = 2.0 * jnp.sum(oc * direction, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    valid1 = (disc > 0.0) & (t1 > t_min) & (t1 < t_max)
    valid2 = (disc > 0.0) & (t2 > t_min) & (t2 < t_max)
    t = jnp.where(valid1, t1, jnp.where(valid2, t2, MISS_T))
    hit = valid1 | valid2
    return jnp.where(hit, t, MISS_T), hit


def hit_sphere_both(origin, direction, center, radius):
    """Both raw roots (t_near, t_far, real) — used for relativity-sphere
    entry/exit logic where the caller applies its own validity window."""
    oc = origin - center
    a = jnp.sum(direction * direction, axis=-1)
    b = 2.0 * jnp.sum(oc * direction, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return t1, t2, disc > 0.0


def hit_annulus(
    origin, direction, center, normal, inner_radius, outer_radius,
    t_min=T_MIN, t_max=T_MAX,
):
    """Flat annulus (the accretion disk): plane through ``center`` with
    ``normal``, keeping hits with radial distance in [inner, outer].

    Matches reference hit_torus2d (ray.wgsl:668-701).  Returns
    (t, hit, hit_point, signed_normal): the normal is flipped to face the ray.
    """
    denom = jnp.sum(normal * direction, axis=-1)
    delta = center - origin
    t = jnp.sum(delta * normal, axis=-1) / jnp.where(
        jnp.abs(denom) < 1e-12, jnp.sign(denom) * 1e-12 + 1e-20, denom
    )
    point = origin + direction * t[..., None]
    r = jnp.linalg.norm(point - center, axis=-1)
    hit = (t > t_min) & (t < t_max) & (r >= inner_radius) & (r <= outer_radius)
    facing = jnp.where(denom[..., None] < 0.0, -normal, normal)
    return jnp.where(hit, t, MISS_T), hit, point, facing


def hit_aabb(origin, inv_direction, box_min, box_max):
    """Slab-method AABB entry distance; MISS_T when the ray misses or the
    box is entirely behind the origin (reference hit_aabb ray.wgsl:703-723).

    ``inv_direction`` is precomputed 1/direction (callers reuse it across
    many boxes).  Broadcasts over both ray and box batch dims.
    """
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    miss = (t_near > t_far) | (t_far < 0.0)
    return jnp.where(miss, MISS_T, t_near)


def hit_triangles(
    origin, direction, p1, p2, p3, n1, n2, n3, t_min=T_MIN, t_max=T_MAX
):
    """Batched ray-triangle intersection with smooth-normal interpolation.

    origin/direction: (..., 3) rays; p*/n*: (..., 3) triangles (already
    broadcast against the rays by the caller — typically rays (R, 1, 3) vs
    triangles (1, T, 3)).

    Uses the same 3x3-determinant (Cramer) formulation as the reference
    (hit_triangle ray.wgsl:768-847) including its conventions:
      * the geometric normal is flipped toward the ray,
      * color = -n_smooth * 0.5 + 0.5 from the interpolated vertex normal,
      * near-parallel / degenerate triangles are rejected at |det| < 1e-5.

    Returns (t, hit, color, geom_normal).
    """
    edge_ab = p2 - p1
    edge_ac = p3 - p1
    n_geo = jnp.cross(edge_ab, edge_ac)
    n_geo = n_geo * jnp.reciprocal(
        jnp.linalg.norm(n_geo, axis=-1, keepdims=True) + 1e-20
    )
    ray_dot = jnp.sum(direction * n_geo, axis=-1)
    # Flip normal toward the ray (reference ray.wgsl:783-786).
    n_geo = jnp.where(ray_dot[..., None] > 0.0, -n_geo, n_geo)
    ray_dot = -jnp.abs(ray_dot)

    amb = p1 - p2
    amc = p1 - p3
    amo = p1 - origin

    def det3(a, b, c):
        return jnp.sum(a * jnp.cross(b, c), axis=-1)

    denom = det3(direction, amb, amc)
    safe_denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    u = det3(direction, amo, amc) / safe_denom
    v = det3(direction, amb, amo) / safe_denom
    t = det3(amo, amb, amc) / safe_denom

    hit = (
        (jnp.abs(ray_dot) >= 1e-5)
        & (jnp.abs(denom) >= 1e-5)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )

    n_smooth = (
        (1.0 - u - v)[..., None] * n1 + u[..., None] * n2 + v[..., None] * n3
    )
    color = -n_smooth * 0.5 + 0.5
    return jnp.where(hit, t, MISS_T), hit, color, n_geo
