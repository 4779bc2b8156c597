"""Gather-free procedural texture evaluation.

All three reference textures are *procedural* (disk.png is baked by the
perlin/ cargo tool, colourtemp.jpg is a blackbody ramp, sky.png is a star
photo we replace with a star field), so they are re-evaluated
arithmetically per sample: hash-gradient Perlin, a cell-hash star grid,
and a polynomial fit of the Planck locus — pure elementwise math, zero
gathers, the same code in jnp, numpy and Pallas kernel bodies.

`bhx.assets` bakes its array textures FROM these samplers, so
``texture_mode="array"`` (user-supplied content, texture gradients) and the
default ``texture_mode="procedural"`` agree up to bilinear resampling.

Reference provenance: perlin noise + spiral warp perlin/src/main.rs:6-107,
octave merge :133-148; blackbody LUT addressing ray.wgsl:644-655; sky
transfer sky.wgsl:23-26.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Hash + Perlin (identical math in jnp and numpy: uint32 ops are exact)
# ---------------------------------------------------------------------------


def _hash2(ix, iy, xp=jnp):
    """2x32-bit integer mix -> uint32 (same constants as bhx.assets)."""
    a = ix.astype(xp.uint32)
    b = iy.astype(xp.uint32)
    a = a * xp.uint32(0x9E3779B1)
    b = b ^ ((a << xp.uint32(16)) | (a >> xp.uint32(16)))
    b = b * xp.uint32(0x85EBCA77)
    a = a ^ ((b << xp.uint32(16)) | (b >> xp.uint32(16)))
    a = a * xp.uint32(0xC2B2AE3D)
    return a


def hash01(ix, iy, xp=jnp):
    """Uniform [0,1) float32 from two integer coordinates.

    Uses the hash's top 24 bits via an int32 hop: float32 only holds 24
    mantissa bits anyway, so this formulation is exact and bit-identical
    between the jnp, numpy, and Pallas paths.
    """
    h = _hash2(ix, iy, xp) >> xp.uint32(8)
    return h.astype(xp.int32).astype(xp.float32) * xp.float32(1.0 / 16777216.0)


def _grad(ix, iy, xp=jnp):
    """Unit-ish lattice gradient from hash bits — no trig (two bit-slices
    + one rsqrt instead of cos/sin of a hash angle).
    The 16-bit slices hop through int32 (see hash01).
    """
    h = _hash2(ix, iy, xp)
    gx = (h & xp.uint32(0xFFFF)).astype(xp.int32).astype(xp.float32) \
        * xp.float32(2.0 / 65535.0) - 1.0
    gy = (h >> xp.uint32(16)).astype(xp.int32).astype(xp.float32) \
        * xp.float32(2.0 / 65535.0) - 1.0
    inv = 1.0 / xp.sqrt(gx * gx + gy * gy + xp.float32(1e-12))
    return gx * inv, gy * inv


def _fade(t):
    return ((t * 6.0 - 15.0) * t + 10.0) * t * t * t


def perlin(x, y, xp=jnp):
    """Perlin noise in [0,1] at (x, y); vectorized, differentiable."""
    x0 = xp.floor(x)
    y0 = xp.floor(y)
    sx = (x - x0).astype(xp.float32)
    sy = (y - y0).astype(xp.float32)
    x0i = x0.astype(xp.int32)
    y0i = y0.astype(xp.int32)

    def grad_dot(ox, oy):
        gx, gy = _grad(x0i + ox, y0i + oy, xp)
        return (sx - ox) * gx + (sy - oy) * gy

    n00 = grad_dot(0, 0)
    n10 = grad_dot(1, 0)
    n01 = grad_dot(0, 1)
    n11 = grad_dot(1, 1)
    u = _fade(sx)
    v = _fade(sy)
    nx0 = n00 + (n10 - n00) * u
    nx1 = n01 + (n11 - n01) * u
    val = nx0 + (nx1 - nx0) * v
    return val * 0.5 + 0.5


# ---------------------------------------------------------------------------
# Accretion-disk texture (reference perlin tool: 4 spiral-warped octaves)
# ---------------------------------------------------------------------------

DISK_DENSITIES = (4.0, 20.0, 50.0, 100.0)  # perlin/src/main.rs:133-141
SPIRAL_AMOUNT = 2.0
SPIRAL_POWER = 0.5


def disk_texel_m(u, v, xp=jnp):
    """Scalar texel value m of the procedural accretion texture at uv.

    Continuous version of the bake pipeline (warp evaluated exactly instead
    of via the tool's nearest-pixel remap): uv -> polar, spiral-unwarp
    theta += r^0.5 * pi * amount, then the 50/50 octave merge cascade.
    Shape-agnostic elementwise math — also runs inside the Pallas shade
    kernel (bhx.kernels.shade_pallas) on blocks of rays.
    """
    rx = u * 2.0 - 1.0
    ry = v * 2.0 - 1.0
    r2 = rx * rx + ry * ry
    r = xp.sqrt(r2 + 1e-20)
    # Same degenerate-center guard as shade_pallas._slot_ingredients:
    # arctan2's gradient at (0, 0) is 0/0 and uv == (0.5, 0.5) reaches it;
    # the select substitution leaves the forward unchanged.
    theta = xp.arctan2(ry, xp.where(r2 < 1e-24, 1.0, rx)) \
        + xp.sqrt(r) * (np.pi * SPIRAL_AMOUNT)
    sx = (r * xp.cos(theta) * 0.5 + 0.5)
    sy = (r * xp.sin(theta) * 0.5 + 0.5)

    o0 = perlin(sx * DISK_DENSITIES[0], sy * DISK_DENSITIES[0], xp)
    o1 = perlin(sx * DISK_DENSITIES[1] + 31.0, sy * DISK_DENSITIES[1] + 7.0, xp)
    o2 = perlin(sx * DISK_DENSITIES[2] + 101.0, sy * DISK_DENSITIES[2] + 53.0, xp)
    o3 = perlin(sx * DISK_DENSITIES[3] + 211.0, sy * DISK_DENSITIES[3] + 157.0, xp)
    m = 0.5 * o3 + 0.5 * o2
    m = 0.5 * m + 0.5 * o1
    m = 0.5 * m + 0.5 * o0
    return m


def disk_sample(u, v, xp=jnp):
    """RGBA of the procedural accretion texture at uv in [0,1]^2."""
    m = disk_texel_m(u, v, xp)
    return xp.stack([m, m, m, m], axis=-1)


# ---------------------------------------------------------------------------
# Blackbody tint: polynomial fit of the Planck locus (the colourtemp LUT)
# ---------------------------------------------------------------------------

_TINT_DEG = 10
_tint_coeffs_cache: dict = {}


def _tint_coeffs(temp: float = 15000.0) -> np.ndarray:
    """(3, deg+1) polynomial coefficients (highest power first) fitting
    tint(shift) = planck_rgb(temp * max(shift, 1e-3)) * sqrt(shift) on
    [0, 1] — the fixed-temperature row of the reference's colourtemp LUT
    (ray.wgsl:644-655 with T hard-coded to 15000 K)."""
    key = float(temp)
    if key not in _tint_coeffs_cache:
        from bhx.assets import planck_rgb

        s = np.linspace(0.0, 1.0, 512)
        rgb = planck_rgb(key * np.maximum(s, 1e-3)) * np.sqrt(s)[:, None]
        coeffs = np.stack(
            [np.polyfit(s, rgb[:, c], _TINT_DEG) for c in range(3)]
        ).astype(np.float32)
        _tint_coeffs_cache[key] = coeffs
    return _tint_coeffs_cache[key]


def blackbody_tint_channels(shift, temp: float = 15000.0, xp=jnp):
    """Per-channel (r, g, b) tint planes — the kernel-friendly variant
    (no trailing stack; shape-agnostic elementwise math)."""
    c = _tint_coeffs(temp)
    s = xp.clip(shift, 0.0, 1.0)
    out = []
    for ch in range(3):
        acc = xp.full_like(s, float(c[ch, 0]))
        for k in range(1, _TINT_DEG + 1):
            acc = acc * s + float(c[ch, k])
        out.append(xp.clip(acc, 0.0, 1.0))
    return tuple(out)


def blackbody_tint(shift, temp: float = 15000.0, xp=jnp):
    """RGB tint for a total red/blue shift factor in [0,1] (1 = unshifted).

    Horner evaluation of the per-channel fit — ~30 fma, no LUT gather.
    Max abs fit error vs the analytic curve < 0.01 over [0,1].
    """
    r, g, b = blackbody_tint_channels(shift, temp, xp)
    return xp.stack([r, g, b], axis=-1)


# ---------------------------------------------------------------------------
# Star-grid sky (radiance domain — the array path stores radiance^(1/4)
# and the renderer applies ^4; this sampler returns radiance directly)
# ---------------------------------------------------------------------------

SKY_CELLS_X = 256
SKY_CELLS_Y = 128
SKY_STAR_PROB = 0.22       # per-cell star probability at the equator
SKY_STAR_RADIUS_UV = 0.0024  # splat radius in uv units
NEBULA_TINT = (0.45, 0.35, 0.65)


def sky_radiance_channels(u, v, xp=jnp):
    """HDR sky radiance (r, g, b) planes at equirect uv in [0,1]^2.

    Stars live on a hash cell grid: each cell holds at most one star
    (presence ~ sin(theta) for uniform sphere density) with hash-derived
    sub-cell position, power-law brightness, and a blackbody color from
    the tint polynomial.  A sample sums the 3x3 neighbourhood with a
    quadratic splat — pure arithmetic, no gathers, no exp.  Channel-tuple
    form so the same code runs on blocks of rays inside Pallas kernels.
    """
    # --- nebula: two perlin octaves, tinted (matches the baked generator) ---
    neb = (
        perlin(u * 6.0, v * 3.0, xp) * 0.6
        + perlin(u * 24.0 + 91.0, v * 12.0 + 17.0, xp) * 0.4
    )
    neb = xp.maximum(neb - 0.35, 0.0) * 0.9
    out_r = neb * NEBULA_TINT[0]
    out_g = neb * NEBULA_TINT[1]
    out_b = neb * NEBULA_TINT[2]

    # --- star grid ---
    gx = u * SKY_CELLS_X
    gy = v * SKY_CELLS_Y
    cx0 = xp.floor(gx).astype(xp.int32)
    cy0 = xp.floor(gy).astype(xp.int32)
    # Row weight for uniform-on-sphere density: sin(pi * v).
    inv_r2 = 1.0 / (SKY_STAR_RADIUS_UV * SKY_STAR_RADIUS_UV)

    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            cx = cx0 + ox
            cy = cy0 + oy
            # wrap in x (equirect seam; CELLS_X is a power of two, so the
            # bitwise and is exact mod even for cx = -1), clamp rows
            cxw = cx & (SKY_CELLS_X - 1)
            row_ok = (cy >= 0) & (cy < SKY_CELLS_Y)
            h0 = hash01(cxw * 3 + 1, cy * 7 + 11, xp)
            h1 = hash01(cxw * 5 + 29, cy * 3 + 41, xp)
            h2 = hash01(cxw * 7 + 97, cy * 11 + 61, xp)
            h3 = hash01(cxw * 11 + 13, cy * 13 + 17, xp)
            cell_v = (cy.astype(xp.float32) + 0.5) / SKY_CELLS_Y
            sin_t = xp.sin(np.pi * xp.clip(cell_v, 0.0, 1.0))
            present = (h0 < SKY_STAR_PROB * sin_t) & row_ok
            # star uv inside the cell
            su = (cx.astype(xp.float32) + h1) / SKY_CELLS_X
            sv = (cy.astype(xp.float32) + h2) / SKY_CELLS_Y
            du = u - su
            dv = v - sv
            d2 = du * du + dv * dv
            # quadratic splat (exp-free): (1 - d^2/r^2)^2 clipped
            w = xp.maximum(1.0 - d2 * inv_r2, 0.0)
            w = w * w
            # power-law brightness (h3^8 tail) + floor; radiance domain,
            # max ~3.3 (the array path clips radiance at 4 before ^(1/4))
            h32 = h3 * h3
            h34 = h32 * h32
            bright = (h34 * h34) * 3.0 + 0.3
            amp = xp.where(present, w * bright, 0.0)
            # color: blackbody at T in [3000, 12000] K via the tint poly
            # (shift s = T / 15000 in [0.2, 0.8])
            s_shift = 0.2 + 0.6 * hash01(cxw * 17 + 23, cy * 19 + 5, xp)
            cr, cg, cb = blackbody_tint_channels(s_shift, xp=xp)
            out_r = out_r + amp * cr
            out_g = out_g + amp * cg
            out_b = out_b + amp * cb
    return out_r, out_g, out_b


def sky_radiance(u, v, xp=jnp):
    """HDR sky radiance at equirect uv in [0,1]^2 (stacked rgb)."""
    r, g, b = sky_radiance_channels(u, v, xp)
    return xp.stack([r, g, b], axis=-1)


def sky_radiance_dir(direction, xp=jnp):
    """Radiance for an escape direction (equirect mapping of sky.wgsl:20-22)."""
    from bhx.shading import sky_uv

    u, v = sky_uv(direction)
    return sky_radiance(u, v, xp)
