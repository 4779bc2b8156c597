"""Post-processing chain: bloom pyramid, mix, ACES tonemap, FXAA.

jnp re-implementations of the reference's raster post passes — the texture
DAG (renderer/mod.rs:219-321) collapses into function composition inside one
jitted graph, and every "textureSample" becomes a vectorized bilinear
gather.  Tap positions/weights match the WGSL shaders exactly:
bloom_down.wgsl (CoD 13-tap), bloom_up.wgsl (9-tap tent at fixed 0.005 uv
radius), mix.wgsl, hdr.wgsl (ACES), fxaa.wgsl (FXAA 3.11 quality).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

import functools

import numpy as np

from bhx.config import BloomConfig, FxaaConfig
from bhx.shading import aces_tonemap, sample_bilinear


def _sample_uv(img, u, v):
    """Clamp-addressed bilinear sample of (H, W, C) at uv arrays."""
    return sample_bilinear(img, u, v, wrap=False)


@functools.lru_cache(maxsize=256)
def _resample_matrix(src: int, out: int, taps: tuple) -> np.ndarray:
    """(out, src) matrix M with M @ v = multi-tap bilinear resample of v.

    Each output sample i reads source coordinate
    ``x = (i + 0.5) * src / out - 0.5 + off`` for every (off, w) in taps
    (off in *source texels*), bilinearly with clamp-to-edge — the exact
    math of a GPU linear sampler at uv offsets, but expressed as a dense
    matrix so a whole separable filter pass is one matmul instead of
    millions of gathers.
    """
    m = np.zeros((out, src), np.float32)
    for i in range(out):
        base = (i + 0.5) * src / out - 0.5
        for off, w in taps:
            x = base + off
            x0 = int(np.floor(x))
            f = x - x0
            m[i, min(max(x0, 0), src - 1)] += w * (1.0 - f)
            m[i, min(max(x0 + 1, 0), src - 1)] += w * f
    return m


def _separable_pass(chw, taps_y: tuple, taps_x: tuple, out_wh):
    """Apply a separable multi-tap bilinear filter via two matmuls.

    Operates channel-major ((C, H, W) in and out): with channels as the
    batch dim both contractions are well-shaped (out, src) x (src, other)
    matmuls (an (H, W, C) form makes the second one a per-row
    (q, w) x (w, 3) product).
    """
    out_w, out_h = out_wh
    src_h, src_w = chw.shape[1], chw.shape[2]
    my = jnp.asarray(_resample_matrix(src_h, out_h, taps_y))
    mx = jnp.asarray(_resample_matrix(src_w, out_w, taps_x))
    # Full float32 products: on a GPU a default-precision float32 dot may
    # run in TF32 (~3 decimal digits), which would put the bloom term off
    # the float32 reference by more than the golden-image tolerance.
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("ph,chw->cpw", my, chw, precision=hi)
    return jnp.einsum("qw,cpw->cpq", mx, tmp, precision=hi)


def _uv_grid(width: int, height: int):
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    uu, vv = jnp.meshgrid(u, v, indexing="xy")
    return uu, vv


def bloom_downsample(img, out_wh: Tuple[int, int]):
    """13-tap downsample (bloom_down.wgsl:40-59) to (out_w, out_h).
    Channel-major (C, H, W).

    The CoD 13-tap pattern decomposes into two separable groups —
    taps at {-2,0,+2}² texels with weights 0.5·[¼,½,¼]⊗[¼,½,¼]
    (0.03125 corners / 0.0625 edges / 0.125 center) plus taps at {-1,+1}²
    with weights 0.5·[½,½]⊗[½,½] (0.125 each) — so the whole pass is four
    matmuls instead of 52 gathers per output pixel.
    """
    group_a = ((-2.0, 0.25), (0.0, 0.5), (2.0, 0.25))
    group_b = ((-1.0, 0.5), (1.0, 0.5))
    half_a = _separable_pass(img, group_a, group_a, out_wh)
    half_b = _separable_pass(img, group_b, group_b, out_wh)
    return 0.5 * half_a + 0.5 * half_b


def bloom_upsample(img, out_wh: Tuple[int, int], radius_uv: float = 0.005):
    """9-tap tent upsample at fixed uv radius (bloom_up.wgsl:35-53).

    The 3x3 tent [1,2,1]⊗[1,2,1]/16 is separable; the fixed uv radius maps
    to (radius · source_size) texels per axis.  Channel-major (C, H, W).
    """
    src_h, src_w = img.shape[1], img.shape[2]
    taps_x = ((-radius_uv * src_w, 0.25), (0.0, 0.5), (radius_uv * src_w, 0.25))
    taps_y = ((-radius_uv * src_h, 0.25), (0.0, 0.5), (radius_uv * src_h, 0.25))
    return _separable_pass(img, taps_y, taps_x, out_wh)


def bloom_chain_chw(chw, cfg: BloomConfig):
    """5-down / 5-up pyramid on a channel-major (3, H, W) image — the
    native layout: all ten passes are batched matmuls and no
    transpose ever happens (reference res schedule renderer/mod.rs:219-256:
    res /= 2 five times then *= 2 five times, truncating to integers at
    each pass)."""
    h, w = chw.shape[1], chw.shape[2]
    # Cap the pyramid depth so no level degenerates below 1x1 (tiny debug
    # renders; the reference always runs at >= 59x33 bottom level).
    levels = max(0, min(cfg.levels, min(w, h).bit_length() - 1))
    fres = (float(w), float(h))
    cur = chw
    for _ in range(levels):
        fres = (fres[0] / 2.0, fres[1] / 2.0)
        cur = bloom_downsample(cur, (max(int(fres[0]), 1), max(int(fres[1]), 1)))
    for _ in range(levels):
        fres = (fres[0] * 2.0, fres[1] * 2.0)
        cur = bloom_upsample(
            cur, (max(int(fres[0]), 1), max(int(fres[1]), 1)), cfg.up_radius_uv
        )
    return cur


def bloom_chain(img, cfg: BloomConfig):
    """(H, W, C) wrapper of :func:`bloom_chain_chw` (one moveaxis in/out)."""
    return jnp.moveaxis(bloom_chain_chw(jnp.moveaxis(img, -1, 0), cfg), 0, -1)


def mix_pass(scene_img, bloom_img, mix_ratio: float):
    """final = ratio * scene + (1 - ratio) * bloom (mix.wgsl:32-35).
    Elementwise — layout-agnostic ((H, W, C) or (C, H, W))."""
    return mix_ratio * scene_img + (1.0 - mix_ratio) * bloom_img


def tonemap_pass(img, channel_major: bool = False):
    return aces_tonemap(img, channel_major=channel_major)


# ---------------------------------------------------------------------------
# FXAA 3.11 (quality) — vectorized port of fxaa.wgsl
# ---------------------------------------------------------------------------

_QUALITY = [1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0]


def _quality(i: int) -> float:
    return _QUALITY[i] if i < len(_QUALITY) else 8.0


def _luma(rgb):
    # + 1e-12 under the sqrt: sqrt'(0) is infinite, and exact-black pixels
    # (the shadow interior) are common — without the epsilon every such
    # pixel turns the whole backward pass NaN via the inf * 0 of its
    # no-edge mask (discovered by the 1080p GRAD_CONFIG4 run).  Forward
    # change <= 1e-6.
    return jnp.sqrt(
        jnp.clip(rgb @ jnp.array([0.299, 0.587, 0.114]), 0.0, None) + 1e-12
    )


def _shift(a, dy: int, dx: int):
    """Clamp-to-edge neighbor fetch for a (H, W) array.

    Shifts are clamped to the array extent (a shift past the edge reads
    the edge row/column everywhere) — FXAA's walk distances can exceed a
    tiny debug image's size."""
    dy = max(min(dy, a.shape[0] - 1), 1 - a.shape[0])
    dx = max(min(dx, a.shape[1] - 1), 1 - a.shape[1])
    if dy > 0:
        a = jnp.concatenate([a[dy:], jnp.repeat(a[-1:], dy, axis=0)], axis=0)
    elif dy < 0:
        a = jnp.concatenate([jnp.repeat(a[:1], -dy, axis=0), a[:dy]], axis=0)
    if dx > 0:
        a = jnp.concatenate([a[:, dx:], jnp.repeat(a[:, -1:], dx, axis=1)], axis=1)
    elif dx < 0:
        a = jnp.concatenate([jnp.repeat(a[:, :1], -dx, axis=1), a[:, :dx]], axis=1)
    return a


def fxaa_pass_chw(chw, cfg: FxaaConfig):
    """FXAA 3.11 quality AA (fxaa.wgsl:40-200), fully vectorized, on a
    channel-major (3, H, W) image (the pipeline's native layout — every
    stencil op runs on full-width (H, W) planes).

    The WGSL offset convention has +1 row = "up": its `lumaUp` samples
    offset (0, +1) in texel space.  We keep that naming — "up" here means
    +row; the algorithm is symmetric so orientation is immaterial.
    """
    rp, gp, bp = chw[0], chw[1], chw[2]
    hgt, wdt = rp.shape[0], rp.shape[1]
    inv_w, inv_h = 1.0 / wdt, 1.0 / hgt
    # + 1e-12 under the sqrt: sqrt'(0) is infinite at the exact-black
    # pixels of the shadow interior, and the inf gradient times the
    # no-edge mask's zero is NaN — one black pixel NaN-poisons the whole
    # backward image (discovered by the 1080p GRAD_CONFIG4 run; the
    # forward is unchanged to ~1e-6).
    luma_img = jnp.sqrt(
        jnp.clip(0.299 * rp + 0.587 * gp + 0.114 * bp, 0.0, None) + 1e-12
    )

    l_c = luma_img
    l_down = _shift(luma_img, -1, 0)
    l_up = _shift(luma_img, +1, 0)
    l_left = _shift(luma_img, 0, -1)
    l_right = _shift(luma_img, 0, +1)

    l_min = jnp.minimum(l_c, jnp.minimum(jnp.minimum(l_down, l_up), jnp.minimum(l_left, l_right)))
    l_max = jnp.maximum(l_c, jnp.maximum(jnp.maximum(l_down, l_up), jnp.maximum(l_left, l_right)))
    l_range = l_max - l_min
    no_edge = l_range < jnp.maximum(cfg.edge_threshold_min, l_max * cfg.edge_threshold_max)

    l_dl = _shift(luma_img, -1, -1)
    l_ur = _shift(luma_img, +1, +1)
    l_ul = _shift(luma_img, +1, -1)
    l_dr = _shift(luma_img, -1, +1)

    l_du = l_down + l_up
    l_lr = l_left + l_right
    l_lc = l_dl + l_ul
    l_dc = l_dl + l_dr
    l_rc = l_dr + l_ur
    l_uc = l_ur + l_ul

    edge_h = (
        jnp.abs(-2.0 * l_left + l_lc)
        + jnp.abs(-2.0 * l_c + l_du) * 2.0
        + jnp.abs(-2.0 * l_right + l_rc)
    )
    edge_v = (
        jnp.abs(-2.0 * l_up + l_uc)
        + jnp.abs(-2.0 * l_c + l_lr) * 2.0
        + jnp.abs(-2.0 * l_down + l_dc)
    )
    is_horizontal = edge_h >= edge_v

    step_len = jnp.where(is_horizontal, inv_h, inv_w)
    luma1 = jnp.where(is_horizontal, l_down, l_left)
    luma2 = jnp.where(is_horizontal, l_up, l_right)
    grad1 = luma1 - l_c
    grad2 = luma2 - l_c
    is1 = jnp.abs(grad1) >= jnp.abs(grad2)
    grad_scaled = 0.25 * jnp.maximum(jnp.abs(grad1), jnp.abs(grad2))
    step_len = jnp.where(is1, -step_len, step_len)
    l_avg = jnp.where(is1, 0.5 * (luma1 + l_c), 0.5 * (luma2 + l_c))

    # --- edge walk: fixed-schedule shifts, ZERO gathers -----------------
    # Two observations turn the data-dependent walk into pure stencil ops:
    #
    # 1. Every walk sample sits half a texel off-axis (currentUv ± 0.5·step
    #    perpendicular, fxaa.wgsl:110-116), i.e. it is exactly the average
    #    of two adjacent texels — precompute those as "pair images" of
    #    luma (rows for horizontal edges, columns for vertical).
    #    (Divergence note: the reference lumas the bilinear rgb sample; we
    #    bilinearly blend per-texel lumas — sub-1e-2 on the walk values.)
    # 2. The walk advances by the fixed QUALITY schedule, so every pixel
    #    still walking at iteration i sits at the SAME distance D_i =
    #    2 + sum(quality[2..i-1]) from its center: a sample is a *fixed
    #    shift* of the pair image (half-texel D -> mean of two shifts),
    #    never a gather.  Only *whether* a pixel samples is data-dependent,
    #    and that is a lane mask.
    pair_v = 0.5 * (luma_img + _shift(luma_img, +1, 0))  # rows y, y+1
    pair_h = 0.5 * (luma_img + _shift(luma_img, 0, +1))  # cols x, x+1
    is1_i = is1.astype(jnp.int32)

    # The pair at (perp-1, perp) vs (perp, perp+1) per step_len sign:
    # shifting the pair image by -1 perpendicular converts one to the other.
    pv = jnp.where(is1, _shift(pair_v, -1, 0), pair_v)
    ph = jnp.where(is1, _shift(pair_h, 0, -1), pair_h)

    # Every fractional distance in the QUALITY schedule ends in .5, and a
    # shift commutes with an elementwise blend:
    #   (1-f)*shift(p, off) + f*shift(p, off+s) = shift(blend_f(p, s), off)
    # so ONE pre-blended half-texel plane per (orientation, sign) serves
    # every fractional sample — 2 shifted-plane fetches instead of 4
    # (~28 fewer full-frame HBM passes per frame at iterations=12).
    half = {
        (+1): (0.5 * (pv + _shift(pv, 0, +1)), 0.5 * (ph + _shift(ph, +1, 0))),
        (-1): (0.5 * (pv + _shift(pv, 0, -1)), 0.5 * (ph + _shift(ph, -1, 0))),
    }

    def sample_at(dist: float, sign: int):
        """Pair-image value at signed walk distance `dist` (texels) from the
        pixel center, for both orientations, as shifted images."""
        lo = int(np.floor(dist))
        f = dist - lo
        off = sign * lo
        # horizontal edges walk along x; vertical along y
        if f == 0.0:
            h0 = _shift(pv, 0, off)
            v0 = _shift(ph, off, 0)
        elif f == 0.5:
            hp, vp = half[sign]
            h0 = _shift(hp, 0, off)
            v0 = _shift(vp, off, 0)
        else:  # pragma: no cover - QUALITY schedule only produces .0/.5
            h0 = _shift(pv, 0, off) * (1.0 - f) + _shift(pv, 0, off + sign) * f
            v0 = _shift(ph, off, 0) * (1.0 - f) + _shift(ph, off + sign, 0) * f
        return jnp.where(is_horizontal, h0, v0)

    # Static distance schedule (prefix sums of the QUALITY table).
    dists = [1.0, 2.0]
    for i in range(2, max(cfg.iterations, 2)):
        dists.append(dists[-1] + _quality(i))

    le1 = sample_at(dists[0], -1) - l_avg
    le2 = sample_at(dists[0], +1) - l_avg
    reached1 = jnp.abs(le1) >= grad_scaled
    reached2 = jnp.abs(le2) >= grad_scaled
    p1 = jnp.where(reached1, dists[0], dists[1])
    p2 = jnp.where(reached2, dists[0], dists[1])

    for i in range(2, cfg.iterations):
        both = reached1 & reached2
        le1 = jnp.where(reached1, le1, sample_at(dists[i - 1], -1) - l_avg)
        le2 = jnp.where(reached2, le2, sample_at(dists[i - 1], +1) - l_avg)
        new_r1 = jnp.abs(le1) >= grad_scaled
        new_r2 = jnp.abs(le2) >= grad_scaled
        adv1 = ~both & ~new_r1
        adv2 = ~both & ~new_r2
        p1 = jnp.where(adv1, dists[i], p1)
        p2 = jnp.where(adv2, dists[i], p2)
        reached1 = reached1 | new_r1
        reached2 = reached2 | new_r2

    # Distances along the WALK axis (fxaa.wgsl:163-164: x for horizontal
    # edges, y for vertical), converted back to uv units.
    unit = jnp.where(is_horizontal, inv_w, inv_h)
    dist1 = p1 * unit
    dist2 = p2 * unit
    is_dir1 = dist1 < dist2
    dist_final = jnp.minimum(dist1, dist2)
    edge_thickness = dist1 + dist2
    center_smaller = l_c < l_avg
    good1 = (le1 < 0.0) != center_smaller
    good2 = (le2 < 0.0) != center_smaller
    good = jnp.where(is_dir1, good1, good2)
    pixel_offset = -dist_final / jnp.where(edge_thickness == 0.0, 1e-12, edge_thickness) + 0.5
    final_offset = jnp.where(good, pixel_offset, 0.0)

    l_full_avg = (1.0 / 12.0) * (2.0 * (l_du + l_lr) + l_lc + l_rc)
    # Denominator clamped to the edge threshold: every pixel with
    # l_range below it is fully no-edge-masked anyway, so edge pixels are
    # EXACT, while the old 1e-12 fallback amplified float-noise gradients
    # by ~1e12 on flat regions (backward-stability hazard).
    sub1 = jnp.clip(
        jnp.abs(l_full_avg - l_c)
        / jnp.maximum(l_range, cfg.edge_threshold_min),
        0.0, 1.0,
    )
    sub2 = (-2.0 * sub1 + 3.0) * sub1 * sub1
    sub_final = sub2 * sub2 * cfg.subpixel_quality
    final_offset = jnp.maximum(final_offset, sub_final)

    # Final resample: a sub-texel shift (|t| < 1) along the perpendicular
    # axis only — a 2-texel lerp via shifted planes, no gather
    # (fxaa.wgsl:191-198).
    #
    # The blend weight is a FILTER DECISION, not radiance: under
    # differentiation it is frozen (stop_gradient) and gradients flow
    # through the resampled colors only — same stance as the march's
    # "masks don't differentiate" (march_grad).  Differentiating t is
    # both ill-posed (the edge walk snaps to a static distance schedule,
    # so most of t is piecewise-constant) and numerically hostile: the
    # smooth sub-pixel term runs through luma = sqrt(...), whose slope at
    # the shadow's near-black pixels is ~1/(2 sqrt(eps)) — the 1080p
    # GRAD_CONFIG4 run measured AD 10x FD from exactly that term.
    t = jax.lax.stop_gradient(final_offset)

    def resample(chan):
        nb_h = jnp.where(is1, _shift(chan, -1, 0), _shift(chan, +1, 0))
        nb_v = jnp.where(is1, _shift(chan, 0, -1), _shift(chan, 0, +1))
        neighbor = jnp.where(is_horizontal, nb_h, nb_v)
        out = chan * (1.0 - t) + neighbor * t
        return jnp.where(no_edge, chan, out)

    return jnp.stack([resample(c) for c in (rp, gp, bp)])


def fxaa_pass(img, cfg: FxaaConfig):
    """(H, W, 3) wrapper of :func:`fxaa_pass_chw`."""
    return jnp.moveaxis(
        fxaa_pass_chw(jnp.moveaxis(img, -1, 0), cfg), 0, -1
    )
