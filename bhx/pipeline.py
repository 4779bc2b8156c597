"""The jitted render pipeline: adaptive ray ladder + sky + post chain.

Replaces the reference's static texture DAG (renderer/mod.rs:170-321, one
wgpu pipeline per pass) with a single jitted function:

    ladder trace -> sky pass -> bloom pyramid -> mix -> ACES -> FXAA

The reference's coarse-to-fine "adaptive grid" (ray.wgsl:167-243) decides
per fine pixel whether to copy a coarse pixel, interpolate escape
directions, or re-trace.  Its per-pixel branch becomes a masked dense
retrace (SURVEY.md §7 hard part 4): the whole level is traced with the
needs-trace set as the initial active mask; the march kernel's per-lane
activity mask skips dead rays, so traced work is proportional to the
needs count while every shape stays static and the level is a single
pipeline invocation.

Layout: the record travels as 8 per-channel PLANES ((H, W) each) and the
post chain as a channel-major (3, H, W) image — structure-of-arrays
end-to-end: the Pallas kernels consume rows, so every kernel boundary is
a free reshape and no interleave/deinterleave is ever built.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from bhx.config import RenderConfig
from bhx.post import bloom_chain_chw, fxaa_pass_chw, mix_pass, tonemap_pass
from bhx.scene import Scene
from bhx.shading import sample_sky
from bhx.tracer import (
    camera_rays,
    finalize_image_rows,
    trace_rays_record_rows,
)

# Record row indices (see bhx.tracer REC_*): rows 0-2 color, 3 alpha,
# 4 amount, 5-7 dir.
_R_ALPHA = 3
_R_AMOUNT = 4
_R_DIR = (5, 6, 7)


def sky_pass(img4, sky_tex, texture_mode: str = "array"):
    """Convert escape-encoded pixels (alpha 0, rgb = direction) to sky
    color; pass hit pixels through (reference sky.wgsl:17-29)."""
    alpha = img4[..., 3]
    sky = sample_sky(sky_tex, img4[..., :3], texture_mode)
    rgb = jnp.where(alpha[..., None] == 0.0, sky, img4[..., :3])
    return rgb


def _dirs_aligned_ch(a, b, cos_thresh: float):
    """angle(a, b) < acos(cos_thresh) for component-plane triples a, b —
    a dot-product compare (cos is strictly decreasing on [0, pi], so no
    arccos transcendental per pair per pixel)."""
    dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    n2 = (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]) * (
        b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    )
    return dot > cos_thresh * jnp.sqrt(jnp.maximum(n2, 1e-24))


def _refine_masks(prev_rows, cfg: RenderConfig, width: int, height: int):
    """The ladder's per-fine-pixel decision (reference ray.wgsl:183-241):
    returns (needs, known) where ``known`` is the 8-plane record of every
    pixel that does NOT need tracing (coarse copy or interpolated escape)
    and ``needs`` the (H, W) retrace mask."""
    m = cfg.ladder.multiplier
    xs = jnp.arange(width)
    ys = jnp.arange(height)
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")  # (H, W)

    tx = gx // m
    ty = gy // m
    exact = ((gx % m) == 0) & ((gy % m) == 0)

    # The 4 coarse neighbours as nearest-upsamples of (shifted) planes:
    # c_tl[yf, xf] = prev[yf//m, xf//m] is a repeat, and the +1 neighbours
    # are repeats of edge-clamped shifts — pure stencil ops per plane, no
    # gathers, full lane utilization.
    def up(img):
        r = jnp.repeat(jnp.repeat(img, m, axis=0), m, axis=1)
        return r[:height, :width]

    def sh_x(p):
        return jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)

    def sh_y(p):
        return jnp.concatenate([p[1:], p[-1:]], axis=0)

    # The interpolate-vs-trace decision depends only on the 4 coarse
    # neighbours, i.e. it is CONSTANT over each m x m fine cell — so the
    # alignment / all-escape tests run at COARSE resolution (m^2 = 9x
    # fewer elements) and only the final boolean is upsampled, instead of
    # evaluating ~50 plane ops at full resolution.
    ct = math.cos(cfg.angle_division_threshold)
    a_c = prev_rows[_R_ALPHA]
    d_c = tuple(prev_rows[i] for i in _R_DIR)
    trd_c = tuple(sh_x(p) for p in d_c)
    bld_c = tuple(sh_y(p) for p in d_c)
    brd_c = tuple(sh_x(sh_y(p)) for p in d_c)
    aligned_c = (
        _dirs_aligned_ch(bld_c, d_c, ct)
        & _dirs_aligned_ch(brd_c, trd_c, ct)
        & _dirs_aligned_ch(d_c, trd_c, ct)
        & _dirs_aligned_ch(bld_c, brd_c, ct)
    )
    all_escape_c = (
        (a_c == 0.0) & (sh_x(a_c) == 0.0) & (sh_y(a_c) == 0.0)
        & (sh_x(sh_y(a_c)) == 0.0)
    )
    can_interp = up(aligned_c & all_escape_c)

    # Full-res planes still needed: the TL record (copy-through + interp
    # base) and the 3 non-TL direction neighbours (bilinear interp).
    tl = tuple(up(p) for p in prev_rows)
    tr_d = tuple(up(p) for p in trd_c)
    bl_d = tuple(up(p) for p in bld_c)
    br_d = tuple(up(p) for p in brd_c)
    tl_d = tuple(tl[i] for i in _R_DIR)

    fx = gx / m - tx
    fy = gy / m - ty
    dir_interp = tuple(
        (tl_d[i] * (1 - fx) + tr_d[i] * fx) * (1 - fy)
        + (bl_d[i] * (1 - fx) + br_d[i] * fx) * fy
        for i in range(3)
    )

    # known = exact ? coarse copy : interpolated-escape record
    # (no color, alpha 0, full transmission).
    zeros = jnp.zeros_like(fx)
    ones = jnp.ones_like(fx)
    known = (
        jnp.where(exact, tl[0], zeros),
        jnp.where(exact, tl[1], zeros),
        jnp.where(exact, tl[2], zeros),
        jnp.where(exact, tl[3], zeros),
        jnp.where(exact, tl[4], ones),
        jnp.where(exact, tl[5], dir_interp[0]),
        jnp.where(exact, tl[6], dir_interp[1]),
        jnp.where(exact, tl[7], dir_interp[2]),
    )
    needs = ~exact & ~can_interp
    return needs, known


def _refine_level(prev_rows, scene: Scene, cfg: RenderConfig, width: int,
                  height: int):
    """One ladder refinement step (reference ray.wgsl:183-241) on record
    planes.

    Every multiplier-th pixel copies the coarse value; in-between pixels
    whose 4 coarse neighbours are all escapes (alpha 0) with mutually
    aligned directions get a bilinearly interpolated direction; the rest
    are re-traced with the needs mask as the march's initial active set.
    """
    o, d = camera_rays(scene.camera, width, height)
    needs, known = _refine_masks(prev_rows, cfg, width, height)

    # --- masked dense retrace ---
    # Trace the whole level with the needs mask as the initial active set:
    # dead lanes stream through the march kernel untouched (its while cond
    # votes per block), so traced work tracks the needs count while every
    # shape stays static and the level is one pipeline invocation.
    needs_flat = needs.reshape(-1)
    res = trace_rays_record_rows(
        o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, active=needs_flat
    )
    return tuple(
        jnp.where(needs_flat, r, k.reshape(-1)).reshape(height, width)
        for r, k in zip(res, known)
    )


def trace_image_record_rows(scene: Scene, cfg: RenderConfig, width: int,
                            height: int, rounds=None):
    """Dense sky-free record planes: 8 rows of shape (height, width)."""
    from bhx.tracer import DEFAULT_ROUNDS

    o, d = camera_rays(scene.camera, width, height)
    rows = trace_rays_record_rows(
        o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg,
        rounds if rounds is not None else DEFAULT_ROUNDS,
    )
    return tuple(r.reshape(height, width) for r in rows)


def ladder_trace_rows(scene: Scene, cfg: RenderConfig):
    """Full coarse-to-fine trace at the ladder's final resolution.

    Operates on sky-free record planes (8 x (H, W)); the caller finalizes
    sky exactly once on the last level.
    """
    lad = cfg.ladder_for_output()
    w0, h0 = lad.resolution(0)
    rows = trace_image_record_rows(scene, cfg, w0, h0)
    for lvl in range(1, lad.levels):
        w, h = lad.resolution(lvl)
        rows = _refine_level(rows, scene, cfg, w, h)
    return rows


def ladder_trace(scene: Scene, cfg: RenderConfig):
    """Interleaved (H, W, 8) wrapper of :func:`ladder_trace_rows`."""
    return jnp.stack(ladder_trace_rows(scene, cfg), axis=-1)


def render(scene: Scene, cfg: RenderConfig = RenderConfig()):
    """Render the scene to a (height, width, 3) float image in [0, 1].

    The whole frame — ladder, sky, bloom, mix, tonemap, FXAA — is one
    traceable function: jit it (or take its grad in dense mode) directly.
    """
    if cfg.use_ladder and cfg.march_mode != "diff":
        rows = ladder_trace_rows(scene, cfg)
        lw, lh = cfg.ladder_for_output().final_resolution
        # Center-crop the ladder overshoot down to the requested output.
        x0 = (lw - cfg.width) // 2
        y0 = (lh - cfg.height) // 2
        rows = tuple(
            r[y0:y0 + cfg.height, x0:x0 + cfg.width] for r in rows
        )
    else:
        rows = trace_image_record_rows(scene, cfg, cfg.width, cfg.height)

    # ONE sky pass for the whole frame (hit pixels' residual transmission
    # and escapes' full sky in the same formula).
    chw = jnp.stack(finalize_image_rows(
        rows, scene.sky_texture, cfg.show_sky, cfg.texture_mode
    ))

    # Post chain, channel-major (3, H, W): elementwise ops get lanes from
    # W and the bloom matmuls batch over channels.
    if cfg.bloom.enabled:
        bloom = bloom_chain_chw(chw, cfg.bloom)
        chw = mix_pass(chw, bloom, cfg.bloom.mix_ratio)
    if cfg.tonemap:
        chw = tonemap_pass(chw, channel_major=True)
    if cfg.fxaa.enabled:
        chw = fxaa_pass_chw(chw, cfg.fxaa)
    return jnp.moveaxis(chw, 0, -1)


@partial(jax.jit, static_argnames=("cfg",))
def render_jit(scene: Scene, cfg: RenderConfig):
    return render(scene, cfg)


def render_image(scene: Scene, cfg: RenderConfig = RenderConfig()):
    """Render and convert to uint8 (host-side helper)."""
    import numpy as np

    rgb = np.asarray(render_jit(scene, cfg))
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype("uint8")


def render_tiled(
    scene: Scene,
    cfg: RenderConfig,
    band_rows: int = 256,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    max_retries: int = 2,
):
    """Giant-frame render in row bands with resumable checkpoints.

    For frames too large (or too long-running) for one device invocation:
    the dense trace runs band by band; after each band the accumulated
    alpha-encoded image is written to ``checkpoint_path`` (.npz) so an
    interrupted render resumes where it stopped (SURVEY.md §5
    "Checkpoint / resume" — the reference has none).  The post chain runs
    once at the end on the assembled frame.

    Failure recovery (SURVEY.md §5 "Failure detection"; the reference's
    only analogue is surface-loss retry, app.rs:119-125): each band is
    idempotent, so a transient device/runtime failure is retried up to
    ``max_retries`` times before the exception propagates — and because
    completed bands are already checkpointed, even a propagated failure
    loses at most the failing band.
    """
    import os

    import numpy as np

    from bhx.tracer import camera_rays, finalize_image, trace_rays_record

    h, w = cfg.height, cfg.width
    rec_np = np.zeros((h, w, 8), np.float32)
    start_band = 0
    n_bands = -(-h // band_rows)
    if checkpoint_path and os.path.exists(checkpoint_path):
        z = np.load(checkpoint_path)
        if tuple(z["shape"]) == (h, w) and int(z["band_rows"]) == band_rows:
            rec_np = z["rec"]
            start_band = int(z["next_band"])

    o, d = camera_rays(scene.camera, w, h)

    @partial(jax.jit, static_argnames=("cfg",))
    def trace_band(o, d, scene, cfg):
        return trace_rays_record(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg)

    for band in range(start_band, n_bands):
        y0 = band * band_rows
        y1 = min(y0 + band_rows, h)
        rows = y1 - y0
        # Anchor the last band so every trace has one compiled shape.
        s0 = min(y0, max(h - band_rows, 0))
        ob = o[s0:s0 + band_rows]
        db = d[s0:s0 + band_rows]
        for attempt in range(max_retries + 1):
            try:
                out = np.asarray(
                    trace_band(ob, db, scene, cfg)
                ).reshape(band_rows, w, 8)
                break
            except Exception as e:  # bounded retry; band is idempotent
                if attempt == max_retries:
                    raise RuntimeError(
                        f"band {band + 1}/{n_bands} failed after "
                        f"{max_retries + 1} attempts"
                        + (
                            f" (progress saved to {checkpoint_path};"
                            " re-run to resume)"
                            if checkpoint_path
                            else ""
                        )
                    ) from e
                if verbose:
                    print(f"band {band + 1}/{n_bands} attempt "
                          f"{attempt + 1} failed ({e!r}); retrying")
        rec_np[y0:y1] = out[band_rows - rows:]
        if checkpoint_path:
            np.savez_compressed(
                checkpoint_path + ".tmp.npz", rec=rec_np,
                next_band=band + 1, shape=(h, w), band_rows=band_rows,
            )
            os.replace(checkpoint_path + ".tmp.npz", checkpoint_path)
        if verbose:
            print(f"band {band + 1}/{n_bands} done")

    rec = jnp.asarray(rec_np)
    rgb = finalize_image(rec, scene.sky_texture, cfg.show_sky, cfg.texture_mode)
    chw = jnp.moveaxis(rgb, -1, 0)
    if cfg.bloom.enabled:
        chw = mix_pass(chw, bloom_chain_chw(chw, cfg.bloom), cfg.bloom.mix_ratio)
    if cfg.tonemap:
        chw = tonemap_pass(chw, channel_major=True)
    if cfg.fxaa.enabled:
        chw = fxaa_pass_chw(chw, cfg.fxaa)
    return jnp.moveaxis(chw, 0, -1)
