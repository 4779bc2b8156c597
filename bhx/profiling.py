"""Timing, rays/s counters, and profiler hooks.

The reference's only observability is a UI fps label (ui/mod.rs:72-83,153);
here: structured per-pass timing via block_until_ready, Mrays/s counters,
and optional jax.profiler traces (SURVEY.md §5 "Tracing / profiling").
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import jax


class Timer:
    """dt + total elapsed (reference src/timer.rs:20-33)."""

    def __init__(self):
        self.start = time.perf_counter()
        self.last = self.start

    def update(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        return dt

    def total(self) -> float:
        return time.perf_counter() - self.start


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw) -> Dict:
    """Wall-time a jitted function with proper device sync.

    Returns {mean_s, min_s, runs}.  The first `warmup` calls (compile) are
    excluded.
    """
    for _ in range(warmup):
        out = fn(*args, **kw)
        jax.block_until_ready(out)
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        runs.append(time.perf_counter() - t0)
    return {"mean_s": sum(runs) / len(runs), "min_s": min(runs), "runs": runs}


def mrays_per_sec(num_rays: int, seconds: float) -> float:
    return num_rays / seconds / 1e6


def frame_report(scene, cfg, iters: int = 4) -> Dict:
    """Stage-level timing of one frame of the given scene/config — the
    supported API behind scripts/profile_stages.py: ladder levels, sky
    finalize, bloom, mix+tonemap, FXAA, and the fused full frame, each
    jitted separately and timed (best of ``iters``) with
    ``jax.block_until_ready``.  Returns {stage: ms} plus device info.
    """
    import jax.numpy as jnp

    from bhx.pipeline import (
        _refine_level,
        ladder_trace_rows,
        render,
        trace_image_record_rows,
    )
    from bhx.post import bloom_chain_chw, fxaa_pass_chw, mix_pass, tonemap_pass

    def timed(fn, *args):
        return time_fn(fn, *args, warmup=2, iters=iters)["min_s"]

    dev = jax.devices()[0]
    report: Dict = {"platform": dev.platform, "device": dev.device_kind}

    def add(label, t):
        report[label] = t * 1e3

    if cfg.use_ladder:
        lad = cfg.ladder_for_output()
        w0, h0 = lad.resolution(0)
        f0 = jax.jit(lambda s: trace_image_record_rows(s, cfg, w0, h0))
        add("L0 trace", timed(f0, scene))
        rows = f0(scene)
        for lvl in range(1, lad.levels):
            w, h = lad.resolution(lvl)
            f = jax.jit(
                lambda prev, s, w=w, h=h: _refine_level(prev, s, cfg, w, h)
            )
            add(f"L{lvl} refine {w}x{h}", timed(f, rows, scene))
            rows = f(rows, scene)
        f = jax.jit(lambda s: ladder_trace_rows(s, cfg))
        add("ladder total", timed(f, scene))
    else:
        f = jax.jit(
            lambda s: trace_image_record_rows(s, cfg, cfg.width, cfg.height)
        )
        add("dense trace", timed(f, scene))
        rows = f(scene)

    from bhx.tracer import finalize_image_rows

    def skyf(rows):
        return jnp.stack(finalize_image_rows(
            rows, scene.sky_texture, cfg.show_sky, cfg.texture_mode
        ))

    f = jax.jit(skyf)
    add("sky finalize", timed(f, rows))
    rgb = f(rows)[:, :cfg.height, :cfg.width]

    if cfg.bloom.enabled:
        f = jax.jit(lambda x: bloom_chain_chw(x, cfg.bloom))
        add("bloom", timed(f, rgb))
        bl = f(rgb)
        f = jax.jit(lambda x, b: tonemap_pass(
            mix_pass(x, b, cfg.bloom.mix_ratio), channel_major=True))
        add("mix+tonemap", timed(f, rgb, bl))
        rgb = f(rgb, bl)
    if cfg.fxaa.enabled:
        f = jax.jit(lambda x: fxaa_pass_chw(x, cfg.fxaa))
        add("fxaa", timed(f, rgb))

    f = jax.jit(lambda s: render(s, cfg))
    t_frame = timed(f, scene)
    add("full frame", t_frame)
    report["mrays_per_s"] = cfg.width * cfg.height / t_frame / 1e6
    return report


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """jax.profiler trace context (view with XProf/TensorBoard)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
