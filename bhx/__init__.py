"""bhx — differentiable black-hole renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
renderer ``cleggacus/bhusie`` (Rust + wgpu/WGSL real-time ray tracer):
per-pixel null-geodesic integration around a black hole,
accretion-disk shading with Doppler and gravitational red/blue shift, mesh
compositing through a "relativity sphere" with BVH acceleration, a
coarse-to-fine adaptive ray ladder, a star-map background, and a
bloom -> mix -> ACES -> FXAA post chain — all end-to-end differentiable and
shardable across device meshes.

Architecture (not a port — see SURVEY.md §7):
  bhx.physics    geodesic RHS + conserved quantities        (ray.wgsl:401-403)
  bhx.integrate  Euler / Cash-Karp RK45 steppers + march    (ray.wgsl:405-480)
  bhx.geometry   analytic hits, OBJ, BVH build+traverse     (ray.wgsl:287-363,
                                                             triangle.rs, model.rs)
  bhx.shading    disk / redshift / sky shading              (ray.wgsl:598-666)
  bhx.tracer     phase-decomposed ray tracer                (ray.wgsl:482-596)
  bhx.pipeline   ladder + post chain, jitted render()       (renderer/mod.rs)
  bhx.kernels    Pallas kernels (Triton route): march, shade, sky
  bhx.parallel   Mesh/shard_map tile sharding, train step
  bhx.assets     procedural disk/sky/blackbody assets       (perlin/src/main.rs)
"""

import os as _os


def enable_compile_cache(path: str | None = None) -> str | None:
    """Turn on JAX's persistent on-disk compilation cache.

    Full-pipeline graphs take tens of seconds each to compile; the cache
    makes repeated CLI/bench/script runs start warm.  An explicit opt-in
    called by bhx's own entry points (CLI, bench, viewer, chip_smoke.py,
    scripts) — importing the library never mutates process state.

    The directory is ``path`` if given, else ``JAX_COMPILATION_CACHE_DIR``
    if set (an empty value opts out), else ``.jax_cache`` at the root of
    this checkout.  The path is part of the cache key, so it is fixed.
    Returns the directory in use (None when opted out).  Idempotent.
    """
    if path is not None:
        cache = path
    else:
        cache = _os.environ.get("JAX_COMPILATION_CACHE_DIR", DEFAULT_CACHE_DIR)
    if not cache:
        return None
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    import jax as _jax

    # If jax was imported first, the env default was already captured.
    if _jax.config.jax_compilation_cache_dir != cache:
        _jax.config.update("jax_compilation_cache_dir", cache)
    return cache


DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)

from bhx.config import RenderConfig, FxaaConfig, LadderConfig, BloomConfig
from bhx.scene import Camera, BlackHole, Scene, Mesh
from bhx.pipeline import render, render_image, render_jit
from bhx.tracer import trace_rays

__version__ = "0.1.0"

__all__ = [
    "enable_compile_cache",
    "RenderConfig",
    "FxaaConfig",
    "LadderConfig",
    "BloomConfig",
    "Camera",
    "BlackHole",
    "Scene",
    "Mesh",
    "render",
    "render_image",
    "render_jit",
    "trace_rays",
]
