"""Static render configuration.

Every interactive setting of the reference UI (src/ui/render_settings.rs,
black_hole_settings.rs, camera_settings.rs, model_settings.rs) and every
compile-time constant of the reference renderer (src/renderer/mod.rs:116-321,
src/renderer/shaders/ray.wgsl) becomes a field here.

These dataclasses are *static* configuration: they select code paths and
shapes, so they are hashable and passed as static arguments to jit.  All
*differentiable / traced* quantities (camera pose, black-hole parameters,
disk texture, ...) live in :mod:`bhx.scene` pytrees instead.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Integrator(enum.Enum):
    """Geodesic integrator selection (reference ray.wgsl:525-531)."""

    EULER = 0
    RK45 = 1


class FxaaPreset(enum.Enum):
    """Edge-threshold presets (reference src/renderer/pipelines/fxaa_pipline.rs:25-67)."""

    ULTRA = 0
    HIGH = 1
    MEDIUM = 2
    LOW = 3
    EXTREME = 4


# Threshold tables mirror fxaa_pipline.rs:25-67 (EdgeThresholdMin / EdgeThreshold).
_EDGE_THRESHOLD_MIN = {
    FxaaPreset.ULTRA: 0.0833,
    FxaaPreset.HIGH: 0.0625,
    FxaaPreset.MEDIUM: 0.0312,
    FxaaPreset.LOW: 0.0156,
    FxaaPreset.EXTREME: 0.0078,
}
_EDGE_THRESHOLD_MAX = {
    FxaaPreset.ULTRA: 0.250,
    FxaaPreset.HIGH: 0.166,
    FxaaPreset.MEDIUM: 0.125,
    FxaaPreset.LOW: 0.063,
    FxaaPreset.EXTREME: 0.031,
}


@dataclasses.dataclass(frozen=True)
class FxaaConfig:
    """FXAA 3.11 quality settings (reference fxaa.wgsl + fxaa_pipline.rs:69-92)."""

    enabled: bool = True
    edge_threshold_min: float = _EDGE_THRESHOLD_MIN[FxaaPreset.ULTRA]
    edge_threshold_max: float = _EDGE_THRESHOLD_MAX[FxaaPreset.ULTRA]
    iterations: int = 12
    subpixel_quality: float = 0.75

    @staticmethod
    def from_presets(
        min_preset: FxaaPreset = FxaaPreset.ULTRA,
        max_preset: FxaaPreset = FxaaPreset.ULTRA,
        iterations: int = 12,
        subpixel_quality: float = 0.75,
        enabled: bool = True,
    ) -> "FxaaConfig":
        return FxaaConfig(
            enabled=enabled,
            edge_threshold_min=_EDGE_THRESHOLD_MIN[min_preset],
            edge_threshold_max=_EDGE_THRESHOLD_MAX[max_preset],
            iterations=iterations,
            subpixel_quality=subpixel_quality,
        )


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Coarse-to-fine adaptive ray grid (reference src/renderer/mod.rs:170-207).

    Level ``k`` has resolution ``base * multiplier^k - (multiplier^k - 1)``
    per axis, i.e. ``next = multiplier * cur - (multiplier - 1)`` so that every
    ``multiplier``-th fine pixel lands exactly on a coarse pixel.  The shipped
    reference config is base (72, 41), multiplier 3, 4 levels -> 1918 x 1081.
    """

    base: Tuple[int, int] = (72, 41)  # (width, height)
    multiplier: int = 3
    levels: int = 4

    def resolution(self, level: int) -> Tuple[int, int]:
        w, h = self.base
        for _ in range(level):
            w = self.multiplier * w - (self.multiplier - 1)
            h = self.multiplier * h - (self.multiplier - 1)
        return (w, h)

    @property
    def final_resolution(self) -> Tuple[int, int]:
        return self.resolution(self.levels - 1)

    @staticmethod
    def for_resolution(
        width: int, height: int, levels: int = 4, multiplier: int = 3
    ) -> "LadderConfig":
        """Pick a base grid whose final level is at least (width, height)."""
        m = multiplier ** (levels - 1)
        # Invert final = base*m - (m-1)  =>  base = ceil((final + m - 1) / m)
        bw = -(-(width + m - 1) // m)
        bh = -(-(height + m - 1) // m)
        return LadderConfig(base=(bw, bh), multiplier=multiplier, levels=levels)


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Bloom pyramid (reference src/renderer/mod.rs:219-256, bloom_*.wgsl)."""

    enabled: bool = True
    levels: int = 5
    # Fixed 3x3 tent radius in uv units used by the upsample pass
    # (reference bloom_up.wgsl:35-36).
    up_radius_uv: float = 0.005
    # Final image = mix_ratio * scene + (1 - mix_ratio) * bloom
    # (reference mix.wgsl:32-35, mod.rs:258-260).
    mix_ratio: float = 0.7


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of the renderer.

    Defaults mirror the reference startup state
    (src/renderer/mod.rs:116-121, 290-295; src/scene/blackhole.rs:16-28).
    """

    width: int = 1918
    height: int = 1081

    # --- geodesic march (reference RayDetails, ray_pipeline.rs:5-14) ---
    # "pseudo": the reference's pseudo-Newtonian bending force.  "kerr":
    # exact Kerr null geodesics via the autodiff Hamiltonian (bhx.kerr,
    # mirrored in the march kernel); spin-capable.
    geodesics: str = "pseudo"
    # The reference ships with Euler (RayDetails::default() zero-inits
    # integration_method to 0 = Euler, ray_pipeline.rs:4-14, mod.rs:116-121);
    # RK45 remains selectable exactly like its UI combo box.
    integrator: Integrator = Integrator.EULER
    step_size: float = 0.15
    max_iterations: int = 2000
    # Coarse-to-fine subdivision threshold on escape-direction divergence
    # (reference ray.wgsl:217, default mod.rs:120).
    angle_division_threshold: float = 0.02

    # RK45 error control (see bhx.integrate; the reference controller at
    # ray.wgsl:440-462 accepts every step in practice — ours is a real
    # per-lane adaptive controller, divergence documented there).
    rk_rtol: float = 1e-3
    rk_safety: float = 0.9
    rk_min_factor: float = 0.2
    rk_max_factor: float = 1.5
    rk_h_min: float = 1e-3
    rk_h_max: float = 1.0

    # --- feature toggles (reference BlackHole flags + UI) ---
    show_disk: bool = True
    show_disk_texture: bool = True
    show_redshift: bool = True
    show_sky: bool = True
    render_meshes: bool = True
    # "procedural": evaluate disk texture / sky / blackbody tint
    # arithmetically per sample (bhx.procedural) — the default.  "array":
    # bilinear-sample the scene's texture arrays (user-supplied content;
    # required for gradients w.r.t. the textures).
    texture_mode: str = "procedural"

    # Early-exit opacity threshold (reference ray.wgsl:578).
    opacity_cutoff: float = 0.005
    # Rays with <= this many march steps are classified "hit" for the
    # alpha-encoding (reference ray.wgsl:583 `i <= 5`).
    few_iters_threshold: int = 5

    # --- ladder / post chain ---
    use_ladder: bool = True
    ladder: LadderConfig = LadderConfig()
    bloom: BloomConfig = BloomConfig()
    fxaa: FxaaConfig = FxaaConfig()
    tonemap: bool = True

    # --- numerics ---
    # "diff" = fixed-length checkpointed scan (reverse-differentiable);
    # "fast" = early-exiting while_loop (forward only);
    # "pallas" = Pallas kernels, Triton route (forward; the custom VJP
    # replays a jnp mirror); "pallas_interpret" runs them in interpret
    # mode (a test switch for machines without a GPU).
    march_mode: str = "fast"
    # Checkpoint every this many march steps in diff mode.
    checkpoint_every: int = 50
    # Pallas mode: march this many steps per kernel round, then merge the
    # recorded slots before the next round.  Default = one round: camera
    # rays are spatially coherent, so per-block early exit already tracks
    # the local march depth.  Lower it only for scenes with severe
    # per-block divergence.
    pallas_round_steps: int = 4096
    # Steps between the kernel's all-lanes-done votes (budget-capped rays
    # may overrun by up to this many steps; see march_pallas.VOTE_EVERY).
    pallas_vote_every: int = 32
    # Integration substeps unrolled per kernel inner-loop iteration.
    pallas_unroll: int = 1
    # Ray chunks for the march kernel's backward replay (sequential via
    # lax.map): raise above 1 when reverse-mode at large resolutions
    # exceeds HBM (peak backward memory divides by this).
    pallas_bwd_chunks: int = 1
    # Guard the kernel's crossing-slot recording behind a per-substep
    # pl.when(any(crossing)) vote (see march_pallas.MarchKernelConfig).
    pallas_record_guard: bool = True
    dtype: str = "float32"

    def ladder_for_output(self) -> LadderConfig:
        """Ladder whose final level covers (width, height)."""
        lw, lh = self.ladder.final_resolution
        if lw == self.width and lh == self.height:
            return self.ladder
        return LadderConfig.for_resolution(
            self.width, self.height, self.ladder.levels, self.ladder.multiplier
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()


def resolve_march_mode(mode: str, platform: str | None = None) -> str:
    """Resolve ``"auto"``: the Pallas kernel path on a GPU, the plain XLA
    while_loop march anywhere else.  ``platform`` defaults to that of
    ``jax.devices()[0]``; other modes pass through."""
    if mode != "auto":
        return mode
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    return "pallas" if platform == "gpu" else "fast"
