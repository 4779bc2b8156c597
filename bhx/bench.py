"""Throughput benchmark: Mrays/s at 1080p Schwarzschild + disk, on a GPU.

Effective rays (final-resolution pixels) per second for the full default
pipeline (ladder + disk + redshift + sky + bloom + ACES + FXAA).  Timing
is host clock around work that ends in ``jax.block_until_ready``; a run
without a GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Dict

import jax


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "not available" (the power limit bounds the clocks under load, so it
    belongs beside every number)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not available"


def require_gpu() -> jax.Device:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: jax.devices()[0] is {dev.platform} ({dev.device_kind}); "
            "device timings are only taken on a GPU"
        )
    return dev


def run_bench(width: int = 1918, height: int = 1081, iters: int = 5,
              dense: bool = False, warmup: int = 2,
              march_mode: str = "pallas", geodesics: str = "pseudo",
              spin: float = 0.0) -> Dict:
    import dataclasses

    import jax.numpy as jnp

    from bhx.config import LadderConfig, RenderConfig
    from bhx.pipeline import render_jit
    from bhx.scene import Scene

    dev = require_gpu()
    scene = Scene.default()
    if spin:
        scene = dataclasses.replace(
            scene,
            black_hole=dataclasses.replace(
                scene.black_hole, spin=jnp.float32(spin)
            ),
        )
    cfg = RenderConfig(
        width=width,
        height=height,
        use_ladder=not dense,
        ladder=LadderConfig.for_resolution(width, height, 4),
        march_mode=march_mode,
        geodesics=geodesics,
    )

    def frame(t):
        s = dataclasses.replace(scene, time=jnp.float32(t))
        t0 = time.perf_counter()
        jax.block_until_ready(render_jit(s, cfg))
        return time.perf_counter() - t0

    compile_s = frame(0.0)  # first call = compile
    for i in range(warmup):
        frame(1.0 + 0.1 * i)
    times = [frame(2.0 + 0.1 * i) for i in range(iters)]

    med = statistics.median(times)
    rays = width * height
    label = "schwarzschild" if geodesics == "pseudo" else f"kerr(spin={spin})"
    out = {
        "metric": f"Mrays/s 1080p {label}+disk (full pipeline)",
        "value": rays / med / 1e6,
        "unit": "Mrays/s",
        "median_s": med,
        "best_s": min(times),
        "frames": len(times),
        "compile_s": compile_s,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "devices": len(jax.devices()),
        "card": card_info(),
        "march_mode": march_mode,
        "dense": dense,
        "resolution": [width, height],
    }
    if march_mode in ("pallas", "pallas_interpret"):
        # K-slot crossing-drop accounting (the silent-loss number the
        # record-don't-shade design depends on), at a coarser resolution:
        # the overflow fraction is a property of the scene geometry, not
        # of the pixel grid.
        from bhx.tracer import crossing_overflow_stats

        ocfg = RenderConfig(
            width=width, height=height, use_ladder=False,
            march_mode=march_mode, geodesics=geodesics,
        )
        stats = jax.jit(
            lambda s: crossing_overflow_stats(s, ocfg, 640, 361)
        )(scene)
        out["overflow_frac"] = float(stats["overflow_frac"])
        out["overflow_dropped_total"] = int(stats["dropped_total"])
        out["max_crossing_count"] = int(stats["max_count"])
    return out


def grad_check(width: int = 320, height: int = 180,
               rel_tol: float = 0.1) -> Dict:
    """On-device gradient gate: one reverse-mode gradient of a
    weighted-pixel loss through ``march_mode="pallas"``, checked against
    central finite differences of the same loss.  The custom_vjp backward
    replays a jnp mirror of the kernel substep (march_grad); its premise —
    forward kernel trajectory == mirror trajectory — is exactly what a
    kernel codegen divergence would break, and CPU interpret-mode tests
    can never see that.

    The gate renders WITHOUT the star sky and disk texture: procedural
    content has feature scales (star splat radius 2.4e-3 uv, Perlin
    octave density 100) below any usable FD step for strongly-lensed
    rays, so on the full scene AD measures real local slopes that FD
    cannot resolve (AD/FD disagreed 2000x while both were "correct").
    Geometry + density shading is
    smooth at eps=1e-3, making AD == FD a meaningful correctness gate
    for the kernel-path adjoint.
    """
    import dataclasses

    import jax.numpy as jnp

    from bhx.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx.pipeline import render
    from bhx.scene import Scene

    scene = Scene.default()
    cfg = RenderConfig(
        width=width, height=height, use_ladder=False, max_iterations=600,
        march_mode="pallas", fxaa=FxaaConfig(enabled=False),
        bloom=BloomConfig(enabled=False), tonemap=False,
        pallas_bwd_chunks=2,
        show_sky=False, show_disk_texture=False,
    )
    import numpy as np

    def img_of(mass):
        bh = dataclasses.replace(scene.black_hole, mass=mass)
        return render(dataclasses.replace(scene, black_hole=bh), cfg)

    img_jit = jax.jit(img_of)

    # FD-stable pixel mask (tests/test_grad.py's discipline, lifted to a
    # scalar gate): hard visibility edges (disk silhouette, shadow rim)
    # move with mass — their FD shows O(1/eps) boundary terms that
    # interior-only AD does not model (stop-gradient'ed masks,
    # march_grad module docs).  Pixels where FD(eps) and FD(eps/2)
    # agree are exactly the piecewise-smooth set; the gate compares AD
    # and FD of the SAME stable-masked weighted loss, so both sides
    # measure the interior derivative the design defines.
    e1, e2 = 1e-3, 5e-4
    fdimg = {}
    for e in (e1, e2):
        p = np.asarray(img_jit(jnp.float32(0.5 + e)))
        m = np.asarray(img_jit(jnp.float32(0.5 - e)))
        fdimg[e] = (p - m) / (2.0 * e)
    scale = np.maximum(np.abs(fdimg[e1]), np.abs(fdimg[e2]))
    stable = np.abs(fdimg[e1] - fdimg[e2]) <= 0.05 * scale + 1e-4
    stable_frac = float(stable.mean())
    # Richardson extrapolation (kills the O(e^2) curvature bias of the
    # central difference near the photon ring).
    fd_ref = (4.0 * fdimg[e2] - fdimg[e1]) / 3.0
    # Fixed pseudo-random weights make the cotangent direction-rich (a
    # mean alone can hide sign errors that cancel).
    w = np.random.default_rng(7).random((height, width, 3)) * stable
    w_j = jnp.asarray(w, jnp.float32)

    def loss(mass):
        return jnp.sum(img_of(mass) * w_j) / (width * height)

    t0 = time.perf_counter()
    ad = float(jax.jit(jax.grad(loss))(jnp.float32(0.5)))
    grad_s = time.perf_counter() - t0
    fd = float(np.sum(fd_ref * w)) / (width * height)
    rel = abs(ad - fd) / max(abs(ad), abs(fd), 1e-8)
    return {
        "grad_ad": ad,
        "grad_fd": fd,
        "grad_stable_frac": stable_frac,
        "grad_rel_err": rel,
        "grad_first_call_s": grad_s,
        "grad_ok": bool(stable_frac > 0.5 and rel < rel_tol),
    }


def parity_check(width: int = 192, height: int = 108,
                 atol: float = 2e-2, max_bad_frac: float = 0.02,
                 max_iterations: int = 600) -> Dict:
    """On-device numerics gate: the pallas kernel pipeline must reproduce
    the jnp reference pipeline (same scene, dense trace) up to block-exit
    ordering noise.  Complements the CPU interpret-mode parity tests
    (tests/test_pallas.py), which never touch real kernel codegen.
    """
    import numpy as np

    from bhx.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx.pipeline import render_jit
    from bhx.scene import Scene

    scene = Scene.default()
    base = RenderConfig(
        width=width, height=height, use_ladder=False,
        max_iterations=max_iterations,
        fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
        tonemap=False,
    )
    img_pl = np.asarray(render_jit(scene, base.replace(march_mode="pallas")))
    img_jnp = np.asarray(render_jit(scene, base.replace(march_mode="fast")))
    bad = float((np.abs(img_pl - img_jnp) > atol).any(-1).mean())
    finite = bool(np.isfinite(img_pl).all())
    return {
        "parity_bad_frac": bad,
        "parity_ok": bool(finite and bad <= max_bad_frac),
    }


def camera_march_inputs(scene, cfg, width: int, height: int, pad_to: int = 0):
    """March-kernel inputs for the camera rays of a frame: (rays, params,
    kcfg), the rows the tracer hands the kernel for rays that start inside
    the relativity sphere (the default camera's).  Rays are padded with
    inactive copies of the last ray to a multiple of ``pad_to`` (default:
    the kernel's block)."""
    import jax.numpy as jnp

    from bhx.kernels.march_pallas import BLOCK, pack_params
    from bhx.tracer import camera_rays, march_kernel_config

    kcfg = march_kernel_config(cfg)
    bh = scene.black_hole
    o, d = camera_rays(scene.camera, width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = o.shape[0]
    pad = (-n) % (pad_to or BLOCK)
    o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (pad, 3))])
    d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (pad, 3))])
    live = jnp.concatenate([jnp.ones((n,)), jnp.zeros((pad,))])
    m = n + pad
    rays = [
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        jnp.full((m,), cfg.step_size), live, jnp.ones((m,)), jnp.zeros((m,)),
    ]
    if cfg.geodesics == "kerr":
        from bhx import kerr

        q = kerr.null_momentum(o - bh.position, d, bh.mass, bh.spin)
        rays += [q[:, 0], q[:, 1], q[:, 2]]
    _, disk_normal = bh.disk_frame()
    params = pack_params(bh, disk_normal, cfg)
    rays = tuple(jnp.asarray(r, jnp.float32) for r in rays)
    return rays, params, kcfg


def mirror_check(scene, cfg, width: int = 1918, height: int = 1081,
                 tol: float = 1e-3) -> Dict:
    """March kernel vs its step-exact jnp mirror (march_grad.march_jnp) on
    a frame's camera rays: the share of rays whose output rows differ by
    more than ``tol`` anywhere, and the kernel's time (median of 3)."""
    import numpy as np

    from bhx.kernels.march_grad import march_jnp
    from bhx.kernels.march_pallas import march_pallas

    rays, params, kcfg = camera_march_inputs(scene, cfg, width, height)
    n = width * height
    kern = jax.jit(lambda r, p: march_pallas(r, p, kcfg))
    mirror = jax.jit(lambda r, p: march_jnp(r, p, kcfg))
    t0 = time.perf_counter()
    out_k = jax.block_until_ready(kern(rays, params))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(kern(rays, params))
        times.append(time.perf_counter() - t0)
    out_j = mirror(rays, params)
    k = np.stack([np.asarray(r)[:n] for r in out_k])
    j = np.stack([np.asarray(r)[:n] for r in out_j])
    bad = (np.abs(k - j) > tol).any(axis=0)
    return {
        "rays": n,
        "bad_share": float(bad.mean()),
        "finite": bool(np.isfinite(k).all()),
        "kernel_s": statistics.median(times),
        "compile_s": compile_s,
    }
