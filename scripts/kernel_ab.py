#!/usr/bin/env python
"""Keep-or-remove timings for the Pallas kernels, on one GPU.

  python scripts/kernel_ab.py blocks frames

``blocks``: rays and warps per program of the march kernel (1080p camera
rays) and of the composite kernel (their recorded slots, checked against
the jnp version).  ``frames``: the 1080p default frame on the kernel path,
with the composite kernel swapped for its jnp version, and on the plain
XLA path, timed in interleaved turns.  Each result line is printed and
kept in chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import statistics
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bhx  # noqa: E402

bhx.enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bhx.bench import camera_march_inputs, card_info, require_gpu  # noqa: E402
from bhx.config import RenderConfig  # noqa: E402
from bhx.tracer import march_kernel_config  # noqa: E402
from bhx.kernels import shade_pallas as sp  # noqa: E402
from bhx.scene import Scene  # noqa: E402

# The module, not the function bhx.kernels re-exports under its name.
mp = importlib.import_module("bhx.kernels.march_pallas")
W, H = 1918, 1081
RESULTS = {}


def log(key, value):
    RESULTS[key] = value
    print(f"{key}: {json.dumps(value)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/kernel_ab.json", "w") as fp:
        json.dump(RESULTS, fp, indent=1)


def timed(fn, *args, n=5):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"compile_s": compile_s, "median_s": statistics.median(ts),
            "best_s": min(ts)}


def phase(name, fn):
    try:
        fn()
    except Exception as e:  # report every phase, then fail at the end
        traceback.print_exc()
        log(name + "_error", f"{type(e).__name__}: {str(e)[:2000]}")


def blocks():
    """Rays per program and warps per program of both kernels, on the
    1080p camera rays (march) and their recorded slots (composite)."""
    scene = Scene.default()
    cfg = RenderConfig(march_mode="pallas")
    rays, params, kcfg = camera_march_inputs(scene, cfg, W, H, pad_to=1024)
    out = mp.march_pallas(rays, params, kcfg)
    base = (mp.BLOCK, mp.NUM_WARPS)
    for blk, nw in [(32, 1), (64, 2), (128, 4), (256, 8), (128, 2), (256, 4)]:
        mp.BLOCK, mp.NUM_WARPS = blk, nw
        jax.clear_caches()
        f = jax.jit(lambda r, p: mp.march_pallas(r, p, kcfg))
        phase(f"march_block{blk}", lambda: log(
            f"march_block{blk}_warps{nw}", timed(f, rays, params)))
    mp.BLOCK, mp.NUM_WARPS = base
    jax.clear_caches()

    n = W * H
    slots = tuple(r[:n] for r in out[mp.OUT_FIXED:mp.OUT_FIXED + 28])
    cam = jnp.full((n,), 19.0, jnp.float32)
    rot, _ = scene.black_hole.disk_frame()
    sparams = sp.pack_shade_params(scene.black_hole, rot, scene.time)
    skc = sp.ShadeKernelConfig()
    gain = scene.disk_gain
    ref = np.stack(jax.jit(
        lambda s, c, p, g: sp._composite_jnp(s, c, p, g, skc))(
            slots, cam, sparams, gain))
    base = (sp.BLOCK, sp.NUM_WARPS)
    for blk, nw in [(128, 4), (256, 4), (256, 8), (512, 8)]:
        sp.BLOCK, sp.NUM_WARPS = blk, nw
        jax.clear_caches()
        f = jax.jit(lambda s, c, p, g: sp.shade_composite(s, c, p, g, skc))

        def run():
            r = timed(f, slots, cam, sparams, gain)
            err = np.abs(np.stack(f(slots, cam, sparams, gain)) - ref)
            r.update(max_abs_vs_jnp=float(err.max()),
                     share_over_1e4=float((err > 1e-4).mean()))
            log(f"composite_block{blk}_warps{nw}", r)

        phase(f"composite_block{blk}", run)
    sp.BLOCK, sp.NUM_WARPS = base
    jax.clear_caches()


def frames():
    from bhx.pipeline import render

    scene = Scene.default()
    variants = {}

    def build(name, mode, patch=None):
        cfg = RenderConfig(march_mode=mode)
        saved = {}
        for attr, repl in (patch or {}).items():
            saved[attr] = getattr(sp, attr)
            setattr(sp, attr, repl)
        try:
            f = jax.jit(lambda s: render(s, cfg))
            t0 = time.perf_counter()
            img = jax.block_until_ready(f(scene))
            log(f"frame_{name}_compile_s", time.perf_counter() - t0)
        finally:
            for attr, orig in saved.items():
                setattr(sp, attr, orig)
        variants[name] = (f, np.asarray(img))

    phase("build_pallas", lambda: build("pallas", "pallas"))
    phase("build_xla_composite", lambda: build(
        "pallas_xla_composite", "pallas",
        {"_composite_pallas": sp._composite_jnp}))
    phase("build_fast", lambda: build("fast", "fast"))

    times = {k: [] for k in variants}
    for _ in range(3):  # interleaved turns
        for name, (f, _) in variants.items():
            for i in range(3):
                s = dataclasses.replace(scene, time=jnp.float32(0.1 * i))
                t0 = time.perf_counter()
                jax.block_until_ready(f(s))
                times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        log(f"frame_{name}", {"median_s": statistics.median(ts),
                              "best_s": min(ts), "frames": len(ts)})
    if "pallas" in variants:
        ref = variants["pallas"][1]
        for name, (_, img) in variants.items():
            bad = float((np.abs(img - ref) > 2e-2).any(-1).mean())
            log(f"frame_{name}_vs_pallas_bad_frac", bad)


def main():
    dev = require_gpu()
    log("card", card_info())
    log("device", {"platform": dev.platform, "kind": dev.device_kind})
    for which in sys.argv[1:]:
        {"blocks": blocks, "frames": frames}[which]()
    return 1 if any(k.endswith("_error") for k in RESULTS) else 0


if __name__ == "__main__":
    sys.exit(main())
