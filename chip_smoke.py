#!/usr/bin/env python
"""Quickest proof that bhx's main path runs on one GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded paths, on four cards

One card, one line per phase: the default 1918x1081 frame rendered through
``bhx.render_jit`` on the Pallas kernel path (compile time, median frame
time, image checks); the march kernel against its step-exact jnp mirror
for Euler, RK45 and Kerr; the kernel pipeline against the plain XLA
pipeline; the gradient check and three ``fit_scene`` steps through the
kernel forward and its replayed adjoint.

``--four-cards`` runs only the sharded checks: the dense 1080p kernel-path
trace under shard_map over a 4-card mesh against the one-card trace, and
one sharded ``train_step`` against the one-card step.

The first line is the card's name and power limit (nvidia-smi); the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Without a GPU, or when any phase fails, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
import traceback

W, H = 1918, 1081


def report(name: str, **values) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# One card
# --------------------------------------------------------------------------


def phase_render():
    """The reference's shipped frame on the kernel path: 4-level ladder,
    Euler, disk, redshift, procedural sky, bloom, ACES, FXAA."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bhx

    scene = bhx.Scene.default()
    cfg = bhx.RenderConfig(march_mode="pallas")
    check((cfg.width, cfg.height) == (W, H), "default frame is 1918x1081")
    t0 = time.perf_counter()
    img = jax.block_until_ready(bhx.render_jit(scene, cfg))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(5):
        s = dataclasses.replace(scene, time=jnp.float32(0.1 * (i + 1)))
        t0 = time.perf_counter()
        jax.block_until_ready(bhx.render_jit(s, cfg))
        times.append(time.perf_counter() - t0)
    img = np.asarray(img)
    lum = img.mean(-1)
    h, w = lum.shape
    center = lum[int(0.3 * h):int(0.7 * h), int(0.35 * w):int(0.65 * w)]
    shadow = float((center < 0.025).mean())
    lit = float(np.percentile(lum, 99))
    med = statistics.median(times)
    report("render_1080p", shape=img.shape, compile_s=compile_s,
           median_frame_s=med, best_frame_s=min(times),
           mrays_per_s=W * H / med / 1e6, shadow_share=shadow, lum_p99=lit)
    check(img.shape == (H, W, 3), f"frame shape {img.shape}")
    check(bool(np.isfinite(img).all()), "frame has non-finite pixels")
    check(shadow >= 0.03, f"no dark shadow near the centre ({shadow})")
    check(lit >= 0.3, f"no lit disk (99th percentile luminance {lit})")


def phase_mirror():
    """March kernel vs its jnp mirror on the 1080p camera rays."""
    import jax.numpy as jnp

    import bhx
    from bhx.bench import mirror_check
    from bhx.config import Integrator

    scene = bhx.Scene.default()
    kerr_scene = dataclasses.replace(
        scene,
        black_hole=dataclasses.replace(scene.black_hole, spin=jnp.float32(0.9)),
    )
    cfg = bhx.RenderConfig(march_mode="pallas")
    for name, sc, c in (
        ("euler", scene, cfg),
        ("rk45", scene, cfg.replace(integrator=Integrator.RK45)),
        ("kerr_spin0.9", kerr_scene, cfg.replace(geodesics="kerr")),
    ):
        r = mirror_check(sc, c, W, H, tol=1e-3)
        report(f"mirror_{name}", rays=r["rays"],
               share_over_1e3=r["bad_share"], kernel_s=r["kernel_s"],
               compile_s=r["compile_s"])
        check(r["finite"], f"{name}: non-finite kernel output")
        check(r["bad_share"] <= 0.05, f"{name}: {r['bad_share']} of rays "
              "differ from the mirror by more than 1e-3")


def phase_parity():
    """Dense 1080p frame: kernel pipeline vs plain XLA pipeline."""
    from bhx.bench import parity_check

    r = parity_check(W, H, atol=2e-2, max_bad_frac=0.02, max_iterations=2000)
    report("pipeline_parity", atol=2e-2, bad_frac=r["parity_bad_frac"],
           limit=0.02)
    check(r["parity_ok"], f"pipeline parity {r}")


def _fit_problem():
    """(scene, target, cfg) of the inverse-rendering checks: recover the
    mass from a 320x180 dense frame rendered at mass 0.55 on the kernel
    path (sky, disk texture, redshift, ACES; no bloom or FXAA)."""
    import jax.numpy as jnp

    import bhx

    scene = bhx.Scene.default()
    cfg = bhx.RenderConfig(
        width=320, height=180, use_ladder=False, march_mode="pallas",
        bloom=bhx.BloomConfig(enabled=False),
        fxaa=bhx.FxaaConfig(enabled=False),
    )
    target_scene = dataclasses.replace(
        scene,
        black_hole=dataclasses.replace(scene.black_hole, mass=jnp.float32(0.55)),
    )
    return scene, bhx.render_jit(target_scene, cfg), cfg


def phase_gradient():
    """AD (kernel forward + replayed adjoint) vs Richardson FD, then three
    inverse-rendering steps through the kernel path."""
    import jax.numpy as jnp
    import numpy as np

    import bhx
    from bhx.bench import grad_check
    from bhx.parallel import fit_scene

    g = grad_check()
    report("grad_check", ad=g["grad_ad"], fd=g["grad_fd"],
           rel_err=g["grad_rel_err"], stable_frac=g["grad_stable_frac"],
           first_call_s=g["grad_first_call_s"])
    check(g["grad_ok"], f"gradient check {g}")

    scene, target, cfg = _fit_problem()
    t0 = time.perf_counter()
    params, losses = fit_scene(scene, target, cfg, steps=3, lr=1e-2)
    report("fit_scene", steps=len(losses), losses=losses,
           mass=float(params["mass"]), seconds=time.perf_counter() - t0)
    check(len(losses) == 3 and bool(np.isfinite(losses).all()),
          f"fit_scene losses {losses}")


ONE_CARD = [phase_render, phase_mirror, phase_parity, phase_gradient]


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------


def _on_1_and_4_cards(fn):
    """fn(mesh) on a one-card and a four-card mesh, run in two threads so
    that the two programs compile concurrently (the four-card run is
    charged per card-second)."""
    import concurrent.futures

    import jax

    from bhx.parallel import tile_mesh

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(fn, tile_mesh(jax.devices()[:n]))
                for n in (1, 4)}
        return {n: f.result() for n, f in futs.items()}


def phase_sharded_trace():
    """Dense 1080p kernel-path trace under shard_map over 4 cards vs the
    same trace on one card."""
    import numpy as np

    import bhx
    from bhx.parallel import trace_image_sharded

    scene = bhx.Scene.default()
    cfg = bhx.RenderConfig(use_ladder=False, march_mode="pallas")
    recs = _on_1_and_4_cards(lambda mesh: np.asarray(
        trace_image_sharded(scene, cfg, mesh, W, H)))
    bad = float((np.abs(recs[4] - recs[1]) > 2e-2).any(-1).mean())
    report("sharded_trace_4cards_vs_1card", shape=recs[4].shape, atol=2e-2,
           bad_frac=bad, limit=0.02)
    check(bool(np.isfinite(recs[4]).all()), "non-finite sharded record")
    check(bad <= 0.02, f"sharded trace differs on {bad} of pixels")


def phase_sharded_train():
    """One fit_scene step (train_step with the target sharded) over 4
    cards vs the same step on one card: loss and parameters.  The frame is
    grad_check's (320x180 dense, no sky texture, no post chain), which
    compiles in a fraction of the full frame's time."""
    import jax.numpy as jnp
    import numpy as np

    import bhx
    from bhx.parallel import fit_scene

    scene = bhx.Scene.default()
    cfg = bhx.RenderConfig(
        width=320, height=180, use_ladder=False, max_iterations=600,
        march_mode="pallas", show_sky=False, show_disk_texture=False,
        tonemap=False, bloom=bhx.BloomConfig(enabled=False),
        fxaa=bhx.FxaaConfig(enabled=False),
    )
    target = bhx.render_jit(dataclasses.replace(
        scene,
        black_hole=dataclasses.replace(scene.black_hole, mass=jnp.float32(0.55)),
    ), cfg)
    res = _on_1_and_4_cards(lambda mesh: fit_scene(
        scene, target, cfg, steps=1, lr=1e-2, mesh=mesh))
    (p1, (l1,)), (p4, (l4,)) = res[1], res[4]
    diff = max(float(np.max(np.abs(np.asarray(p1[k]) - np.asarray(p4[k]))))
               for k in p1)
    report("sharded_train_step_4cards", loss_1card=l1, loss_4cards=l4,
           max_param_diff=diff)
    check(np.isfinite(l1) and np.isfinite(l4), "non-finite loss")
    check(abs(l1 - l4) <= 1e-4 * abs(l1) + 1e-7, f"losses {l1} vs {l4}")
    check(diff <= 1e-4, f"parameters differ by {diff}")


FOUR_CARDS = [phase_sharded_trace, phase_sharded_train]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded checks, on four cards")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import bhx
    except ImportError as e:
        print(f"chip_smoke: cannot import bhx ({e})", file=sys.stderr)
        return 2
    bhx.enable_compile_cache()
    import jax

    devices = jax.devices()
    dev = devices[0]
    want = 4 if args.four_cards else 1
    if dev.platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX found {len(devices)} "
              f"{dev.platform} device(s) ({dev.device_kind})", file=sys.stderr)
        return 2
    from bhx.bench import card_info

    print(card_info(), flush=True)
    report("device", platform=dev.platform, kind=dev.device_kind,
           count=len(devices))

    failed = []
    for ph in FOUR_CARDS if args.four_cards else ONE_CARD:
        t0 = time.perf_counter()
        try:
            ph()
        except Exception:
            traceback.print_exc()
            failed.append(ph.__name__)
        report(ph.__name__, seconds=time.perf_counter() - t0,
               status="FAILED" if ph.__name__ in failed else "ok")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
