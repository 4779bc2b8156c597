#!/usr/bin/env python
"""BASELINE config 4 artifact: gradients at 1918x1081 through the
full pallas + ladder + post pipeline.

Two-part artifact (scripts/out/GRAD_CONFIG4.json):

* **full_config** — reverse-mode d(loss)/d(mass, fov, disk_outer) of
  the DEFAULT pipeline (procedural star sky + Perlin disk texture +
  bloom/ACES/FXAA).  The gradients must be finite; they are NOT held to
  finite differences, because the procedural content has feature scales
  (star splat radius 2.4e-3 uv, Perlin octave density 100) below any
  usable FD step for strongly-lensed rays — the recorded
  ``fd_stable`` rows show FD swinging sign/magnitude as eps halves,
  i.e. FD does not measure a derivative on this function.  (Round-5
  discovery: an earlier version of this artifact gated the full config
  on FD and "failed" for exactly this reason — plus a real FXAA NaN the
  run exposed, fixed in bhx/post.py.)
* **smooth_config** — the SAME resolution / ladder / march / post chain
  with the sub-eps content removed (show_sky=False,
  show_disk_texture=False), compared on an FD-STABLE PIXEL MASK
  (tests/test_grad.py's discipline): visibility edges carry boundary
  terms interior-only AD does not model, so AD and FD of the same
  stable-masked weighted loss are compared and ``ad_fd_agree`` must be
  all-true.

Also writes grad_mass_1080p.png — the |d(image)/d(mass)| FD image of
the full config for visual inspection.

The backward replays the march mirror over every ray; at 1080p that
peaks near the device-memory limit, so the artifact runs ray-chunked by default
(sequential chunks, zero approximation — march_grad.pallas_bwd_chunks).

Reference ladder being differentiated: renderer/mod.rs:170-207 (which
has no gradients at all).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bhx

bhx.enable_compile_cache()  # persistent XLA compile cache (explicit opt-in)

import jax
import jax.numpy as jnp
import numpy as np


THETA0 = (0.5, 1.0, 10.0)  # mass, fov, disk_outer
EPS = (1e-3, 1e-3, 1e-2)


def build(cfg, scene, probes):
    from bhx.pipeline import render

    def img_fn(mass, fov, disk_outer):
        bh = dataclasses.replace(
            scene.black_hole, mass=mass, disk_outer=disk_outer
        )
        cam = dataclasses.replace(scene.camera, fov=fov)
        s = dataclasses.replace(scene, black_hole=bh, camera=cam)
        return render(s, cfg)

    def loss_fn(mass, fov, disk_outer):
        img = img_fn(mass, fov, disk_outer)
        probe_sum = sum(img[y, x].sum() for (y, x) in probes)
        return jnp.mean(img) * 100.0 + probe_sum

    return (
        img_fn,
        jax.jit(loss_fn),
        jax.jit(jax.grad(loss_fn, argnums=(0, 1, 2))),
    )


def fd_of(f, theta0, i, e):
    tp = [jnp.float32(t + (e if j == i else 0.0)) for j, t in enumerate(theta0)]
    tm = [jnp.float32(t - (e if j == i else 0.0)) for j, t in enumerate(theta0)]
    return (float(f(*tp)) - float(f(*tm))) / (2.0 * e)


def run_part(cfg, scene, probes, fd_gate: bool):
    img_fn, f, g = build(cfg, scene, probes)
    theta0 = tuple(jnp.float32(t) for t in THETA0)

    t0 = time.perf_counter()
    l0 = float(f(*theta0))
    fwd_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(f(*theta0))
    fwd_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    grads = [float(v) for v in g(*theta0)]
    grad_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [float(v) for v in g(*theta0)]
    grad_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    fd1 = [fd_of(f, THETA0, i, e) for i, e in enumerate(EPS)]
    fd2 = [fd_of(f, THETA0, i, e * 0.5) for i, e in enumerate(EPS)]
    fd_s = time.perf_counter() - t0

    stable = [
        abs(a - b) <= 0.1 * max(abs(a), abs(b), 1e-8)
        for a, b in zip(fd1, fd2)
    ]
    rel = [
        abs(a - b) / max(abs(a), abs(b), 1e-8) for a, b in zip(grads, fd2)
    ]
    out = dict(
        loss_value=l0,
        ad_grads=grads,
        ad_finite=[bool(np.isfinite(v)) for v in grads],
        fd_grads_eps=fd1,
        fd_grads_half_eps=fd2,
        fd_stable=stable,
        ad_fd_rel_err=[round(r, 4) for r in rel],
        timings_s=dict(
            forward=round(fwd_s, 3), grad=round(grad_s, 3),
            fd_12_renders=round(fd_s, 3),
            forward_compile=round(fwd_compile_s, 1),
            grad_compile=round(grad_compile_s, 1),
        ),
    )
    return out, img_fn


def run_smooth_gate(cfg, scene, W, H):
    """AD == FD gate on the smooth config with an FD-STABLE PIXEL MASK
    (tests/test_grad.py's discipline at production scale): hard
    visibility edges (disk silhouette, shadow rim) move with the
    parameters — their FD carries O(1/eps) boundary terms that
    interior-only AD does not model (the design stop-gradients every
    discrete decision).  Pixels where FD(eps) and FD(eps/2) agree are
    the piecewise-smooth set; AD and FD of the same stable-masked
    weighted loss must then match."""
    from bhx.pipeline import render

    def img_fn(mass, fov, disk_outer):
        bh = dataclasses.replace(
            scene.black_hole, mass=mass, disk_outer=disk_outer
        )
        cam = dataclasses.replace(scene.camera, fov=fov)
        s = dataclasses.replace(scene, black_hole=bh, camera=cam)
        return render(s, cfg)

    img_jit = jax.jit(img_fn)
    theta0 = tuple(jnp.float32(t) for t in THETA0)

    def fd_img(i, e):
        tp = [jnp.float32(t + (e if j == i else 0.0))
              for j, t in enumerate(THETA0)]
        tm = [jnp.float32(t - (e if j == i else 0.0))
              for j, t in enumerate(THETA0)]
        return (np.asarray(img_jit(*tp)) - np.asarray(img_jit(*tm))) / (2 * e)

    t0 = time.perf_counter()
    masks, fdimgs = [], []
    for i, e in enumerate(EPS):
        f1 = fd_img(i, e)
        f2 = fd_img(i, e * 0.5)
        scale = np.maximum(np.abs(f1), np.abs(f2))
        masks.append(np.abs(f1 - f2) <= 0.05 * scale + 1e-4)
        # Richardson extrapolation of the central difference (exact
        # through O(e^2) curvature): near the photon ring d(img)/d(mass)
        # is smooth but strongly curved, and plain FD at e/2 still
        # carries visible second-order bias.
        fdimgs.append((4.0 * f2 - f1) / 3.0)
    fd_s = time.perf_counter() - t0
    stable = masks[0] & masks[1] & masks[2]
    stable_frac = float(stable.mean())
    w = np.random.default_rng(7).random(stable.shape) * stable
    w_j = jnp.asarray(w, jnp.float32)
    size = float(W * H)

    def loss(mass, fov, disk_outer):
        return jnp.sum(img_fn(mass, fov, disk_outer) * w_j) / size

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    t0 = time.perf_counter()
    ad = [float(v) for v in g(*theta0)]
    grad_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [float(v) for v in g(*theta0)]
    grad_s = time.perf_counter() - t0
    fd = [float(np.sum(fi * w)) / size for fi in fdimgs]
    rel = [abs(a - b) / max(abs(a), abs(b), 1e-8) for a, b in zip(ad, fd)]
    return dict(
        loss="sum(w * stable_mask * image) / (W*H), fixed random w",
        stable_pixel_frac=round(stable_frac, 4),
        ad_grads=ad,
        fd_grads=fd,
        ad_fd_rel_err=[round(r, 4) for r in rel],
        ad_fd_agree=[bool(stable_frac > 0.5 and r < 0.1) for r in rel],
        timings_s=dict(
            grad=round(grad_s, 3),
            grad_compile=round(grad_compile_s, 1),
            fd_12_renders=round(fd_s, 2),
        ),
    )


def main():
    from bhx.config import LadderConfig, RenderConfig
    from bhx.scene import Scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--bwd-chunks", type=int, default=8)
    args = ap.parse_args()

    W, H = 1918, 1081
    scene = Scene.default()
    full_cfg = RenderConfig(
        width=W, height=H, use_ladder=True,
        ladder=LadderConfig.for_resolution(W, H, 4), march_mode="pallas",
        pallas_bwd_chunks=args.bwd_chunks,
    )
    smooth_cfg = dataclasses.replace(
        full_cfg, show_sky=False, show_disk_texture=False
    )
    probes = [(H // 2, W // 2), (H // 2, W // 3), (2 * H // 5, 2 * W // 3),
              (H // 2 + 40, W // 2 + 200)]

    from bhx.config import BloomConfig, FxaaConfig

    full, img_fn = run_part(full_cfg, scene, probes, fd_gate=False)
    smooth = run_smooth_gate(smooth_cfg, scene, W, H)
    # Interior gate: ALSO drop bloom + FXAA.  Bloom is a wide linear
    # blur, so a silhouette pixel's O(1/eps) boundary flip (which
    # interior-only AD does not model) smears into many neighbours as
    # moderate, FD-stable-looking contributions — the residual ~14% mass
    # gap of smooth_config.  Without smearing paths the stable-masked
    # comparison isolates exactly the derivative AD defines, and must
    # agree on every parameter.
    interior_cfg = dataclasses.replace(
        smooth_cfg, bloom=BloomConfig(enabled=False),
        fxaa=FxaaConfig(enabled=False),
    )
    interior = run_smooth_gate(interior_cfg, scene, W, H)

    # FD gradient IMAGE d(image)/d(mass) of the FULL config for visual
    # inspection (FD in image space is fine here: per-pixel magnitude
    # structure, not a derivative gate).
    e = 1e-3
    img_p = np.asarray(img_fn(jnp.float32(0.5 + e), jnp.float32(1.0),
                              jnp.float32(10.0)))
    img_m = np.asarray(img_fn(jnp.float32(0.5 - e), jnp.float32(1.0),
                              jnp.float32(10.0)))
    gimg = (img_p - img_m) / (2.0 * e)

    out = dict(
        resolution=[W, H],
        config="pallas march + 4-level ladder + bloom + ACES + FXAA",
        bwd_chunks=args.bwd_chunks,
        loss="100*mean(image) + sum of 4 probe pixels",
        probes=probes,
        params=["mass", "fov", "disk_outer"],
        eps=list(EPS),
        full_config=full,
        full_config_note=(
            "AD grads gated on FINITENESS only: the star sky / Perlin "
            "octaves put real image content below the FD step scale for "
            "strongly-lensed rays — see fd_stable (FD is not a "
            "derivative there).  The smooth_config block is the AD==FD "
            "correctness gate at identical scale/pipeline."
        ),
        smooth_config=smooth,
        smooth_config_note=(
            "stable-masked AD vs Richardson FD through ladder + bloom + "
            "ACES + frozen-weight FXAA; bloom linearly smears silhouette "
            "boundary terms (not modeled by interior-only AD) into "
            "FD-stable pixels — the interior_config block removes the "
            "smearing paths and is the strict correctness gate."
        ),
        interior_config=interior,
        grad_image_stats=dict(
            finite=bool(np.isfinite(gimg).all()),
            abs_max=float(np.abs(gimg).max()),
            abs_mean=float(np.abs(gimg).mean()),
        ),
        device=jax.devices()[0].device_kind,
    )
    odir = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(odir, exist_ok=True)
    with open(os.path.join(odir, "GRAD_CONFIG4.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))

    from bhx.io import save_png

    mag = np.abs(gimg).sum(-1)
    mag = mag / max(mag.max(), 1e-8)
    save_png(os.path.join(odir, "grad_mass_1080p.png"), np.clip(mag, 0, 1))
    print("wrote", os.path.join(odir, "GRAD_CONFIG4.json"),
          "and grad_mass_1080p.png")


if __name__ == "__main__":
    main()
