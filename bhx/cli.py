"""Command-line interface: bhx render / bench / fit / assets.

The reference has no CLI — everything is the interactive egui app
(src/ui/*).  Every UI setting is exposed here as a flag
(SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _build_config(args) -> "RenderConfig":
    from bhx.config import (
        BloomConfig,
        FxaaConfig,
        Integrator,
        LadderConfig,
        RenderConfig,
        resolve_march_mode,
    )

    mode = resolve_march_mode(args.march_mode)
    ladder = LadderConfig.for_resolution(args.width, args.height, args.ladder_levels)
    return RenderConfig(
        width=args.width,
        height=args.height,
        integrator=Integrator.RK45 if args.integrator == "rk45" else Integrator.EULER,
        step_size=args.step_size,
        max_iterations=args.max_iterations,
        angle_division_threshold=args.division_threshold,
        show_disk=not args.no_disk,
        show_disk_texture=not args.no_disk_texture,
        show_redshift=not args.no_redshift,
        show_sky=not args.no_sky,
        render_meshes=not args.no_meshes,
        use_ladder=not args.no_ladder,
        ladder=ladder,
        bloom=BloomConfig(enabled=not args.no_bloom, mix_ratio=args.mix_ratio),
        fxaa=FxaaConfig(enabled=not args.no_fxaa),
        tonemap=not args.no_tonemap,
        march_mode=mode,
        geodesics=args.geodesics,
    )


def _build_scene(args) -> "Scene":
    import dataclasses as dc

    import jax.numpy as jnp

    from bhx.scene import Scene

    meshes = ()
    if args.obj:
        from bhx.geometry import make_mesh

        meshes = tuple(
            make_mesh(p, position=(0.0, 0.0, 0.0), name=f"obj{i}")
            for i, p in enumerate(args.obj)
        )
    scene = Scene.default(meshes=meshes)
    bh = dc.replace(
        scene.black_hole,
        mass=jnp.float32(args.mass),
        spin=jnp.float32(args.spin),
        disk_inner=jnp.float32(args.disk_inner),
        disk_outer=jnp.float32(args.disk_outer),
        disk_rotation=jnp.asarray(args.disk_rotation, jnp.float32),
        rotation_speed=jnp.float32(args.rotation_speed),
        relativity_radius=jnp.float32(args.relativity_radius),
        feather=jnp.float32(args.feather),
    )
    cam = dc.replace(
        scene.camera,
        position=jnp.asarray(args.camera, jnp.float32),
        fov=jnp.float32(args.fov),
    )
    if args.look_at is not None:
        fwd = jnp.asarray(args.look_at, jnp.float32) - cam.position
        cam = dc.replace(cam, forward=fwd / jnp.linalg.norm(fwd))
    return dc.replace(scene, camera=cam, black_hole=bh, time=jnp.float32(args.time))


def _add_scene_flags(p: argparse.ArgumentParser):
    p.add_argument("--width", type=int, default=1918)
    p.add_argument("--height", type=int, default=1081)
    p.add_argument("--mass", type=float, default=0.5)
    p.add_argument("--spin", type=float, default=0.0,
                   help="dimensionless a/M (geodesics=kerr only)")
    p.add_argument("--geodesics", choices=["pseudo", "kerr"], default="pseudo",
                   help="pseudo-Newtonian bending (reference) or exact Kerr")
    p.add_argument("--disk-inner", type=float, default=2.0)
    p.add_argument("--disk-outer", type=float, default=10.0)
    p.add_argument("--disk-rotation", type=float, nargs=3,
                   default=[0.15, 0.0, 0.25], help="disk Euler angles")
    p.add_argument("--rotation-speed", type=float, default=1.0)
    p.add_argument("--relativity-radius", type=float, default=20.0)
    p.add_argument("--feather", type=float, default=0.3)
    p.add_argument("--camera", type=float, nargs=3, default=[0.0, 0.0, -19.0])
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=1.0)
    p.add_argument("--time", type=float, default=0.0)
    p.add_argument("--obj", action="append", default=[], help="OBJ mesh path")
    # Euler is the reference's shipped default (ray_pipeline.rs:4-14
    # zero-inits integration_method).
    p.add_argument("--integrator", choices=["euler", "rk45"], default="euler")
    p.add_argument("--step-size", type=float, default=0.15)
    p.add_argument("--max-iterations", type=int, default=2000)
    p.add_argument("--division-threshold", type=float, default=0.02)
    p.add_argument("--ladder-levels", type=int, default=4)
    p.add_argument(
        "--march-mode",
        choices=["auto", "fast", "diff", "pallas"],
        default="auto",
        help="auto = Pallas kernels on a GPU, XLA while_loop elsewhere",
    )
    p.add_argument("--mix-ratio", type=float, default=0.7)
    for flag in (
        "no-disk", "no-disk-texture", "no-redshift", "no-sky", "no-meshes",
        "no-ladder", "no-bloom", "no-fxaa", "no-tonemap",
    ):
        p.add_argument(f"--{flag}", action="store_true")


def cmd_render(args) -> int:
    from bhx.io import save_png
    from bhx.pipeline import render_jit
    from bhx.parallel import render_sharded, tile_mesh

    import jax

    scene = _build_scene(args)
    cfg = _build_config(args)
    t0 = time.perf_counter()
    if args.sharded and len(jax.devices()) > 1:
        img = render_sharded(scene, cfg)
    else:
        img = render_jit(scene, cfg)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    save_png(args.output, img)
    rays = cfg.width * cfg.height
    print(f"rendered {cfg.width}x{cfg.height} in {dt:.2f}s "
          f"({rays / dt / 1e6:.2f} Mrays/s incl. compile) -> {args.output}")
    return 0


def cmd_bench(args) -> int:
    from bhx.bench import run_bench

    result = run_bench(
        width=args.width, height=args.height, iters=args.iters,
        dense=args.dense, geodesics=args.geodesics, spin=args.spin,
    )
    import json

    print(json.dumps(result))
    return 0


def cmd_assets(args) -> int:
    from bhx import assets
    from bhx.io import save_png

    if args.regenerate:
        assets.clear_cache()
    disk = assets.disk_texture()
    sky = assets.sky_texture()
    lut = assets.blackbody_lut()
    if args.dump:
        save_png("disk_texture.png", disk)
        save_png("sky_texture.png", sky)
        save_png("blackbody_lut.png", lut)
        print("wrote disk_texture.png sky_texture.png blackbody_lut.png")
    print(f"disk {disk.shape} sky {sky.shape} lut {lut.shape}")
    return 0


def cmd_fit(args) -> int:
    import jax.numpy as jnp

    from bhx.io import load_image
    from bhx.parallel import fit_scene
    from bhx.config import BloomConfig, FxaaConfig

    scene = _build_scene(args)
    cfg = _build_config(args)
    cfg = dataclasses.replace(
        cfg, march_mode="diff", use_ladder=False,
        fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
        max_iterations=min(cfg.max_iterations, 400),
    )
    target = jnp.asarray(load_image(args.target)[..., :3])
    params, losses = fit_scene(scene, target, cfg, steps=args.steps,
                               lr=args.lr, verbose=True)
    print("final loss:", losses[-1])
    for k, v in params.items():
        print(f"  {k} = {v}")
    return 0


def main(argv=None) -> int:
    import bhx

    bhx.enable_compile_cache()  # CLI entry point opts in
    parser = argparse.ArgumentParser(
        prog="bhx", description="differentiable black-hole renderer"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a frame to PNG")
    _add_scene_flags(pr)
    pr.add_argument("-o", "--output", default="render.png")
    pr.add_argument("--sharded", action="store_true",
                    help="tile-shard across all local devices")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="throughput benchmark")
    pb.add_argument("--width", type=int, default=1918)
    pb.add_argument("--height", type=int, default=1081)
    pb.add_argument("--iters", type=int, default=5)
    pb.add_argument("--dense", action="store_true", help="disable the ladder")
    pb.add_argument("--geodesics", choices=["pseudo", "kerr"],
                    default="pseudo")
    pb.add_argument("--spin", type=float, default=0.0)
    pb.set_defaults(fn=cmd_bench)

    pa = sub.add_parser("assets", help="generate / dump procedural assets")
    pa.add_argument("--regenerate", action="store_true")
    pa.add_argument("--dump", action="store_true")
    pa.set_defaults(fn=cmd_assets)

    pf = sub.add_parser("fit", help="inverse rendering: fit scene to image")
    _add_scene_flags(pf)
    pf.add_argument("--target", required=True)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.set_defaults(fn=cmd_fit)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
