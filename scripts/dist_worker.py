#!/usr/bin/env python
"""Multi-process bring-up worker: one process of an N-process CPU cluster.

Launched by tests/test_multiprocess.py (and usable by hand) to exercise the
code path single-process runs do NOT cover: `jax.distributed.initialize` with
a real coordinator + multiple processes, a global mesh spanning
non-addressable devices, and one sharded inverse-rendering train step whose
parameter gradients all-reduce across process boundaries
(bhx/parallel.py:init_distributed; SURVEY.md §5 "Distributed communication
backend").

    python scripts/dist_worker.py <process_id> <num_processes> <port>

Prints "OK loss=<float>" on success; any failure exits nonzero.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bhx

bhx.enable_compile_cache()  # persistent XLA compile cache (explicit opt-in)



def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    # 2 virtual CPU devices per process; must be set before backend init.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from bhx.parallel import init_distributed

    init_distributed(
        coordinator=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()
    assert len(jax.local_devices()) == 2

    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bhx import assets
    from bhx.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx.parallel import (
        make_optimizer, scene_params, tile_mesh, train_step,
    )
    from bhx.pipeline import render
    from bhx.scene import Scene

    scene = Scene.default(
        disk_texture=assets.disk_texture(32),
        sky_texture=assets.sky_texture(64, 32, num_stars=50),
        temp_lut=assets.blackbody_lut(32, 8),
    )
    # Uncommitted (numpy) leaves so every process feeds identical host
    # values to the multi-controller jit.
    scene = jax.tree_util.tree_map(np.asarray, scene)

    cfg = RenderConfig(
        width=16, height=8, use_ladder=False, max_iterations=40,
        march_mode="diff", checkpoint_every=20,
        fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
        tonemap=False,
    )

    mesh = tile_mesh()  # global mesh over all processes' devices
    assert mesh.devices.size == 2 * nproc

    # Target rendered locally (identical on all processes), then assembled
    # into a global row-sharded array from each process's local shards.
    bh = dataclasses.replace(scene.black_hole, mass=np.float32(0.55))
    target_full = np.asarray(
        render(dataclasses.replace(scene, black_hole=bh), cfg)
    )
    sharding = NamedSharding(mesh, P("tiles"))
    target = jax.make_array_from_callback(
        target_full.shape, sharding, lambda idx: target_full[idx]
    )

    optimizer = make_optimizer(5e-3)
    params = jax.tree_util.tree_map(np.asarray, scene_params(scene))
    opt_state = optimizer.init(params)

    losses = []
    for _ in range(2):
        params, opt_state, loss = train_step(
            params, opt_state, scene, target, cfg, optimizer
        )
        losses.append(float(loss))  # replicated -> addressable everywhere
    assert all(np.isfinite(losses)), losses

    # Replicated params must agree across the LOCAL shards; the cross-
    # process agreement is implied by the all-reduce (and by loss parity,
    # which the launcher compares across worker stdouts).
    mass = params["mass"]
    vals = [np.asarray(s.data) for s in mass.addressable_shards]
    for v in vals[1:]:
        np.testing.assert_array_equal(vals[0], v)

    # --- kernel path across the process boundary ---
    # One shard_map'd pallas forward frame (interpret mode on CPU) over
    # the GLOBAL 2-process mesh: the composition shard_map + pallas_call +
    # non-addressable devices is exactly what single-process virtual-mesh
    # tests (test_dist.py) cannot reach.  Every process holds the full
    # scene host-side, so the single-process reference is computed
    # locally and compared shard-by-shard against the global result.
    from bhx.parallel import trace_image_sharded
    from bhx.tracer import trace_rays_record
    from bhx.tracer import camera_rays as _camera_rays

    pcfg = dataclasses.replace(cfg, march_mode="pallas_interpret")
    rec_global = trace_image_sharded(scene, pcfg, mesh, cfg.width, cfg.height)

    o, d = _camera_rays(scene.camera, cfg.width, cfg.height)
    rec_local = np.asarray(
        jax.jit(
            lambda o, d, s: trace_rays_record(
                o.reshape(-1, 3), d.reshape(-1, 3), s, pcfg
            ),
            static_argnums=(),
        )(o, d, scene)
    ).reshape(cfg.height, cfg.width, 8)

    for shard in rec_global.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), rec_local[shard.index], atol=1e-6,
            err_msg="sharded pallas trace != single-process trace",
        )
    print("OK pallas-crossproc")

    print(f"OK loss={losses[-1]:.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
