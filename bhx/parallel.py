"""Multi-device / multi-host parallelism: tile sharding + inverse rendering.

The reference is strictly single-GPU — its only "communication backend" is
one wgpu queue (SURVEY.md §2 "Parallelism components").  Here distribution
is a first-class subsystem, expressed in JAX's sharding API (XLA hands
the collectives to NCCL on GPUs):

* rays are embarrassingly parallel, so the image is **tile-sharded** over a
  1-D device mesh ("tiles" axis) with `jax.sharding.NamedSharding`; XLA
  GSPMD partitions the whole jitted render, keeping the march loop local to
  each device and inserting collectives only where the post chain needs
  neighbours;
* inverse rendering (the "training" workload) replicates scene parameters,
  shards the target image and pixel losses, and lets XLA all-reduce the
  parameter gradients during the checkpointed backward sweep;
* multi-host bring-up is `jax.distributed.initialize` + the same mesh over
  all processes' devices.

Tests exercise all of this on a CPU mesh of 8 virtual devices
(conftest.py); the same code runs unchanged on a host of GPUs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bhx.config import RenderConfig
from bhx.pipeline import render
from bhx.scene import Scene
from bhx.tracer import camera_rays, finalize_image, trace_rays_record

TILE_AXIS = "tiles"


def tile_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, named 'tiles'."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (TILE_AXIS,))


def init_distributed(coordinator: Optional[str] = None, **kw) -> None:
    """Multi-host process bring-up.

    Call BEFORE any other JAX API (touching ``jax.devices()`` or even
    ``jax.process_count()`` initializes the local backend, after which
    ``jax.distributed.initialize`` can no longer attach).  No-op when no
    coordinator is given (single-process run) or when a distributed client
    is already live (idempotent re-init).
    """
    import os

    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single-process: plain local backend
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized (idempotent)
    try:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)
    except Exception as e:
        # Surface cluster bring-up failures with actionable context
        # instead of a bare RPC traceback (SURVEY.md §5 "Failure
        # detection"): the coordinator address and process identity are
        # what an operator needs to debug a hung/unreachable rendezvous.
        raise RuntimeError(
            f"jax.distributed.initialize failed (coordinator="
            f"{coordinator!r}, {', '.join(f'{k}={v!r}' for k, v in kw.items())})"
            " — check that the coordinator process is reachable and that"
            " every process uses the same num_processes/coordinator"
        ) from e


def _pad_rows(h: int, n: int) -> int:
    return -(-h // n) * n


@partial(jax.jit, static_argnames=("cfg",))
def _trace_flat(o, d, scene, cfg):
    """Module-level jit so repeated sharded traces hit the cache (a
    closure-local jit would recompile on every call — the round-3 scaling
    harness measured exactly that)."""
    return trace_rays_record(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _trace_flat_shmap(o, d, scene, cfg, mesh):
    """Per-device trace via shard_map: each device runs the full
    trace_rays_record (jnp phases + Pallas march kernel) on its local ray
    shard with the scene replicated.

    This is the kernel path's distribution story: GSPMD cannot partition
    an opaque ``pallas_call`` (it would replicate its operands — an
    all-gather of the whole frame per device), while under shard_map the
    kernel simply launches per device on local tiles.  Rays are
    embarrassingly parallel, so the body needs no collectives at all; the
    jnp march modes keep the plain-GSPMD path (_trace_flat), which
    partitions their while loops natively.
    """
    def body(o_loc, d_loc, scene_loc):
        return trace_rays_record(
            o_loc.reshape(-1, 3), d_loc.reshape(-1, 3), scene_loc, cfg
        )

    return jax.shard_map(
        body, mesh=mesh, in_specs=(P(TILE_AXIS), P(TILE_AXIS), P()),
        out_specs=P(TILE_AXIS), check_vma=False,
    )(o, d, scene)


def trace_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                        width: int, height: int):
    """Dense trace with pixel rows sharded across the mesh.

    Returns the (height, width, 8) sky-free record (bhx.tracer record
    layout).  Rays are generated host-side-of-jit, resharded row-wise,
    traced under GSPMD (jnp march modes) or shard_map (Pallas kernel
    modes — see _trace_flat_shmap), and the result is reassembled (still
    sharded — downstream ops decide layout).
    """
    o, d = camera_rays(scene.camera, width, height)
    n = mesh.devices.size
    hp = _pad_rows(height, n)
    pad = hp - height
    if pad:
        o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (pad, width, 3))], axis=0)
        d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (pad, width, 3))], axis=0)
    row_sharding = NamedSharding(mesh, P(TILE_AXIS))
    o = jax.device_put(o.reshape(hp * width, 3).reshape(n, -1, 3), row_sharding)
    d = jax.device_put(d.reshape(hp * width, 3).reshape(n, -1, 3), row_sharding)
    scene_rep = jax.device_put(scene, NamedSharding(mesh, P()))

    if cfg.march_mode in ("pallas", "pallas_interpret"):
        out = _trace_flat_shmap(o, d, scene_rep, cfg, mesh)
    else:
        out = _trace_flat(o, d, scene_rep, cfg)
    return out.reshape(hp, width, 8)[:height]


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Full render with the trace tile-sharded over the mesh.

    The post chain runs on the gathered image (it is <1% of frame cost; a
    sharded post chain with halo exchange is a later optimization).
    """
    mesh = mesh or tile_mesh()
    from bhx.post import bloom_chain, fxaa_pass, mix_pass, tonemap_pass

    rec = trace_image_sharded(scene, cfg, mesh, cfg.width, cfg.height)

    @partial(jax.jit, static_argnames=("cfg",))
    def post(rec, scene, cfg):
        rgb = finalize_image(rec, scene.sky_texture, cfg.show_sky, cfg.texture_mode)
        if cfg.bloom.enabled:
            rgb = mix_pass(rgb, bloom_chain(rgb, cfg.bloom), cfg.bloom.mix_ratio)
        if cfg.tonemap:
            rgb = tonemap_pass(rgb)
        if cfg.fxaa.enabled:
            rgb = fxaa_pass(rgb, cfg.fxaa)
        return rgb

    return post(rec, scene, cfg)


def bench_scaling(
    scene: Scene,
    cfg: RenderConfig,
    device_counts=None,
    repeats: int = 3,
    width: Optional[int] = None,
    height: Optional[int] = None,
):
    """Rays/s of the sharded trace at 1, 2, 4, ... devices.

    BASELINE.md's second headline metric ("~linear rays/s at 1 chip ->
    N hosts").  Each entry times ``trace_image_sharded`` on a mesh of the
    first ``n`` devices and reports throughput plus efficiency relative
    to perfect scaling from the 1-device row.  On a virtual CPU mesh
    (tests/dev boxes) the devices share host cores, so efficiency there
    measures *overhead of the sharded program*, not hardware scaling —
    SCALING.json records the platform so the two aren't conflated.
    """
    import time

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    w = width or cfg.width
    h = height or cfg.height
    rows = []
    base_rate = None

    sync = jax.block_until_ready

    for n in device_counts:
        mesh = tile_mesh(devs[:n])
        sync(trace_image_sharded(scene, cfg, mesh, w, h))  # compile
        sync(trace_image_sharded(scene, cfg, mesh, w, h))  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = trace_image_sharded(scene, cfg, mesh, w, h)
            sync(out)
            best = min(best, time.perf_counter() - t0)
        rate = (w * h) / best
        if base_rate is None:
            base_rate = rate
        rows.append(
            dict(
                devices=n,
                seconds=best,
                rays_per_s=rate,
                mrays_per_s=rate / 1e6,
                # Hardware-scaling efficiency (meaningful on real chips).
                efficiency=rate / (base_rate * n),
                # Sharded-program overhead: total throughput vs the
                # 1-device program on the SAME total work.  On a virtual
                # CPU mesh (devices share host cores) this is the only
                # meaningful number — it must stay near 1.0 or the GSPMD
                # partitioning itself is adding cost (tests gate >= 0.8).
                overhead_efficiency=rate / base_rate,
                platform=devs[0].platform,
                device_kind=devs[0].device_kind,
            )
        )
    return rows


# ---------------------------------------------------------------------------
# Inverse rendering (the training workload)
# ---------------------------------------------------------------------------

# The differentiable parameter subset used by fit_scene / the dry run.
# ``spin`` only influences the image under geodesics="kerr" (its gradient is
# exactly zero in pseudo-Newtonian mode, which Adam handles fine).
PARAM_FIELDS = (
    "mass", "spin", "disk_rotation", "disk_inner", "disk_outer", "feather",
)
CAMERA_FIELDS = ("position", "fov")


def scene_params(scene: Scene) -> Dict[str, Any]:
    p = {f: getattr(scene.black_hole, f) for f in PARAM_FIELDS}
    p.update({f"cam_{f}": getattr(scene.camera, f) for f in CAMERA_FIELDS})
    return p


def apply_params(scene: Scene, params: Dict[str, Any]) -> Scene:
    bh = dataclasses.replace(
        scene.black_hole, **{f: params[f] for f in PARAM_FIELDS}
    )
    cam = dataclasses.replace(
        scene.camera, **{f: params[f"cam_{f}"] for f in CAMERA_FIELDS}
    )
    return dataclasses.replace(scene, black_hole=bh, camera=cam)


def make_optimizer(lr: float = 1e-2):
    import optax

    return optax.adam(lr)


@partial(jax.jit, static_argnames=("cfg", "optimizer"))
def train_step(params, opt_state, scene: Scene, target, cfg: RenderConfig,
               optimizer):
    """One inverse-rendering step: L2 image loss -> grads -> adam update.

    Under a tile-sharded target, XLA partitions the forward+backward sweep
    by pixels and all-reduces the (replicated) parameter gradients.
    """

    def loss_fn(p):
        s = apply_params(scene, p)
        img = render(s, cfg)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state)
    import optax

    params = optax.apply_updates(params, updates)
    return params, opt_state, loss


def fit_scene(
    scene: Scene,
    target,
    cfg: RenderConfig,
    steps: int = 100,
    lr: float = 1e-2,
    mesh: Optional[Mesh] = None,
    verbose: bool = False,
) -> Tuple[Dict[str, Any], list]:
    """Fit scene parameters to a target image (gradient descent)."""
    mesh = mesh or tile_mesh()
    optimizer = make_optimizer(lr)
    params = scene_params(scene)
    opt_state = optimizer.init(params)
    target = jax.device_put(
        jnp.asarray(target), NamedSharding(mesh, P(TILE_AXIS))
    )
    losses = []
    for i in range(steps):
        params, opt_state, loss = train_step(
            params, opt_state, scene, target, cfg, optimizer
        )
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return params, losses
