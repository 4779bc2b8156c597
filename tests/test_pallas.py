"""Pallas march kernel vs the jnp reference march (interpret mode on CPU).

The kernel's record-crossings design must reproduce the jnp tracer's output
(same physics, same compositing) — allclose over the whole image.
"""

import dataclasses

import jax
import numpy as np
import pytest

from bhx.config import Integrator
from bhx.tracer import trace_image

from tests.common import FAST_CFG, small_scene


def _compare(cfg_jnp, atol=3e-3, frac=0.01):
    scene = small_scene()
    # vote_every=4 (= the kernel's unroll) gives exact step budgets so the
    # comparison is not polluted by vote-interval overrun on capped rays.
    cfg_pl = dataclasses.replace(
        cfg_jnp, march_mode="pallas_interpret", pallas_vote_every=4,
        pallas_unroll=4,
    )
    img_jnp = np.asarray(trace_image(scene, cfg_jnp, 48, 27))
    img_pl = np.asarray(trace_image(scene, cfg_pl, 48, 27))
    # Allow a tiny fraction of pixels to differ (the kernel's conservative
    # early-exit bound can run a borderline ray a few extra steps).
    bad = (np.abs(img_jnp - img_pl) > atol).any(-1).mean()
    assert bad <= frac, f"{bad:.2%} pixels differ"


@pytest.mark.slow
def test_pallas_euler_matches_jnp():
    _compare(dataclasses.replace(FAST_CFG, max_iterations=200))


@pytest.mark.slow
def test_pallas_rk45_matches_jnp():
    _compare(
        dataclasses.replace(
            FAST_CFG, integrator=Integrator.RK45, max_iterations=200
        )
    )


@pytest.mark.slow
def test_pallas_kerr_matches_jnp():
    """The in-kernel Kerr march (Hamiltonian RK4, Kerr-Schild coordinates)
    must reproduce the jnp bhx.kerr path — same physics, same deferred
    compositing (the reference has no spin at all; its force is
    ray.wgsl:401-403)."""
    import jax.numpy as jnp

    scene = small_scene()
    bh = dataclasses.replace(scene.black_hole, spin=jnp.float32(0.8))
    scene_k = dataclasses.replace(scene, black_hole=bh)
    cfg_jnp = dataclasses.replace(
        FAST_CFG, geodesics="kerr", max_iterations=200
    )
    cfg_pl = dataclasses.replace(
        cfg_jnp, march_mode="pallas_interpret", pallas_vote_every=4,
        pallas_unroll=4,
    )
    img_jnp = np.asarray(trace_image(scene_k, cfg_jnp, 48, 27))
    img_pl = np.asarray(trace_image(scene_k, cfg_pl, 48, 27))
    # Kerr's adaptive step size makes step counts (and hence the few-iters
    # alpha classification) slightly more fragile than Euler's fixed h;
    # allow a slightly larger differing-pixel fraction.
    bad = (np.abs(img_jnp - img_pl) > 3e-3).any(-1).mean()
    assert bad <= 0.03, f"{bad:.2%} pixels differ"


def _random_slots(n, K, seed=0):
    """Synthetic crossing slots as tuple-of-rows: K*7 (n,) rows
    [hx hy hz dx dy dz valid] per slot, about half of them valid."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9, 9, (K, 3, n)).astype(np.float32)
    dirs = rng.normal(size=(K, 3, n)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = (rng.uniform(size=(K, n)) < 0.5).astype(np.float32)
    rows = np.concatenate([pos, dirs, valid[:, None, :]], axis=1)
    rows = rows.reshape(K * 7, n)
    cam = rng.uniform(15, 25, (n,)).astype(np.float32)
    return tuple(jnp.asarray(r) for r in rows), jnp.asarray(cam)


@pytest.mark.parametrize("gain", [False, True])
def test_composite_kernel_matches_jnp_reference(gain):
    """shade_composite (interpret) == its jnp reference on synthetic
    crossing slots, with and without a non-trivial disk_gain grid (the
    kernel samples it with indexed loads, the reference with a dense
    hat-basis contraction)."""
    import jax.numpy as jnp

    from bhx.kernels.shade_pallas import (
        ShadeKernelConfig, _composite_jnp, pack_shade_params,
        shade_composite,
    )

    scene = small_scene()
    bh = scene.black_hole
    rot, _ = bh.disk_frame()
    params = pack_shade_params(bh, rot, scene.time)
    slots, cam = _random_slots(300, 4)
    g = None
    if gain:
        rng = np.random.default_rng(3)
        g = jnp.asarray(rng.uniform(0.5, 1.5, (16, 16, 4)).astype(np.float32))
    kcfg = ShadeKernelConfig(interpret=True)
    out_k = np.stack([np.asarray(r) for r in shade_composite(
        slots, cam, params, g, kcfg)])
    # Both sides jitted: the texel's Perlin octaves amplify fusion-order
    # rounding, so eager vs jitted jnp alone differ by ~1e-3 on a few rays.
    ref = jax.jit(lambda s, c, p: _composite_jnp(s, c, p, g, kcfg))
    out_j = np.stack([np.asarray(r) for r in ref(slots, cam, params)])
    assert np.isfinite(out_k).all()
    np.testing.assert_allclose(out_k, out_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("extra", [-1, 3])
def test_ray_batch_padded_to_block_and_trimmed(extra):
    """The kernel path pads a ray batch to whole march-kernel blocks with
    dead rays and trims them again: any ray count gives one record row per
    ray, equal to the same rays traced inside a larger batch."""
    import jax.numpy as jnp

    from bhx.kernels.march_pallas import BLOCK
    from bhx.tracer import camera_rays, trace_rays_record_rows

    scene = small_scene()
    cfg = dataclasses.replace(
        FAST_CFG, march_mode="pallas_interpret", max_iterations=40,
    )
    o, d = camera_rays(scene.camera, 32, 8)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = BLOCK + extra
    rows = trace_rays_record_rows(o[:n], d[:n], scene, cfg)
    full = trace_rays_record_rows(o, d, scene, cfg)
    assert all(r.shape == (n,) for r in rows)
    np.testing.assert_allclose(
        np.stack([np.asarray(r) for r in rows]),
        np.stack([np.asarray(r)[:n] for r in full]), atol=1e-5,
    )
    assert jnp.isfinite(jnp.stack(rows)).all()


@pytest.mark.slow
def test_crossing_overflow_bounded_edge_on_disk():
    """K=4 crossing slots must suffice even for a near-edge-on disk with
    strong lensing: <0.1% of rays may drop a crossing (VERDICT r1 weak #6;
    reference composites unboundedly, ray.wgsl:571-580)."""
    import jax.numpy as jnp

    from bhx.scene import Camera
    from bhx.tracer import crossing_overflow_stats

    scene = small_scene()
    # Camera nearly in the disk plane, looking at the hole.
    cam = Camera(
        position=jnp.asarray([0.0, 0.35, -30.0], jnp.float32),
        forward=jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        fov=jnp.float32(1.2),
    )
    scene = dataclasses.replace(scene, camera=cam)
    cfg = dataclasses.replace(
        FAST_CFG, march_mode="pallas_interpret", max_iterations=400,
        pallas_vote_every=4, pallas_unroll=4,
    )
    stats = crossing_overflow_stats(scene, cfg, 64, 36)
    frac = float(stats["overflow_frac"])
    assert frac < 1e-3, f"{frac:.3%} rays dropped a crossing (K too small)"
