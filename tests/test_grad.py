"""Differentiability tests: autodiff pixel gradients vs central finite
differences (the BASELINE.md parity gate, SURVEY.md §4.3).

Hard visibility edges make raw FD unreliable: a pixel whose hit
classification flips between theta-eps and theta+eps shows an O(1/eps)
jump that no pointwise derivative matches.  The gate therefore compares AD
to FD only on FD-*stable* pixels — those where FD(eps) and FD(eps/2) agree
— which is exactly the piecewise-smooth set the reference's physics defines
(SURVEY.md §7 hard part 2).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhx.pipeline import render
from tests.common import DIFF_CFG, small_scene

CFG = dataclasses.replace(DIFF_CFG, width=40, height=24, max_iterations=200)


def _image_fn(update_scene, cfg):
    scene = small_scene()

    def f(theta):
        return render(update_scene(scene, theta), cfg)

    return f


def _check_grad_parity(update_scene, theta0, eps, min_stable_frac=0.5,
                       atol=3e-3, rtol=0.15, cfg=CFG):
    f = jax.jit(_image_fn(update_scene, cfg))
    theta0 = jnp.float32(theta0)

    # Forward-mode AD pixel derivative.
    _, ad = jax.jvp(f, (theta0,), (jnp.float32(1.0),))
    ad = np.asarray(ad)

    def fd(e):
        return np.asarray((f(theta0 + e) - f(theta0 - e)) / (2.0 * e))

    fd1 = fd(eps)
    fd2 = fd(eps * 0.5)
    scale = np.maximum(np.abs(fd1), np.abs(fd2))
    stable = np.abs(fd1 - fd2) <= 0.05 * scale + 1e-4
    frac = stable.mean()
    assert frac >= min_stable_frac, f"too few FD-stable pixels: {frac}"

    err = np.abs(ad - fd1)
    ok = err <= atol + rtol * np.abs(fd1)
    bad_frac = (~ok & stable).mean()
    assert bad_frac < 0.02, (
        f"AD/FD mismatch on {bad_frac:.1%} of stable pixels; "
        f"max err {err[stable].max():.4g}"
    )


@pytest.mark.slow
def test_grad_wrt_mass():
    def upd(scene, theta):
        bh = dataclasses.replace(scene.black_hole, mass=theta)
        return dataclasses.replace(scene, black_hole=bh)

    _check_grad_parity(upd, 0.5, eps=1e-3)


@pytest.mark.slow
def test_grad_wrt_camera_x():
    def upd(scene, theta):
        cam = dataclasses.replace(
            scene.camera,
            position=scene.camera.position + jnp.array([1.0, 0.0, 0.0]) * theta,
        )
        return dataclasses.replace(scene, camera=cam)

    _check_grad_parity(upd, 0.0, eps=1e-3)


@pytest.mark.slow
def test_grad_wrt_disk_outer():
    def upd(scene, theta):
        bh = dataclasses.replace(scene.black_hole, disk_outer=theta)
        return dataclasses.replace(scene, black_hole=bh)

    _check_grad_parity(upd, 10.0, eps=1e-2)


@pytest.mark.slow
def test_grad_wrt_spin_kerr():
    """FD parity for the Kerr spin gradient (exact-geodesic diff path).

    The reference has no spin at all (its force is ray.wgsl:401-403); spin
    gradients are a new capability and this is their parity gate."""
    def upd(scene, theta):
        bh = dataclasses.replace(scene.black_hole, spin=theta)
        return dataclasses.replace(scene, black_hole=bh)

    cfg = dataclasses.replace(
        CFG, geodesics="kerr", width=32, height=18, max_iterations=150
    )
    _check_grad_parity(upd, 0.5, eps=2e-3, cfg=cfg)


@pytest.mark.slow
def test_grad_wrt_disk_rotation_z():
    def upd(scene, theta):
        bh = dataclasses.replace(
            scene.black_hole,
            disk_rotation=scene.black_hole.disk_rotation
            + jnp.array([0.0, 0.0, 1.0]) * theta,
        )
        return dataclasses.replace(scene, black_hole=bh)

    _check_grad_parity(upd, 0.0, eps=2e-3)


@pytest.mark.slow
def test_grad_wrt_fov():
    def upd(scene, theta):
        cam = dataclasses.replace(scene.camera, fov=theta)
        return dataclasses.replace(scene, camera=cam)

    _check_grad_parity(upd, 1.0, eps=1e-3)


@pytest.mark.slow
def test_grad_wrt_camera_yaw():
    """Forward-direction gradient: yaw the camera about +y."""
    def upd(scene, theta):
        fwd = scene.camera.forward
        right = jnp.cross(jnp.array([0.0, -1.0, 0.0]), fwd)
        new_fwd = fwd + right * theta
        cam = dataclasses.replace(
            scene.camera, forward=new_fwd / jnp.linalg.norm(new_fwd)
        )
        return dataclasses.replace(scene, camera=cam)

    _check_grad_parity(upd, 0.0, eps=1e-3)


@pytest.mark.slow
def test_grad_wrt_mass_ladder_on():
    """Gradient parity THROUGH the coarse-to-fine ladder (the reference's
    adaptive grid, ray.wgsl:183-241) on the kernel path: the ladder stays
    enabled for march_mode="pallas" (pipeline.py), whose custom_vjp
    replays the jnp mirror under jax.grad; the interp-or-retrace select is
    piecewise-smooth, so AD must match FD away from decision boundaries.

    The kernel path is REVERSE-mode only (custom_vjp forbids jvp by
    construction), so the parity check projects the pixel gradient onto a
    fixed random probe: d/dtheta of sum(w * image) via jax.grad vs central
    FD of the same scalar, with an eps-halving stability guard."""
    from bhx.config import LadderConfig

    def upd(scene, theta):
        bh = dataclasses.replace(scene.black_hole, mass=theta)
        return dataclasses.replace(scene, black_hole=bh)

    cfg = dataclasses.replace(
        CFG, use_ladder=True, width=40, height=23,
        ladder=LadderConfig(base=(14, 9), multiplier=3, levels=2),
        max_iterations=128, march_mode="pallas_interpret",
        pallas_vote_every=4, pallas_unroll=4,
    )
    img_f = _image_fn(upd, cfg)
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.uniform(0.1, 1.0, (23, 40, 3)).astype(np.float32))
    f = jax.jit(lambda t: jnp.sum(w * img_f(t)))
    theta0 = jnp.float32(0.5)

    g_ad = float(jax.grad(f)(theta0))

    def fd(e):
        return (float(f(theta0 + e)) - float(f(theta0 - e))) / (2.0 * e)

    fd1, fd2 = fd(1e-3), fd(5e-4)
    assert np.isfinite(g_ad) and g_ad != 0.0
    # The weighted sum averages away isolated boundary flips; require the
    # FD itself to be stable before comparing.
    assert abs(fd1 - fd2) <= 0.1 * max(abs(fd1), abs(fd2)), (fd1, fd2)
    assert abs(g_ad - fd1) <= 0.1 * max(abs(g_ad), abs(fd1)), (g_ad, fd1)


@pytest.mark.slow
def test_grad_wrt_disk_texture_flows():
    """Reverse-mode gradient w.r.t. the disk texture array is nonzero and
    finite in texture_mode="array" (inverse-rendering main path).  The
    default procedural mode never reads the array (its learnable content is
    ``disk_gain`` — next test), so texture-array fitting pins array mode."""
    scene = small_scene()
    cfg = dataclasses.replace(CFG, texture_mode="array")

    def loss(tex):
        s = dataclasses.replace(scene, disk_texture=tex)
        return jnp.sum(render(s, cfg) ** 2)

    g = jax.grad(loss)(scene.disk_texture)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0


@pytest.mark.slow
def test_grad_wrt_disk_gain_flows_default_mode():
    """Under the DEFAULT (procedural) texture mode, the learnable disk
    content is the coarse multiplicative ``disk_gain`` grid; its
    reverse-mode gradient must be nonzero and finite."""
    scene = small_scene()

    def loss(gain):
        s = dataclasses.replace(scene, disk_gain=gain)
        return jnp.sum(render(s, CFG) ** 2)

    g = jax.grad(loss)(scene.disk_gain)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0


@pytest.mark.slow
def test_reverse_grad_finite_wrt_scene():
    """grad of a scalar loss w.r.t. (mass, fov, feather) is finite."""
    scene = small_scene()

    def loss(mass, fov, feather):
        bh = dataclasses.replace(scene.black_hole, mass=mass, feather=feather)
        cam = dataclasses.replace(scene.camera, fov=fov)
        s = dataclasses.replace(scene, black_hole=bh, camera=cam)
        return jnp.mean(render(s, CFG))

    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.float32(0.5), jnp.float32(1.0), jnp.float32(0.3)
    )
    for v in g:
        assert np.isfinite(float(v))
