"""Tracer behavior tests: camera rays, alpha encoding, disk/horizon
compositing, mesh phases, ladder consistency (SURVEY.md §4.2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhx.config import Integrator
from bhx.pipeline import ladder_trace, render
from bhx.scene import Camera
from bhx.tracer import camera_rays, trace_image, trace_rays

from tests.common import DIFF_CFG, FAST_CFG, LADDER_CFG, cube_mesh, outside_camera, small_scene


def test_camera_rays_center_points_forward():
    cam = Camera.default()
    o, d = camera_rays(cam, 65, 37)
    center = np.asarray(d[18, 32])
    np.testing.assert_allclose(center, [0.0, 0.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(o[0, 0]), [0.0, 0.0, -19.0], atol=1e-6)
    # Unit directions everywhere.
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5
    )


def test_camera_rays_fov_extent():
    cam = Camera.default()  # fov = 1 rad
    w, h = 101, 51
    o, d = camera_rays(cam, w, h)
    # Horizontal edge pixel: ndc_x = (w-1)/2 * 2/(min(w,h)-1) = 2.0 at x edge
    # angle = atan(ndc / fov_factor); fov_factor = 1/tan(0.5)
    edge = np.asarray(d[25, -1])
    expected_angle = np.arctan(2.0 * np.tan(0.5))
    got = np.arctan2(abs(edge[0]), edge[2])
    assert got == pytest.approx(expected_angle, abs=1e-4)


def test_black_hole_shadow_darker_than_sky():
    scene = small_scene()
    img4 = trace_image(scene, FAST_CFG, 64, 36)
    a = np.asarray(img4)
    # Center pixels point at the hole -> absorbed (alpha 1, black-ish).
    cy, cx = 18, 32
    assert a[cy, cx, 3] == 1.0
    assert np.all(a[cy, cx, :3] < 0.6)
    # The default camera sits *inside* the relativity sphere (19 < 20), so
    # corner rays march out in >5 steps and carry the alpha-0 escape
    # encoding (same as the reference's i>5 classification).
    assert a[0, 0, 3] == 0.0


def test_escape_alpha_encoding_present():
    scene = small_scene()
    img4 = trace_image(scene, FAST_CFG, 64, 36)
    a = np.asarray(img4)
    # Rays that bent through the sphere and escaped carry alpha 0 with a
    # roughly unit direction vector.
    esc = a[..., 3] == 0.0
    assert esc.sum() > 10
    norms = np.linalg.norm(a[esc][:, :3], axis=-1)
    assert np.all(norms > 0.3) and np.all(norms < 1.5)


def test_disk_toggle_changes_image():
    scene = small_scene()
    cfg_off = dataclasses.replace(FAST_CFG, show_disk=False)
    img_on = np.asarray(trace_image(scene, FAST_CFG, 64, 36))
    img_off = np.asarray(trace_image(scene, cfg_off, 64, 36))
    assert np.abs(img_on - img_off).max() > 0.05


def test_redshift_toggle_changes_disk_color():
    scene = small_scene()
    cfg_no_shift = dataclasses.replace(FAST_CFG, show_redshift=False)
    img_on = np.asarray(trace_image(scene, FAST_CFG, 64, 36))
    img_off = np.asarray(trace_image(scene, cfg_no_shift, 64, 36))
    assert np.abs(img_on - img_off).max() > 0.01


def test_mass_zero_is_straight_lines():
    """With M=0 nothing bends: every ray either hits the disk plane/sky
    unbent; directions of escaped rays equal the camera ray directions."""
    scene = small_scene()
    bh = dataclasses.replace(
        scene.black_hole,
        mass=jnp.float32(0.0),
    )
    cfg = dataclasses.replace(FAST_CFG, show_disk=False)
    scene0 = dataclasses.replace(scene, black_hole=bh)
    o, d = camera_rays(scene0.camera, 64, 36)
    out = trace_rays(o.reshape(-1, 3), d.reshape(-1, 3), scene0, cfg)
    a = np.asarray(out)
    esc = a[:, 3] == 0.0
    d_flat = np.asarray(d.reshape(-1, 3))
    # Escaped rays keep their original direction (no bending, feather is
    # identity because closest approach stays large).
    dirs = a[esc][:, :3]
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(dirs, d_flat[esc], atol=1e-3)


def test_mesh_visible_outside_sphere():
    scene = small_scene()
    mesh = cube_mesh(position=(6.0, 0.0, -30.0))
    scene_m = dataclasses.replace(scene, meshes=(mesh,), camera=outside_camera())
    scene_nm = dataclasses.replace(scene, camera=outside_camera())
    img_m = np.asarray(trace_image(scene_m, FAST_CFG, 64, 36))
    img_nm = np.asarray(trace_image(scene_nm, FAST_CFG, 64, 36))
    delta = np.abs(img_m - img_nm)[..., :3].max()
    assert delta > 0.05, "cube should be visible"


def test_mesh_invisible_when_visibility_false():
    scene = small_scene()
    mesh = cube_mesh(position=(6.0, 0.0, -30.0))
    mesh = dataclasses.replace(mesh, visible=jnp.asarray(False))
    scene_m = dataclasses.replace(scene, meshes=(mesh,), camera=outside_camera())
    scene_nm = dataclasses.replace(scene, camera=outside_camera())
    img_m = np.asarray(trace_image(scene_m, FAST_CFG, 64, 36))
    img_nm = np.asarray(trace_image(scene_nm, FAST_CFG, 64, 36))
    np.testing.assert_allclose(img_m, img_nm, atol=1e-6)


def test_ladder_matches_dense_on_exact_pixels():
    """Ladder exact-copy pixels must equal the dense render of the coarse
    level (the compaction/scatter machinery must not corrupt them)."""
    scene = small_scene()
    img = np.asarray(ladder_trace(scene, LADDER_CFG))  # (H, W, 8) record
    lad = LADDER_CFG.ladder_for_output()
    w0, h0 = lad.resolution(0)
    from bhx.tracer import trace_image_record

    coarse = np.asarray(trace_image_record(scene, LADDER_CFG, w0, h0))
    m = lad.multiplier ** (lad.levels - 1)
    np.testing.assert_allclose(img[::m, ::m], coarse, atol=2e-3)


def test_diff_mode_matches_fast_mode():
    scene = small_scene()
    img_fast = np.asarray(trace_image(scene, FAST_CFG, 48, 27))
    cfg_diff = dataclasses.replace(
        DIFF_CFG, max_iterations=FAST_CFG.max_iterations
    )
    img_diff = np.asarray(trace_image(scene, cfg_diff, 48, 27))
    np.testing.assert_allclose(img_fast, img_diff, atol=2e-3)


def test_rk45_close_to_euler_visual():
    scene = small_scene()
    cfg_rk = dataclasses.replace(FAST_CFG, integrator=Integrator.RK45)
    img_e = np.asarray(trace_image(scene, FAST_CFG, 48, 27))
    img_rk = np.asarray(trace_image(scene, cfg_rk, 48, 27))
    # Same scene, different integrator: small differences only.
    frac_big = (np.abs(img_e - img_rk)[..., :3] > 0.2).mean()
    assert frac_big < 0.15


def test_frame_report_api():
    """frame_report (SURVEY.md §5 metrics) returns per-stage ms + Mrays/s
    for an arbitrary scene/config without touching private script code."""
    from bhx.profiling import frame_report
    from tests.common import FAST_CFG, small_scene

    rep = frame_report(small_scene(), FAST_CFG, iters=1)
    assert "dense trace" in rep and "sky finalize" in rep
    assert "full frame" in rep and rep["full frame"] >= 0.0
    assert rep["mrays_per_s"] > 0


@pytest.mark.parametrize("texture_mode", ["procedural", "array"])
def test_finalize_rows_matches_interleaved(texture_mode):
    """The frame's one sky pass (rows variant, every march mode) equals
    the interleaved finalize_image on the same record."""
    import jax.numpy as jnp

    from bhx.tracer import finalize_image, finalize_image_rows

    scene = small_scene()
    rng = np.random.default_rng(4)
    rec = rng.uniform(0, 1, (300, 8)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    rec[:, 5:8] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rec = jnp.asarray(rec)
    rows = finalize_image_rows(
        tuple(rec[:, i] for i in range(8)), scene.sky_texture, True,
        texture_mode,
    )
    ref = finalize_image(rec, scene.sky_texture, True, texture_mode)
    np.testing.assert_allclose(
        np.stack([np.asarray(r) for r in rows], -1), np.asarray(ref),
        atol=1e-5,
    )
