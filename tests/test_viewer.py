"""Viewer smoke tests: the exact request->config combinations the panel
can produce, driven through ViewerServer.render_frame (no HTTP).

The round-2 breakage shipped through an untested viewer config
combination (auto-mode pallas + panel kerr); these pin the viewer's
request plumbing on the kernel path (interpret mode on CPU).
"""

import json

import numpy as np
import pytest


def _server(march_mode="fast", w=64, h=36):
    from bhx.viewer import ViewerServer

    return ViewerServer(width=w, height=h, max_iterations=120,
                        march_mode=march_mode)


def _decode(png_bytes):
    from bhx.io import decode_png

    return decode_png(png_bytes)


BASE_REQ = {
    "pos": [0, 0, -19], "forward": [0, 0, 1], "fov": 1.0,
    "mass": 0.5, "spin": 0.0, "disk_inner": 2.0, "disk_outer": 10.0,
    "feather": 0.3, "time": 0.0,
    "show_disk": True, "show_texture": True, "show_redshift": True,
    "show_sky": True, "bloom": False, "mix_ratio": 0.7,
    "fxaa": False, "tonemap": False, "ladder": False,
    "kerr": False, "integrator": "euler", "step_size": 0.15,
    "max_iter": 120,
}


def test_viewer_default_frame_and_stats_header():
    srv = _server()
    png, stats = srv.render_frame(dict(BASE_REQ))
    img = _decode(png)
    assert img.shape == (36, 64, 3)
    assert img.max() > 0
    # Per-request stats carried in the X-Bhx-Stats header.
    assert stats["mrays_per_s"] > 0
    assert stats["frame_s"] > 0
    json.dumps(stats)  # must be serializable


def test_viewer_pallas_kerr_panel_combination():
    """The exact combination that broke round 2: kernel march mode with
    the panel's kerr toggle + ladder + rk45 selector."""
    srv = _server(march_mode="pallas_interpret")
    req = dict(BASE_REQ, kerr=True, spin=0.9, ladder=True,
               integrator="rk45", max_iter=80)
    png, stats = srv.render_frame(req)
    img = _decode(png)
    assert img.shape == (36, 64, 3)
    assert np.isfinite(stats["frame_s"])


def test_viewer_mesh_request():
    srv = _server()
    req = dict(BASE_REQ, mesh_enabled=True, obj_path="",
               mesh_visible=True, mesh_pos=[6.0, 0.0, -30.0],
               pos=[0, 0, -40])
    png, _ = srv.render_frame(req)
    img = _decode(png)
    assert img.shape == (36, 64, 3)


def test_viewer_overflow_stats_endpoint():
    srv = _server(march_mode="pallas_interpret", w=32, h=18)
    stats = srv.overflow_stats(dict(BASE_REQ))
    assert set(stats) >= {"overflow_frac", "dropped_total", "max_count"}
    assert 0.0 <= stats["overflow_frac"] <= 1.0
    # The diagnostic decodes the FULL request (ADVICE r4): turning the
    # panel's disk off must zero the crossing statistics.
    no_disk = srv.overflow_stats(dict(BASE_REQ, show_disk=False))
    assert no_disk["max_count"] == 0
    assert no_disk["overflow_frac"] == 0.0
    # jnp modes report the composites-unboundedly note instead.
    srv2 = _server(march_mode="fast")
    assert "note" in srv2.overflow_stats(dict(BASE_REQ))
