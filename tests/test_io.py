"""I/O round-trip tests: PNG, scene checkpoints."""

import os
import tempfile

import numpy as np
import pytest

from bhx.io import (
    decode_png,
    encode_png,
    load_image,
    load_scene,
    save_png,
    save_scene,
    to_uint8,
)
from tests.common import cube_mesh, small_scene


def test_png_roundtrip():
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.png")
        save_png(p, img)
        back = load_image(p)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_codec_roundtrip_exact(channels):
    """encode_png -> decode_png is lossless for every 8-bit layout."""
    img = np.random.default_rng(channels).integers(
        0, 256, (7, 5, channels), dtype=np.uint8
    )
    png = encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(png), img)


def _filtered_png(img: np.ndarray) -> bytes:
    """Encode with scanline filters Sub/Up/Average/Paeth in turn (what
    other encoders write), so decode_png's unfilter paths are exercised."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        ftype = 1 + y % 4
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        line = []
        for x in range(w * c):
            left = cur[x - c] if x >= c else 0
            ul = prev[x - c] if x >= c else 0
            up = prev[x]
            if ftype == 1:
                pred = left
            elif ftype == 2:
                pred = up
            elif ftype == 3:
                pred = (left + up) >> 1
            else:
                pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
                pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
            line.append((cur[x] - pred) & 0xFF)
        out += bytes([ftype] + line)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_decode_all_scanline_filters(channels):
    img = np.random.default_rng(9).integers(
        0, 256, (9, 6, channels), dtype=np.uint8
    )
    np.testing.assert_array_equal(decode_png(_filtered_png(img)), img)


def test_uint8_conversion_rounds():
    assert to_uint8(np.array([[[1.0, 0.0, 0.5]]])).tolist() == [[[255, 0, 128]]]


def test_scene_roundtrip_with_mesh():
    import dataclasses

    scene = small_scene()
    scene = dataclasses.replace(scene, meshes=(cube_mesh(),))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "scene.npz")
        save_scene(p, scene)
        back = load_scene(p)
    np.testing.assert_allclose(
        np.asarray(back.black_hole.mass), np.asarray(scene.black_hole.mass)
    )
    np.testing.assert_allclose(
        np.asarray(back.camera.position), np.asarray(scene.camera.position)
    )
    np.testing.assert_allclose(
        np.asarray(back.disk_texture), np.asarray(scene.disk_texture)
    )
    assert len(back.meshes) == 1
    np.testing.assert_allclose(
        np.asarray(back.meshes[0].points), np.asarray(scene.meshes[0].points)
    )
    np.testing.assert_array_equal(
        np.asarray(back.meshes[0].lookup), np.asarray(scene.meshes[0].lookup)
    )


def test_cli_assets_smoke(capsys):
    from bhx.cli import main

    assert main(["assets"]) == 0
    out = capsys.readouterr().out
    assert "disk" in out


def test_render_tiled_resume_bitexact(tmp_path):
    """Elastic recovery (SURVEY.md §5): a render interrupted after band 1
    resumes from its checkpoint and produces the uninterrupted result
    bit-for-bit (bhx.pipeline.render_tiled)."""
    import numpy as np

    from bhx.pipeline import render_tiled
    from tests.common import FAST_CFG, small_scene

    scene = small_scene()
    cfg = FAST_CFG  # 64x36: 3 bands of 16 rows
    ckpt = str(tmp_path / "bands.npz")

    full = np.asarray(render_tiled(scene, cfg, band_rows=16))

    # Simulate a crash: run bands but raise after the first checkpoint
    # write by monkey-limiting the band loop via a partial checkpoint —
    # simplest faithful simulation: run once with a checkpoint, then
    # truncate its next_band back to 1 (as if bands 2+ never happened).
    np.testing.assert_array_equal(
        full, np.asarray(render_tiled(scene, cfg, band_rows=16,
                                      checkpoint_path=ckpt))
    )
    z = dict(np.load(ckpt))
    rec = z["rec"].copy()
    rec[16:] = 0.0  # wipe bands 2+ as if they were never rendered
    np.savez_compressed(ckpt, rec=rec, next_band=1,
                        shape=z["shape"], band_rows=z["band_rows"])
    resumed = np.asarray(render_tiled(scene, cfg, band_rows=16,
                                      checkpoint_path=ckpt))
    np.testing.assert_array_equal(full, resumed)


def test_render_tiled_retries_transient_band_failure(monkeypatch, tmp_path):
    """Fault injection (SURVEY.md §5 "Failure detection"): a band trace
    that throws once is retried and the render completes identically to
    an uninterrupted run; a band that always throws propagates after the
    bounded retries with the checkpoint preserved."""
    import numpy as np

    import bhx.tracer as tracer
    from bhx.pipeline import render_tiled
    from tests.common import FAST_CFG, small_scene

    scene = small_scene()
    cfg = FAST_CFG
    full = np.asarray(render_tiled(scene, cfg, band_rows=16))

    real = tracer.trace_rays_record
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient device failure")
        return real(*a, **kw)

    monkeypatch.setattr(tracer, "trace_rays_record", flaky)
    out = np.asarray(render_tiled(scene, cfg, band_rows=16, max_retries=2))
    np.testing.assert_array_equal(full, out)
    assert calls["n"] >= 2  # first attempt failed, retry succeeded

    # Permanent failure: bounded retries then a contextful error; the
    # checkpoint written by completed bands survives for a later resume.
    def always_fail(*a, **kw):
        raise RuntimeError("injected permanent failure")

    monkeypatch.setattr(tracer, "trace_rays_record", always_fail)
    ckpt = str(tmp_path / "bands.npz")
    try:
        render_tiled(scene, cfg, band_rows=16, checkpoint_path=ckpt,
                     max_retries=1)
        raise AssertionError("expected RuntimeError")
    except RuntimeError as e:
        assert "band 1/3 failed after 2 attempts" in str(e)


def test_render_tiled_ignores_mismatched_checkpoint(tmp_path):
    """A checkpoint from a different frame shape/banding is ignored, not
    half-applied."""
    import numpy as np

    from bhx.pipeline import render_tiled
    from tests.common import FAST_CFG, small_scene

    scene = small_scene()
    cfg = FAST_CFG
    ckpt = str(tmp_path / "bands.npz")
    np.savez_compressed(
        ckpt, rec=np.full((9, 9, 8), 7.0, np.float32), next_band=1,
        shape=(9, 9), band_rows=3,
    )
    out = np.asarray(render_tiled(scene, cfg, band_rows=16,
                                  checkpoint_path=ckpt))
    full = np.asarray(render_tiled(scene, cfg, band_rows=16))
    np.testing.assert_array_equal(full, out)
