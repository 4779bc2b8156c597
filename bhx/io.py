"""Image + scene I/O: PNG save/load, scene/config checkpoints.

Covers the reference's save path (texture_to_output_buffer + PNG encode,
renderer/mod.rs:435-486 — there a 256-byte-row-aligned GPU readback; here a
single device_get) and adds what it lacks: scene/config serialization and
render checkpoints (SURVEY.md §5 "Checkpoint / resume").
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from bhx.config import RenderConfig
from bhx.scene import Scene


def to_uint8(img) -> np.ndarray:
    a = np.asarray(img)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type <-> channel count (8-bit gray, gray+alpha, RGB, RGBA).
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """(H, W[, 1|2|3|4]) uint8 (or float in [0,1]) -> 8-bit PNG bytes,
    with nothing but the standard library (zlib + struct)."""
    import struct
    import zlib

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters (types 0-4) -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # Sub, Average and Paeth depend on the left neighbour.
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up = prev[x]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
                cur[x] = (cur[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """8-bit, non-interlaced gray/gray+alpha/RGB/RGBA PNG bytes ->
    (H, W, C) uint8, with nothing but the standard library."""
    import struct
    import zlib

    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace}); only 8-bit non-interlaced "
            "gray/RGB(A) is read"
        )
    c = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return pix.reshape(h, w, c)


def save_png(path: str, img) -> None:
    """img: (H, W, 3|4) float in [0,1] or uint8 -> 8-bit PNG file."""
    with open(path, "wb") as fp:
        fp.write(encode_png(img))


def load_image(path: str) -> np.ndarray:
    """8-bit PNG -> float32 (H, W, C) in [0,1] (reference texture.rs:10-76)."""
    with open(path, "rb") as fp:
        return decode_png(fp.read()).astype(np.float32) / 255.0


def save_scene(path: str, scene: Scene, cfg: Optional[RenderConfig] = None) -> None:
    """Scene arrays -> .npz next to a .json of static config."""
    flat: Dict[str, np.ndarray] = {}

    def put(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "meshes":
                continue
            if f.name == "name":
                continue
            flat[f"{prefix}{f.name}"] = np.asarray(v)

    put("camera.", scene.camera)
    put("bh.", scene.black_hole)
    for field in ("disk_texture", "sky_texture", "temp_lut", "time"):
        flat[field] = np.asarray(getattr(scene, field))
    if scene.disk_gain is not None:
        flat["disk_gain"] = np.asarray(scene.disk_gain)
    if scene.materials is not None:
        flat["materials"] = np.asarray(scene.materials)
    for i, mesh in enumerate(scene.meshes):
        put(f"mesh{i}.", mesh)
    flat["num_meshes"] = np.asarray(len(scene.meshes))
    np.savez_compressed(path, **flat)
    if cfg is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as fp:
            json.dump(config_to_dict(cfg), fp, indent=2, default=str)


def load_scene(path: str) -> Scene:
    import jax.numpy as jnp

    from bhx.scene import BlackHole, Camera, Mesh

    z = np.load(path)

    def get(prefix, cls, extra=None):
        kw = dict(extra or {})
        for f in dataclasses.fields(cls):
            key = f"{prefix}{f.name}"
            if key in z:
                kw[f.name] = jnp.asarray(z[key])
        return cls(**kw)

    meshes = []
    for i in range(int(z["num_meshes"])):
        meshes.append(get(f"mesh{i}.", Mesh, extra={"name": f"mesh{i}"}))
    return Scene(
        camera=get("camera.", Camera),
        black_hole=get("bh.", BlackHole),
        disk_texture=jnp.asarray(z["disk_texture"]),
        sky_texture=jnp.asarray(z["sky_texture"]),
        temp_lut=jnp.asarray(z["temp_lut"]),
        time=jnp.asarray(z["time"]),
        meshes=tuple(meshes),
        disk_gain=jnp.asarray(z["disk_gain"]) if "disk_gain" in z else None,
        materials=jnp.asarray(z["materials"]) if "materials" in z else None,
    )


def config_to_dict(cfg: RenderConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
