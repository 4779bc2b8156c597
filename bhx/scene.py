"""Scene pytrees: camera, black hole, meshes, textures.

The reference keeps CPU-side structs mirrored into GPU uniform/storage
buffers (src/scene/camera.rs:66-90, src/scene/blackhole.rs:37-98,
src/renderer/array_buffer.rs).  Here the scene is simply a JAX pytree whose
leaves are traced arrays — every leaf is differentiable, and "upload" is just
passing the pytree into a jitted function.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls=None, *, meta_fields: Tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree with the given static fields."""

    def wrap(c):
        c = dataclasses.dataclass(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return c

    return wrap(cls) if cls is not None else wrap


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


@_pytree_dataclass
class Camera:
    """Pinhole camera (reference src/scene/camera.rs).

    ``forward`` need not be normalized; ray generation normalizes.  The
    world-up used to build the camera basis is (0, -1, 0)
    (reference ray.wgsl:275), matching the reference's flipped-y convention.
    """

    position: jax.Array  # (3,)
    forward: jax.Array  # (3,)
    fov: jax.Array  # () radians, full vertical-ish angle (reference default 1.0)

    @staticmethod
    def default() -> "Camera":
        # Reference defaults: pos (0,0,-19), forward +z, fov 1 rad
        # (src/scene/camera.rs:10-16).
        return Camera(
            position=_f32([0.0, 0.0, -19.0]),
            forward=_f32([0.0, 0.0, 1.0]),
            fov=_f32(1.0),
        )

    def look_at(self, target) -> "Camera":
        fwd = _f32(target) - self.position
        return dataclasses.replace(self, forward=fwd / jnp.linalg.norm(fwd))

    def right(self) -> jax.Array:
        """normalize(forward x (0,-1,0)) — reference camera.rs:54-57."""
        r = jnp.cross(self.forward, _f32([0.0, -1.0, 0.0]))
        return r / jnp.linalg.norm(r)

    def rotated(self, yaw, pitch) -> "Camera":
        """Yaw about world +y then pitch about the current right axis
        (reference rotate_camera, camera.rs:26-35)."""

        def axis_rot(v, axis, angle):
            axis = axis / jnp.linalg.norm(axis)
            c, s = jnp.cos(angle), jnp.sin(angle)
            return (
                v * c
                + jnp.cross(axis, v) * s
                + axis * jnp.dot(axis, v) * (1.0 - c)
            )

        fwd = axis_rot(self.forward, _f32([0.0, 1.0, 0.0]), _f32(yaw))
        fwd = axis_rot(fwd, self.right(), _f32(pitch))
        return dataclasses.replace(self, forward=fwd)


@_pytree_dataclass
class BlackHole:
    """Black hole + accretion disk parameters (reference src/scene/blackhole.rs:16-28).

    ``mass`` generalizes the reference's hard-coded GM=1: the geodesic force,
    horizon draw radius and gravitational redshift all scale with it, so
    pixel gradients w.r.t. mass are meaningful.  ``spin`` is reserved for the
    Kerr metric (0 = Schwarzschild).
    """

    position: jax.Array  # (3,)
    mass: jax.Array  # ()
    spin: jax.Array  # () dimensionless a/M in [0, 1)
    disk_rotation: jax.Array  # (3,) Euler angles (reference accretion_disk_rotation)
    disk_inner: jax.Array  # ()
    disk_outer: jax.Array  # ()
    rotation_speed: jax.Array  # () disk texture angular speed
    relativity_radius: jax.Array  # () geodesic-integration sphere radius
    feather: jax.Array  # () feather_amount for the sphere-boundary blend
    horizon_radius: jax.Array  # () opaque-sphere draw radius (reference: 1.0)

    @staticmethod
    def default() -> "BlackHole":
        # mass 0.5 reproduces the reference's bending exactly (its
        # -1.5*h^2/r^4 force is a physical-mass-0.5 hole; see bhx.physics),
        # and its opaque sphere of radius 1 is then the Schwarzschild radius.
        return BlackHole(
            position=_f32([0.0, 0.0, 0.0]),
            mass=_f32(0.5),
            spin=_f32(0.0),
            disk_rotation=_f32([0.15, 0.0, 0.25]),
            disk_inner=_f32(2.0),
            disk_outer=_f32(10.0),
            rotation_speed=_f32(1.0),
            relativity_radius=_f32(20.0),
            feather=_f32(0.3),
            horizon_radius=_f32(1.0),
        )

    def disk_frame(self) -> Tuple[jax.Array, jax.Array]:
        """(rotation_matrix, disk_normal) from the Euler angles.

        Mirrors BlackHoleUniform::update (src/scene/blackhole.rs:70-98):
        the disk "up" vector is the rotated (0,-1,0); right = (0,0,1) x up;
        forward = right x up; matrix columns are [right, up, forward].
        Euler composition here is Rz @ Ry @ Rx (cgmath's Euler->Quaternion
        composes per-axis rotations; for the default angles (0.15, 0, 0.25)
        the two conventions agree to within normal ordering effects).
        """
        rx, ry, rz = self.disk_rotation[0], self.disk_rotation[1], self.disk_rotation[2]
        cx, sx = jnp.cos(rx), jnp.sin(rx)
        cy, sy = jnp.cos(ry), jnp.sin(ry)
        cz, sz = jnp.cos(rz), jnp.sin(rz)
        mat_x = jnp.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=jnp.float32)
        mat_y = jnp.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=jnp.float32)
        mat_z = jnp.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=jnp.float32)
        rot = mat_z @ mat_y @ mat_x
        up = rot @ _f32([0.0, -1.0, 0.0])
        up = up / jnp.linalg.norm(up)
        right = jnp.cross(_f32([0.0, 0.0, 1.0]), up)
        forward = jnp.cross(right, up)
        # Columns [right, up, forward]: M @ v = right*v.x + up*v.y + fwd*v.z.
        mat = jnp.stack([right, up, forward], axis=1)
        return mat, up


@_pytree_dataclass(meta_fields=("name",))
class Mesh:
    """A triangle mesh with a flat BVH, resident in device memory.

    Replaces the reference's 48 MB fixed-capacity ``Model`` struct
    (src/renderer/triangle.rs:75-80, uploaded every frame at
    array_buffer.rs:71-79).  Arrays are exactly sized and uploaded once.

    BVH layout (see bhx.geometry.bvh): node i has AABB
    [node_min[i], node_max[i]]; if node_count[i] == 0 its children are
    node_left[i] and node_left[i]+1, otherwise it is a leaf holding
    triangles lookup[node_left[i] : node_left[i]+node_count[i]].
    """

    points: jax.Array  # (P, 3) float32
    normals: jax.Array  # (Nn, 3) float32
    tri_points: jax.Array  # (T, 3) int32 indices into points
    tri_normals: jax.Array  # (T, 3) int32 indices into normals
    node_min: jax.Array  # (B, 3) float32
    node_max: jax.Array  # (B, 3) float32
    node_left: jax.Array  # (B,) int32
    node_count: jax.Array  # (B,) int32
    lookup: jax.Array  # (T,) int32
    position: jax.Array  # (3,) world offset (reference Model.position)
    visible: jax.Array  # () bool
    name: str = "mesh"

    @property
    def num_triangles(self) -> int:
        return self.tri_points.shape[0]


@_pytree_dataclass
class Scene:
    """The full differentiable scene.

    ``meshes`` is a (possibly empty) tuple of Mesh pytrees; tuples of pytrees
    flatten naturally, so each Mesh's arrays are traced leaves while the
    number of meshes (tuple length) is static structure.
    """

    camera: Camera
    black_hole: BlackHole
    disk_texture: jax.Array  # (Th, Tw, 4) float32 RGBA in [0,1]
    sky_texture: jax.Array  # (Sh, Sw, 3) float32 equirect
    temp_lut: jax.Array  # (Lh, Lw, 3) float32 (x=shift, y=temperature)
    time: jax.Array  # () seconds, drives disk texture rotation
    meshes: Tuple[Mesh, ...] = ()
    # Material palette, reference parity: MAX_MATERIALS=8 RGBA colors
    # (src/renderer/material.rs).  The reference binds but never reads them
    # (ray.wgsl:8 — `materials` unused in every shader function); kept so a
    # scene round-trips completely and future shading models can use them.
    materials: Optional[jax.Array] = None
    # Coarse multiplicative RGBA gain over the disk texture's uv square,
    # sampled gather-free via a hat-basis product (shading.sample_grid_mxu).
    # This is the differentiable disk-texture parameterization of the default
    # (procedural) mode: the procedural texel is pure arithmetic of uv, so
    # the learnable content lives here (default all-ones = identity).  In
    # "array" mode gradients flow through ``disk_texture`` itself instead.
    disk_gain: Optional[jax.Array] = None

    @staticmethod
    def default(
        disk_texture: Optional[Any] = None,
        sky_texture: Optional[Any] = None,
        temp_lut: Optional[Any] = None,
        meshes: Tuple[Mesh, ...] = (),
        lazy_assets: bool = True,
    ) -> "Scene":
        """Default scene mirroring the reference startup state.

        Textures default to the procedurally generated assets from
        :mod:`bhx.assets` (the reference ships pre-baked PNGs; two of them
        are missing from its tree, so all assets here are regenerated).
        """
        from bhx import assets

        if disk_texture is None:
            disk_texture = assets.disk_texture()
        if sky_texture is None:
            sky_texture = assets.sky_texture()
        if temp_lut is None:
            temp_lut = assets.blackbody_lut()
        return Scene(
            camera=Camera.default(),
            black_hole=BlackHole.default(),
            disk_texture=_f32(disk_texture),
            sky_texture=_f32(sky_texture),
            temp_lut=_f32(temp_lut),
            time=_f32(0.0),
            meshes=tuple(meshes),
            materials=jnp.ones((8, 4), jnp.float32),
            disk_gain=jnp.ones((16, 16, 4), jnp.float32),
        )


def scene_to_state(scene: Scene) -> dict:
    """Serializable (numpy) snapshot of a scene for checkpointing."""
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(scene))
