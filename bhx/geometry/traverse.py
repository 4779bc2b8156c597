"""Device-side mesh intersection: batched BVH traversal / brute force.

The reference walks the BVH per ray with a 19-deep local stack inside the
march loop (trace_ray_model, ray.wgsl:287-363).  Two structural changes make
it a batched array program:

1. Mesh tests are *hoisted out of the march loop* entirely: the reference
   only ever intersects triangles along straight ray segments (outside the
   relativity sphere — ray.wgsl:541 vs :556), so bhx.tracer calls this
   module exactly twice per ray (primary segment + escape segment) on dense
   ray batches instead of per march step.

2. Traversal is lockstep-vectorized: every ray advances one BVH node per
   iteration of a single while_loop, with per-ray stacks held as (N, D)
   arrays.  Misses/finished rays are masked.  All node/triangle reads are
   XLA gathers.

For small meshes a gather-free brute-force path (scan over triangle chunks,
pure broadcasting) is selected automatically below
``brute_force_threshold`` triangles.

Mesh visibility gradients are inherently discontinuous, so results are
wrapped in stop_gradient by the tracer (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from bhx.geometry.intersect import MISS_T, T_MIN, hit_aabb, hit_triangles
from bhx.scene import Mesh

# Per-ray traversal stack depth.  The reference proves 19 suffices for a
# 500k-triangle midpoint BVH (ray.wgsl:293); 48 gives ample headroom.
STACK_DEPTH = 48

BRUTE_FORCE_THRESHOLD = 512
_TRI_CHUNK = 128


def intersect_mesh(origin, direction, mesh: Mesh, t_max=None, stack_depth=STACK_DEPTH):
    """Nearest triangle hit for each ray against one mesh.

    origin/direction: (N, 3).  Returns dict with t (N,), hit (N,),
    color (N, 3), normal (N, 3).  ``t_max`` optionally bounds the search
    (scalar or (N,)).
    """
    n = origin.shape[0]
    t_lim = jnp.full((n,), MISS_T) if t_max is None else jnp.broadcast_to(t_max, (n,))
    if mesh.num_triangles <= BRUTE_FORCE_THRESHOLD:
        return _intersect_brute(origin, direction, mesh, t_lim)
    return _intersect_bvh(origin, direction, mesh, t_lim, stack_depth)


def intersect_meshes(origin, direction, meshes, t_max=None):
    """Nearest hit across a tuple of meshes, honoring per-mesh visibility.

    Reference hit_ray's model loop (ray.wgsl:376-390), including the
    directional diffuse factor applied on the *winning* mesh hit
    (light = normalize(0.2, 0.2, -1), ray.wgsl:384-386).
    """
    n = origin.shape[0]
    best = {
        "t": jnp.full((n,), MISS_T),
        "hit": jnp.zeros((n,), bool),
        "color": jnp.zeros((n, 3)),
        "normal": jnp.zeros((n, 3)),
    }
    for mesh in meshes:
        res = intersect_mesh(origin, direction, mesh, t_max)
        res_hit = res["hit"] & mesh.visible
        closer = res_hit & (res["t"] < best["t"])
        best = {
            "t": jnp.where(closer, res["t"], best["t"]),
            "hit": best["hit"] | closer,
            "color": jnp.where(closer[:, None], res["color"], best["color"]),
            "normal": jnp.where(closer[:, None], res["normal"], best["normal"]),
        }
    light = jnp.array([0.2, 0.2, -1.0])
    light = light / jnp.linalg.norm(light)
    diffuse = jnp.sum(best["normal"] * light, axis=-1, keepdims=True)
    best["color"] = jnp.where(best["hit"][:, None], best["color"] * diffuse, best["color"])
    return best


def _gather_tri(mesh: Mesh, tri_idx):
    """Triangle vertex/normal fetch, world-positioned (tri_idx: (...,))."""
    tp = mesh.tri_points[tri_idx]  # (..., 3)
    tn = mesh.tri_normals[tri_idx]
    p = mesh.points[tp] + mesh.position  # (..., 3, 3)
    nrm = mesh.normals[tn]
    return p[..., 0, :], p[..., 1, :], p[..., 2, :], nrm[..., 0, :], nrm[..., 1, :], nrm[..., 2, :]


def _intersect_brute(origin, direction, mesh: Mesh, t_lim):
    """Scan over triangle chunks: rays (N,1,3) x tris (1,C,3), no gathers
    in the inner test — pure broadcasting."""
    ntris = mesh.num_triangles
    n = origin.shape[0]
    if ntris == 0:
        return {
            "t": jnp.full((n,), MISS_T),
            "hit": jnp.zeros((n,), bool),
            "color": jnp.zeros((n, 3)),
            "normal": jnp.zeros((n, 3)),
        }
    chunk = min(_TRI_CHUNK, ntris)
    pad = (-ntris) % chunk
    idx_all = jnp.arange(ntris + pad) % ntris  # wrap padding (duplicates are harmless)
    p1, p2, p3, n1, n2, n3 = _gather_tri(mesh, idx_all)
    tris = jnp.stack([p1, p2, p3, n1, n2, n3], axis=1)  # (T', 6, 3)
    tris = tris.reshape(-1, chunk, 6, 3)

    o = origin[:, None, :]
    d = direction[:, None, :]

    def body(carry, tri_chunk):
        bt, bc, bn = carry
        t, hit, color, normal = hit_triangles(
            o, d,
            tri_chunk[None, :, 0], tri_chunk[None, :, 1], tri_chunk[None, :, 2],
            tri_chunk[None, :, 3], tri_chunk[None, :, 4], tri_chunk[None, :, 5],
        )
        t = jnp.where(hit, t, MISS_T)
        k = jnp.argmin(t, axis=1)
        rows = jnp.arange(t.shape[0])
        tmin = t[rows, k]
        closer = tmin < bt
        bt = jnp.where(closer, tmin, bt)
        bc = jnp.where(closer[:, None], color[rows, k], bc)
        bn = jnp.where(closer[:, None], normal[rows, k], bn)
        return (bt, bc, bn), None

    init = (t_lim, jnp.zeros((n, 3)), jnp.zeros((n, 3)))
    (bt, bc, bn), _ = jax.lax.scan(body, init, tris)
    hit = bt < t_lim
    return {"t": jnp.where(hit, bt, MISS_T), "hit": hit, "color": bc, "normal": bn}


def _intersect_bvh(origin, direction, mesh: Mesh, t_lim, stack_depth):
    n = origin.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(direction) < 1e-12, 1e-12, direction)
    offset = mesh.position

    leaf_size = 4  # static unroll bound for leaf triangle tests

    state = dict(
        node=jnp.zeros((n,), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        stack=jnp.zeros((n, stack_depth), jnp.int32),
        active=jnp.ones((n,), bool),
        best_t=t_lim,
        color=jnp.zeros((n, 3)),
        normal=jnp.zeros((n, 3)),
    )

    # Skip rays that miss the root entirely.
    root_t = hit_aabb(origin, inv_dir, mesh.node_min[0] + offset, mesh.node_max[0] + offset)
    state["active"] = root_t < state["best_t"]

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        node = s["node"]
        count = mesh.node_count[node]
        left = mesh.node_left[node]
        is_leaf = count > 0

        # --- inner: order children near-first, push far child if useful ---
        c1, c2 = left, left + 1
        d1 = hit_aabb(origin, inv_dir, mesh.node_min[c1] + offset, mesh.node_max[c1] + offset)
        d2 = hit_aabb(origin, inv_dir, mesh.node_min[c2] + offset, mesh.node_max[c2] + offset)
        near = jnp.where(d1 <= d2, c1, c2)
        far = jnp.where(d1 <= d2, c2, c1)
        d_near = jnp.minimum(d1, d2)
        d_far = jnp.maximum(d1, d2)

        best_t = s["best_t"]
        color = s["color"]
        normal = s["normal"]

        # --- leaf: test up to leaf_size triangles (masked static unroll) ---
        for i in range(leaf_size):
            lane_ok = s["active"] & is_leaf & (i < count)
            tri_idx = mesh.lookup[jnp.clip(left + i, 0, mesh.lookup.shape[0] - 1)]
            p1, p2, p3, n1, n2, n3 = _gather_tri(mesh, tri_idx)
            t, hit, c, ng = hit_triangles(origin, direction, p1, p2, p3, n1, n2, n3)
            win = lane_ok & hit & (t < best_t)
            best_t = jnp.where(win, t, best_t)
            color = jnp.where(win[:, None], c, color)
            normal = jnp.where(win[:, None], ng, normal)

        # --- choose next node ---
        descend = (~is_leaf) & (d_near < best_t)
        push_far = descend & (d_far < best_t)
        sp = s["sp"]
        stack = s["stack"]
        stack = jnp.where(
            (s["active"] & push_far)[:, None]
            & (jnp.arange(stack_depth)[None, :] == sp[:, None]),
            far[:, None],
            stack,
        )
        sp = jnp.where(s["active"] & push_far, jnp.minimum(sp + 1, stack_depth - 1), sp)

        must_pop = (~descend) | is_leaf
        can_pop = sp > 0
        popped = stack[jnp.arange(n), jnp.maximum(sp - 1, 0)]
        new_node = jnp.where(must_pop, popped, near)
        new_sp = jnp.where(s["active"] & must_pop & can_pop, sp - 1, sp)
        new_active = s["active"] & (descend | can_pop)

        return dict(
            node=jnp.where(s["active"], new_node, node),
            sp=new_sp,
            stack=stack,
            active=new_active,
            best_t=best_t,
            color=color,
            normal=normal,
        )

    out = jax.lax.while_loop(cond, body, state)
    hit = out["best_t"] < t_lim
    return {
        "t": jnp.where(hit, out["best_t"], MISS_T),
        "hit": hit,
        "color": out["color"],
        "normal": out["normal"],
    }
