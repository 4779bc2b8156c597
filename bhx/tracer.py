"""The geodesic ray tracer: phase-decomposed, batched, differentiable.

Re-designs the reference's per-pixel megakernel loop (trace_ray,
ray.wgsl:482-596) into a batched array pipeline.  The reference interleaves
three very different workloads in one divergent loop:

  (a) straight-line scene tests outside the "relativity sphere"
      (meshes + sphere entry — ray.wgsl:554-569),
  (b) the geodesic march inside the sphere (integrator + BH/disk segment
      tests — ray.wgsl:522-553),
  (c) boundary feathering on exit (ray.wgsl:543-553).

Observing that mesh BVH traversal only ever happens on straight segments,
we split the tracer into alternating *straight* and *march* phases over
dense ray batches:

  straight -> [march -> straight] x ROUNDS

Each straight phase is two batched intersections (meshes via
bhx.geometry.traverse, sphere analytically); each march phase is an
elementwise masked loop with no gathers except the disk-texture sample.  Rays that exit
the sphere re-run a straight phase (which also handles the rare re-entry of
strongly bent rays — the reference's outside branch does the same,
ray.wgsl:563-565).

Differentiability: march mode "diff" uses a fixed-length, chunk-checkpointed
lax.scan (reverse-differentiable through the whole integrator sweep); mode
"fast" uses an early-exiting lax.while_loop for forward-only rendering.
Mesh visibility is wrapped in stop_gradient (hard visibility has no useful
gradient).  Output alpha encoding matches the reference exactly: escaped
rays return (escape_direction, 0), everything else (color, 1) with sky
composited (ray.wgsl:583-595).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from bhx.config import Integrator, RenderConfig
from bhx.geometry.intersect import MISS_T, T_MIN, hit_annulus, hit_sphere, hit_sphere_both
from bhx.geometry.traverse import intersect_meshes
from bhx.integrate import euler_step, rk45_step
from bhx.scene import Scene
from bhx.shading import disk_shade, sample_sky

# How many march->straight rounds to run: round 0 handles all primary
# entries; later rounds handle the rare re-entry of strongly bent rays.
DEFAULT_ROUNDS = 2


def camera_rays(camera, width: int, height: int) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel ray origins/directions (reference create_ray ray.wgsl:269-285).

    Returns origins (H, W, 3), directions (H, W, 3).  NDC scale is
    2 / (min(W, H) - 1) about the image center; the camera basis uses
    world-up (0, -1, 0) to match the reference's flipped-y convention.
    """
    sm = min(width, height) - 1
    inc = 2.0 / sm
    xs = (jnp.arange(width, dtype=jnp.float32) - (width - 1) / 2.0) * inc
    ys = (jnp.arange(height, dtype=jnp.float32) - (height - 1) / 2.0) * inc
    px, py = jnp.meshgrid(xs, ys, indexing="xy")  # (H, W)

    fwd = camera.forward / jnp.linalg.norm(camera.forward)
    plane_up = jnp.array([0.0, -1.0, 0.0])
    right = jnp.cross(fwd, plane_up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(fwd, right)
    up = up / jnp.linalg.norm(up)
    fov_factor = 1.0 / jnp.tan(camera.fov / 2.0)

    d = (
        px[..., None] * right
        + py[..., None] * up
        + fov_factor * fwd
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(camera.position, d.shape)
    return o, d


def _init_state(origins, directions, deferred: bool = False):
    """Canonical tracer state: PER-COMPONENT ROWS (structure-of-arrays).

    Every vector quantity is three (n,) rows (px/py/pz, dx/dy/dz, the
    original direction ox/oy/oz, Kerr momentum qx/qy/qz, color cr/cg/cb)
    — the Pallas kernels consume rows, so the march phases stay
    stack-free end-to-end.  The jnp
    march modes convert to (n, 3) at their phase boundary only (a few
    stacks per trace, nothing per step).
    """
    n = origins.shape[0]
    f = jnp.float32
    o32 = origins.astype(f)
    d32 = directions.astype(f)
    zeros = jnp.zeros((n,), f)
    state = dict(
        px=o32[:, 0], py=o32[:, 1], pz=o32[:, 2],
        dx=d32[:, 0], dy=d32[:, 1], dz=d32[:, 2],
        ox=d32[:, 0], oy=d32[:, 1], oz=d32[:, 2],
        cr=zeros, cg=zeros, cb=zeros,
        amount=jnp.ones((n,), f),
        hit=jnp.zeros((n,), bool),
        # status: 0 = needs straight phase, 1 = marching, 2 = done-escaped,
        # 3 = done-absorbed (opaque hit / captured)
        status=jnp.zeros((n,), jnp.int32),
        march_steps=jnp.zeros((n,), jnp.int32),
        entered=jnp.zeros((n,), bool),
        h=zeros,
        closest=zeros,
        # Spatial conjugate momentum for exact-Kerr marching (bhx.kerr);
        # unused (zeros) in pseudo-Newtonian mode.
        qx=zeros, qy=zeros, qz=zeros,
    )
    if deferred:
        # Pallas mode: nothing composites during the trace.  March phases
        # accumulate crossing slots; straight phases record at most one
        # opaque mesh hit; capture sets a flag.  One batched shade +
        # composite runs at the end — exact, because a mesh hit absorbs the
        # ray (no later crossings) and every recorded crossing precedes it.
        from bhx.kernels.march_pallas import CROSS_FIELDS, MarchKernelConfig

        K = MarchKernelConfig.max_crossings
        state.update(
            # Crossing slots are a TUPLE of K*CROSS_FIELDS (n,) rows:
            # row k*CROSS_FIELDS+f is slot k's field f — matching the
            # march kernel's tuple-of-rows output so no relayout or
            # stacking ever happens (march_pallas.py layout note).
            slots=tuple(
                jnp.zeros((n,), f) for _ in range(K * CROSS_FIELDS)
            ),
            count=zeros,
            mcr=zeros, mcg=zeros, mcb=zeros,
            mesh_hit=jnp.zeros((n,), bool),
            horizon=jnp.zeros((n,), bool),
            # True (uncapped) disk-crossing count from the kernel; crossings
            # beyond the K record slots are dropped from shading — the
            # difference vs `count` measures that (tests bound it).
            true_count=zeros,
            # Running transmission upper bound (the kernel's pow-free
            # early-exit bound), carried across phases.
            amount_ub=jnp.ones((n,), f),
        )
    return state


def _merge_slots(slots_a, count_a, slots_b, count_b, K: int):
    """Append slot list b after a's existing entries, preserving order:
    merged[i] <- b[i - count_a] (O(K^2) selects, no gathers).

    Slots are tuples of K*CROSS_FIELDS (n,) rows (the kernel's
    tuple-of-rows layout).  Cost note: in the default configuration this
    never executes on the hot path — pallas_round_steps >= max_iterations
    makes every march single-round, and the only callers are the
    lax.cond-gated re-entry round / re-entry phase, which skip when no
    ray re-enters (the common case; see trace_rays_record_rows).  The
    K=4 select pyramid is ~70 where-ops over (n,) rows when it does run.
    """
    from bhx.kernels.march_pallas import CROSS_FIELDS as CF

    merged = list(slots_a)
    for i in range(K):
        keep = (count_a > float(i)) | (slots_a[i * CF + 6] > 0.5)
        sels = [count_a == float(i - j) for j in range(0, i + 1)]
        for f in range(CF):
            take = jnp.zeros_like(slots_b[f])
            for j in range(0, i + 1):
                take = jnp.where(sels[j], slots_b[j * CF + f], take)
            merged[i * CF + f] = jnp.where(keep, merged[i * CF + f], take)
    return tuple(merged), jnp.clip(count_a + count_b, 0.0, float(K))


def _straight_phase(state, scene: Scene, cfg: RenderConfig, cam_dist):
    """Straight-ray scene test for rays with status 0, on the rows state.

    Mirrors the reference's outside branch (ray.wgsl:554-569): nearest of
    (mesh hit, relativity-sphere entry) wins; a mesh hit composites and
    absorbs (meshes are opaque); a sphere hit advances the ray to the
    boundary and switches it to marching; neither -> done (escape).
    """
    bh = scene.black_hole
    mask = state["status"] == 0
    px, py, pz = state["px"], state["py"], state["pz"]
    dx, dy, dz = state["dx"], state["dy"], state["dz"]

    # Relativity-sphere roots (hit_sphere_both, component form).
    ocx = px - bh.position[0]
    ocy = py - bh.position[1]
    ocz = pz - bh.position[2]
    r_sphere = bh.relativity_radius
    a_q = dx * dx + dy * dy + dz * dz
    b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    c_q = oc2 - r_sphere * r_sphere
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b_q - sq) / (2.0 * a_q)
    t2 = (-b_q + sq) / (2.0 * a_q)
    real = disc > 0.0
    # Nearest root in (T_MIN, T_MAX) — reference hit_sphere semantics.
    v1 = real & (t1 > T_MIN) & (t1 < MISS_T)
    v2 = real & (t2 > T_MIN) & (t2 < MISS_T)
    sphere_t = jnp.where(v1, t1, jnp.where(v2, t2, MISS_T))
    sphere_hit = v1 | v2

    inside = oc2 < r_sphere * r_sphere

    if cfg.render_meshes and len(scene.meshes) > 0:
        # BVH traversal works on (n, 3) vectors; stack at this boundary
        # only (meshes are an optional scene feature — the default bench
        # scene has none and never pays these stacks).
        pos3 = jnp.stack([px, py, pz], axis=-1)
        d3 = jnp.stack([dx, dy, dz], axis=-1)
        mesh = intersect_meshes(pos3, d3, scene.meshes)
        mesh = jax.tree_util.tree_map(jax.lax.stop_gradient, mesh)
        mesh_t = mesh["t"]
        mesh_hit_now = mesh["hit"]
        mc = jnp.clip(mesh["color"], 0.0, 1.0)
        mcr_n, mcg_n, mcb_n = mc[..., 0], mc[..., 1], mc[..., 2]
    else:
        mesh_t = jnp.full_like(px, MISS_T)
        mesh_hit_now = jnp.zeros_like(mask)
        mcr_n = mcg_n = mcb_n = jnp.zeros_like(px)

    enters = mask & (inside | (sphere_hit & (sphere_t < mesh_t)))
    mesh_wins = mask & ~enters & mesh_hit_now
    escapes = mask & ~enters & ~mesh_hit_now

    # Opaque mesh hit (reference ray.wgsl:571-576 with opacity 1).
    if "mesh_hit" in state:
        # Deferred compositing (pallas mode): record the hit; the final
        # composite weights it by the transmission through all recorded
        # disk crossings (all of which precede the hit on this ray).
        cr, cg, cb = state["cr"], state["cg"], state["cb"]
        amount = state["amount"]
        extra = dict(
            mcr=jnp.where(mesh_wins, mcr_n, state["mcr"]),
            mcg=jnp.where(mesh_wins, mcg_n, state["mcg"]),
            mcb=jnp.where(mesh_wins, mcb_n, state["mcb"]),
            mesh_hit=state["mesh_hit"] | mesh_wins,
        )
    else:
        amount0 = state["amount"]
        cr = jnp.where(mesh_wins, state["cr"] + amount0 * mcr_n, state["cr"])
        cg = jnp.where(mesh_wins, state["cg"] + amount0 * mcg_n, state["cg"])
        cb = jnp.where(mesh_wins, state["cb"] + amount0 * mcb_n, state["cb"])
        amount = jnp.where(mesh_wins, 0.0, amount0)
        extra = {}
    hit = state["hit"] | mesh_wins

    # Advance entering rays to the boundary (no-op if already inside).
    do_adv = enters & ~inside
    adv_t = jnp.where(do_adv, sphere_t, 0.0)
    npx = px + dx * adv_t
    npy = py + dy * adv_t
    npz = pz + dz * adv_t

    status = jnp.where(
        enters,
        jnp.int32(1),
        jnp.where(mesh_wins, jnp.int32(3), jnp.where(escapes, jnp.int32(2), state["status"])),
    )

    nrx = npx - bh.position[0]
    nry = npy - bh.position[1]
    nrz = npz - bh.position[2]
    updates = dict(
        px=npx, py=npy, pz=npz,
        cr=cr, cg=cg, cb=cb,
        amount=amount,
        hit=hit,
        status=status,
        entered=state["entered"] | enters,
        h=jnp.where(enters, jnp.float32(cfg.step_size), state["h"]),
        closest=jnp.where(
            enters, jnp.sqrt(nrx * nrx + nry * nry + nrz * nrz),
            state["closest"],
        ),
        **extra,
    )
    if cfg.geodesics == "kerr":
        from bhx import kerr

        mom_new = kerr.null_momentum(
            jnp.stack([nrx, nry, nrz], axis=-1),
            jnp.stack([dx, dy, dz], axis=-1),
            bh.mass, bh.spin,
        )
        updates["qx"] = jnp.where(enters, mom_new[:, 0], state["qx"])
        updates["qy"] = jnp.where(enters, mom_new[:, 1], state["qy"])
        updates["qz"] = jnp.where(enters, mom_new[:, 2], state["qz"])
    state = dict(state)
    state.update(updates)
    return state


def march_kernel_config(cfg: RenderConfig):
    """The march kernel's static config for a render config.  Every round
    runs the same kernel for ``pallas_round_steps`` steps; the *total*
    budget rides in the params vector and each lane deactivates itself
    exactly when its cumulative step count reaches it."""
    from bhx.kernels.march_pallas import MarchKernelConfig

    return MarchKernelConfig(
        integrator="euler" if cfg.integrator == Integrator.EULER else "rk45",
        geodesics=cfg.geodesics,
        max_iterations=max(
            1, min(int(cfg.pallas_round_steps), cfg.max_iterations)
        ),
        tex_opacity_min=0.7 if (cfg.show_disk_texture and cfg.show_disk) else 1.0,
        show_disk=cfg.show_disk,
        vote_every=cfg.pallas_vote_every,
        unroll=cfg.pallas_unroll,
        bwd_chunks=cfg.pallas_bwd_chunks,
        record_guard=cfg.pallas_record_guard,
        interpret=cfg.march_mode == "pallas_interpret",
    )


def _march_phase_pallas(state, scene: Scene, cfg: RenderConfig, cam_dist,
                        sparse: bool = False, first_phase: bool = True):
    """Pallas-kernel march with deferred shading; no host-side compaction.

    Sparse active sets (the ladder's needs-retrace mask, round >= 2
    re-entries) ride into the kernel as the per-lane activity mask, NOT
    through a gather/scatter compaction: the kernel's while cond votes
    before the first step, so an all-dead block costs only its loads and
    stores, and the active set is spatially clustered in image order
    (the disk/shadow region), so block-granular early exit already tracks
    the active count.  Whether a compaction pays on a GPU is an open
    question (PERF.md).

    Multi-round marching (``cfg.pallas_round_steps`` < max_iterations)
    still works: per-ray budgets ride into the kernel (input field 9 +
    params "budget"), rounds repeat in a lax.while_loop that stops when no
    lane is active.  Crossing slots recorded by each round are merged into
    per-ray accumulators (cheap selects) and shaded *once* after the last
    round — texture/LUT gathers happen exactly one time per ray regardless
    of the round count.  Compositing order is preserved because slots
    accumulate in crossing order and shading depends only on crossing
    geometry.
    """
    from bhx.kernels.march_grad import march_pallas_diff
    from bhx.kernels.march_pallas import (
        BLOCK,
        CROSS_FIELDS,
        MarchKernelConfig,
        OUT_FIXED,
        pack_params,
    )

    bh = scene.black_hole
    rot_mat, disk_normal = bh.disk_frame()
    n = state["px"].shape[0]
    K = MarchKernelConfig.max_crossings

    kcfg = march_kernel_config(cfg)
    n_rounds = -(-cfg.max_iterations // kcfg.max_iterations)
    pad = (-n) % BLOCK
    npad = n + pad

    params = pack_params(bh, disk_normal, cfg)

    def padded(x, fill=0.0):
        if pad == 0:
            return x
        shape = (pad,) + x.shape[1:]
        return jnp.concatenate([x, jnp.full(shape, fill, x.dtype)], axis=0)

    was = state["status"] == 1
    kerr = kcfg.geodesics == "kerr"
    # The tracer state is already rows (structure-of-arrays), the exact
    # tuple-of-rows layout the kernel consumes — no slicing, no stacking,
    # only the block padding concat (march_pallas.py layout note).
    rows = [
        padded(state["px"]), padded(state["py"]), padded(state["pz"]),
        padded(state["dx"]), padded(state["dy"]), padded(state["dz"]),
        padded(state["h"]),
        padded(was.astype(jnp.float32)),
        padded(state["amount_ub"], fill=1.0),
        padded(jnp.zeros((n,), jnp.float32)),  # cumulative steps
    ]
    if kerr:
        rows += [
            padded(state["qx"]), padded(state["qy"]), padded(state["qz"]),
        ]
    work = dict(
        rs=tuple(rows),
        closest=padded(jnp.where(was, state["closest"], jnp.float32(1e9))),
        horizon=padded(jnp.zeros((n,), jnp.float32)),
        exited=padded(jnp.zeros((n,), jnp.float32)),
        count=padded(jnp.zeros((n,), jnp.float32)),
        true_count=padded(jnp.zeros((n,), jnp.float32)),
        slots=tuple(
            jnp.zeros((npad,), jnp.float32)
            for _ in range(K * CROSS_FIELDS)
        ),
    )

    def do_round(work, first: bool):
        rs = work["rs"]
        act_f = rs[7]
        # Every kernel march goes through the custom_vjp wrapper: primal
        # cost is identical (fwd rule = the same kernel), and under
        # jax.grad the backward replays via the rematerialized jnp mirror
        # (bhx.kernels.march_grad), which covers Euler, RK45 (h-carry
        # included) and the Kerr Hamiltonian.
        kernel = march_pallas_diff
        # Sparse active sets run uncompacted: an all-dead block's while
        # cond votes false before its first step (see the docstring).
        out = kernel(rs, params, kcfg)

        # The kernel PRESERVES inactive lanes (its per-substep applied
        # mask keeps their state; counters/flags stay at their zero init),
        # so no output field needs host-side re-masking: pos/dir/h/amount
        # equal the inputs and steps/horizon/exited/count/slots are zero
        # for lanes with act==0.  The old per-field jnp.where pyramid here
        # was ~40 full-frame HBM round trips of pure no-ops.
        active = act_f > 0.5
        steps = rs[9] + out[6]
        amount_ub = out[11]
        closest = jnp.minimum(work["closest"], out[7])
        horizon = jnp.maximum(work["horizon"], out[8])
        exited = jnp.maximum(work["exited"], out[9])

        # Merge this round's crossing slots after the ray's existing ones.
        slots = work["slots"]
        count = work["count"]
        # True (uncapped) crossing count from the kernel: crossings beyond
        # the K record slots still attenuate amount_ub but are not shaded;
        # this tracks how many were dropped (bounded by tests).
        true_count = work["true_count"] + out[12]
        if cfg.show_disk:
            CF = CROSS_FIELDS
            # Slot rows come out exactly as recorded (valid flag is the
            # 0/1 float in field 6, geometry zeroed where invalid).
            round_slots = tuple(
                out[OUT_FIXED + k * CF + f]
                for k in range(K) for f in range(CF)
            )
            round_count = sum(
                out[OUT_FIXED + k * CF + 6] for k in range(K)
            )
            if first:
                # No prior slots: this round's records ARE the slots.
                slots, count = round_slots, round_count
            else:
                slots, count = _merge_slots(
                    slots, count, round_slots, round_count, K
                )

        still = (
            active
            & (exited < 0.5)
            & (horizon < 0.5)
            & (amount_ub >= cfg.opacity_cutoff)
            & (steps < float(cfg.max_iterations))
        )
        new_rows = [
            out[0], out[1], out[2], out[3], out[4], out[5],
            out[10],  # h
            still.astype(jnp.float32),
            amount_ub,
            steps,
        ]
        if kerr:
            base = OUT_FIXED + K * CROSS_FIELDS
            new_rows += [out[base + 0], out[base + 1], out[base + 2]]
        work = dict(work)
        work.update(
            rs=tuple(new_rows),
            closest=closest, horizon=horizon, exited=exited,
            count=count, slots=slots, true_count=true_count,
        )
        return work

    if n_rounds == 1:
        work = do_round(work, first=True)
    else:
        work = do_round(work, first=True)

        def round_body(carry):
            r, w = carry
            return r + 1, do_round(w, first=False)

        def round_cond(carry):
            r, w = carry
            return jnp.logical_and(
                r < n_rounds - 1, jnp.any(w["rs"][7] > 0.5)
            )

        _, work = jax.lax.while_loop(
            round_cond, round_body, (jnp.int32(0), work)
        )

    # The work state is rows end-to-end — trimming the block padding is the
    # only "unpack".
    rs = work["rs"]
    w_px, w_py, w_pz = rs[0][:n], rs[1][:n], rs[2][:n]
    w_dx, w_dy, w_dz = rs[3][:n], rs[4][:n], rs[5][:n]
    w_h = rs[6][:n]
    w_amount = rs[8][:n]
    w_steps = rs[9][:n]
    w_closest = work["closest"][:n]
    w_horizon = work["horizon"][:n]
    w_exited = work["exited"][:n]
    w_count = work["count"][:n]
    w_true = work["true_count"][:n]
    w_slots = tuple(r[:n] for r in work["slots"])
    was_f = was

    # --- accumulate this phase's crossings into the deferred record; the
    # single batched shade + composite runs once at the end of trace_rays ---
    # Non-marching lanes came back bit-identical (kernel preserves them)
    # with zero counters/flags/slots, so no was_f masking is needed on any
    # "did X happen this phase" quantity.
    hit = state["hit"]
    slots_acc = state["slots"]
    count_acc = state["count"]
    state_true = state.get("true_count")
    if state_true is not None:
        state = dict(state)
        state["true_count"] = state_true + w_true
    if cfg.show_disk:
        if first_phase:
            slots_acc, count_acc = w_slots, w_count
        else:
            slots_acc, count_acc = _merge_slots(
                slots_acc, count_acc, w_slots, w_count, K
            )
        hit = hit | (count_acc > 0.5)
    horizon_b = w_horizon > 0.5
    hit = hit | horizon_b
    amount_ub = jnp.where(horizon_b, 0.0, w_amount)

    # --- feather the exit direction (reference ray.wgsl:543-553) ---
    exited_b = w_exited > 0.5
    fw = bh.relativity_radius * bh.feather
    fs = bh.relativity_radius - fw
    lin = jnp.clip((w_closest - fs) / jnp.maximum(fw, 1e-6), 0.0, 1.0)
    mix_amount = lin * lin
    fdx = w_dx + (state["ox"] - w_dx) * mix_amount
    fdy = w_dy + (state["oy"] - w_dy) * mix_amount
    fdz = w_dz + (state["oz"] - w_dz) * mix_amount
    ndx = jnp.where(exited_b, fdx, w_dx)
    ndy = jnp.where(exited_b, fdy, w_dy)
    ndz = jnp.where(exited_b, fdz, w_dz)

    absorbed = was_f & (horizon_b | (amount_ub < cfg.opacity_cutoff))
    # Budget-capped rays (photon-sphere orbiters): neither exited nor
    # absorbed when the loop ends -> classified escaped with their current
    # direction, like the reference's loop falling through (ray.wgsl:595).
    over_budget = was_f & ~exited_b & ~absorbed
    status = state["status"]
    status = jnp.where(exited_b & ~absorbed, jnp.int32(0), status)
    status = jnp.where(absorbed, jnp.int32(3), status)
    status = jnp.where(over_budget, jnp.int32(2), status)

    new_state = dict(state)
    new_state.update(
        px=w_px, py=w_py, pz=w_pz,
        dx=ndx, dy=ndy, dz=ndz,
        h=w_h,
        hit=hit,
        slots=slots_acc,
        count=count_acc,
        horizon=state["horizon"] | horizon_b,
        amount_ub=amount_ub,
        closest=jnp.where(was_f, w_closest, state["closest"]),
        march_steps=state["march_steps"] + w_steps.astype(jnp.int32),
        status=status,
    )
    if kerr:
        new_state.update(qx=rs[10][:n], qy=rs[11][:n], qz=rs[12][:n])
    return new_state


def _march_phase(state, scene: Scene, cfg: RenderConfig, cam_dist,
                 sparse: bool = False, first_phase: bool = True):
    """Masked geodesic march for rays with status 1 (reference inside
    branch, ray.wgsl:522-553)."""
    if cfg.march_mode in ("pallas", "pallas_interpret"):
        # Both forces run on the kernel: the reference's pseudo-Newtonian
        # bending (ray.wgsl:401-403) and exact Kerr (Hamiltonian RK4 in
        # Kerr-Schild coordinates, mirroring bhx.kerr).
        return _march_phase_pallas(
            state, scene, cfg, cam_dist, sparse=sparse, first_phase=first_phase
        )
    # jnp march modes ("fast"/"diff") run their step loop on (n, 3)
    # vectors (the integrator / hit-test / shading helpers are vector
    # APIs); convert from the canonical rows state at this phase boundary
    # only — a few stacks per trace, nothing per step.
    outer = state
    state = dict(
        pos=jnp.stack([outer["px"], outer["py"], outer["pz"]], axis=-1),
        dir=jnp.stack([outer["dx"], outer["dy"], outer["dz"]], axis=-1),
        orig_dir=jnp.stack([outer["ox"], outer["oy"], outer["oz"]], axis=-1),
        mom=jnp.stack([outer["qx"], outer["qy"], outer["qz"]], axis=-1),
        color=jnp.stack([outer["cr"], outer["cg"], outer["cb"]], axis=-1),
        amount=outer["amount"], hit=outer["hit"], status=outer["status"],
        march_steps=outer["march_steps"], h=outer["h"],
        closest=outer["closest"],
    )
    bh = scene.black_hole
    rot_mat, disk_normal = bh.disk_frame()

    def step(s):
        active = s["status"] == 1
        pos, d, h = s["pos"], s["dir"], s["h"]

        mom_out = s["mom"]
        if cfg.geodesics == "kerr":
            # Exact Kerr geodesics: Hamiltonian RK4 on (x, p) with a
            # field-strength-scaled step (bhx.kerr).  The "direction" used
            # for hit tests / sky is the chord of the step segment.
            from bhx import kerr

            rel = pos - bh.position
            hk = kerr.adaptive_h(rel, bh.mass, bh.spin, cfg.step_size)
            new_rel, new_mom = kerr.step_rk4(rel, s["mom"], hk, bh.mass, bh.spin)
            seg = new_rel - rel
            seg_len = jnp.linalg.norm(seg, axis=-1)
            new_dir = seg / jnp.maximum(seg_len, 1e-12)[:, None]
            new_pos = new_rel + bh.position
            h_used = seg_len
            h_next = h
            applied = active
            mom_out = jnp.where(applied[:, None], new_mom, s["mom"])
            # Capture: inside the (spin-dependent) outer horizon.
            r_bl_new = kerr.bl_radius(new_rel, bh.mass, bh.spin)
            kerr_captured = applied & (r_bl_new <= kerr.horizon_radius(bh.mass, bh.spin))
        elif cfg.integrator == Integrator.EULER:
            new_pos, new_dir = euler_step(pos, d, cfg.step_size, bh.position, bh.mass)
            h_used = jnp.full_like(h, cfg.step_size)
            h_next = h_used
            applied = active
        else:
            rk = rk45_step(
                pos, d, h, bh.position, bh.mass,
                rtol=cfg.rk_rtol, safety=cfg.rk_safety,
                min_factor=cfg.rk_min_factor, max_factor=cfg.rk_max_factor,
                h_min=cfg.rk_h_min, h_max=cfg.rk_h_max,
            )
            new_pos, new_dir = rk.pos, rk.direction
            h_used, h_next = rk.h_used, rk.h_next
            applied = active & rk.accept

        app3 = applied[:, None]
        pos_out = jnp.where(app3, new_pos, pos)
        dir_out = jnp.where(app3, new_dir, d)
        h_out = jnp.where(active, h_next, h)

        # Segment hit tests from the previous position along the *new*
        # direction, bounded by the step length (reference ray.wgsl:539-541).
        seg_o, seg_d = pos, dir_out
        if cfg.geodesics == "kerr":
            # Horizon capture was detected on the Boyer-Lindquist radius of
            # the stepped position; treat it as a terminal hit at t = 0.
            hit_h = kerr_captured
            t_h = jnp.where(hit_h, 0.0, MISS_T)
        else:
            t_h, hit_h = hit_sphere(seg_o, seg_d, bh.position, bh.horizon_radius,
                                    t_min=T_MIN, t_max=h_used)
        if cfg.show_disk:
            t_dk, hit_dk, point_dk, _ = hit_annulus(
                seg_o, seg_d, bh.position, disk_normal,
                bh.disk_inner, bh.disk_outer, t_min=T_MIN, t_max=h_used,
            )
            dk_rgb, dk_op = disk_shade(
                point_dk, seg_d, cam_dist, bh, rot_mat,
                scene.disk_texture, scene.temp_lut, scene.time,
                show_texture=cfg.show_disk_texture,
                show_redshift=cfg.show_redshift,
                texture_mode=cfg.texture_mode,
                disk_gain=scene.disk_gain,
            )
        else:
            t_dk = jnp.full_like(t_h, MISS_T)
            hit_dk = jnp.zeros_like(hit_h)
            dk_rgb = jnp.zeros_like(pos)
            dk_op = jnp.zeros_like(t_h)

        horizon_first = hit_h & (t_h <= t_dk)
        seg_hit = applied & (hit_h | hit_dk)
        op = jnp.where(horizon_first, 1.0, dk_op)
        rgb = jnp.where(horizon_first[:, None], 0.0, jnp.clip(dk_rgb, 0.0, 1.0))

        add = (s["amount"] * op)[:, None] * rgb
        color = jnp.where(seg_hit[:, None], s["color"] + add, s["color"])
        amount = jnp.where(seg_hit, s["amount"] * (1.0 - op), s["amount"])
        hit_acc = s["hit"] | seg_hit

        dist_new = jnp.linalg.norm(pos_out - bh.position, axis=-1)
        closest = jnp.where(applied, jnp.minimum(s["closest"], dist_new), s["closest"])

        # Exit + feather (reference ray.wgsl:543-553).
        exited = applied & (dist_new > bh.relativity_radius)
        fw = bh.relativity_radius * bh.feather
        fs = bh.relativity_radius - fw
        lin = jnp.clip((closest - fs) / jnp.maximum(fw, 1e-6), 0.0, 1.0)
        mix_amount = lin * lin
        feathered = dir_out + (s["orig_dir"] - dir_out) * mix_amount[:, None]
        dir_out = jnp.where(exited[:, None], feathered, dir_out)

        absorbed = active & (amount < cfg.opacity_cutoff)
        # Count every loop pass (accepted or RK-rejected) toward the budget,
        # like the reference's for-loop counter — this also bounds the
        # rejected-step retry chain.
        steps = s["march_steps"] + active.astype(jnp.int32)
        over_budget = active & (steps >= cfg.max_iterations)

        status = s["status"]
        status = jnp.where(active & exited & ~absorbed, jnp.int32(0), status)
        status = jnp.where(absorbed, jnp.int32(3), status)
        # Out-of-budget spiralling rays: classified escaped with their
        # current direction (reference falls through to the alpha-0 return).
        status = jnp.where(over_budget & ~exited & ~absorbed, jnp.int32(2), status)

        out = dict(s)
        out.update(
            pos=pos_out, dir=dir_out, h=h_out, color=color, amount=amount,
            hit=hit_acc, closest=closest, march_steps=steps, status=status,
            mom=mom_out,
        )
        return out

    if cfg.march_mode == "fast":
        def cond(s):
            return jnp.any(s["status"] == 1)

        state = jax.lax.while_loop(cond, step, state)
    else:
        ckpt = max(1, int(cfg.checkpoint_every))
        n_chunks = -(-cfg.max_iterations // ckpt)

        @jax.checkpoint
        def chunk(s, _):
            def body(ss, __):
                return step(ss), None

            s, _ = jax.lax.scan(body, s, None, length=ckpt)
            return s, None

        state, _ = jax.lax.scan(chunk, state, None, length=n_chunks)

    # Back to the canonical rows state.
    out = dict(outer)
    out.update(
        px=state["pos"][:, 0], py=state["pos"][:, 1], pz=state["pos"][:, 2],
        dx=state["dir"][:, 0], dy=state["dir"][:, 1], dz=state["dir"][:, 2],
        qx=state["mom"][:, 0], qy=state["mom"][:, 1], qz=state["mom"][:, 2],
        cr=state["color"][:, 0], cg=state["color"][:, 1],
        cb=state["color"][:, 2],
        amount=state["amount"], hit=state["hit"], status=state["status"],
        march_steps=state["march_steps"], h=state["h"],
        closest=state["closest"],
    )
    return out


# Record layout produced by trace_rays_record: 8 channels per ray.
REC_COLOR = slice(0, 3)   # composited color WITHOUT sky
REC_ALPHA = 3             # 1 = final-color pixel, 0 = clean escape
REC_AMOUNT = 4            # residual transmission (sky weight)
REC_DIR = slice(5, 8)     # final ray direction (sky lookup / interpolation)


def trace_rays_record_rows(origins, directions, scene: Scene,
                           cfg: RenderConfig, rounds: int = DEFAULT_ROUNDS,
                           active=None):
    """Trace a flat batch of rays to the sky-free record as a tuple of 8
    (N,) rows: (cr, cg, cb, alpha, amount, dx, dy, dz).

    Rows (structure-of-arrays) are the canonical record layout: the
    Pallas kernels consume rows natively, so keeping planes end-to-end
    avoids every interleave/deinterleave.  Sky is NOT composited — callers
    apply ``finalize_sky``/``finalize_image`` exactly once per frame (the
    reference samples sky per trace; here the ladder traces levels
    sky-free and one final pass evaluates the sky).

    ``active`` (optional bool (N,)): rays with False are dead lanes that
    produce an escape record untouched; the march kernel's per-lane
    activity mask skips them, so the cost of a masked trace tracks the
    True count.
    """
    bh = scene.black_hole
    deferred = cfg.march_mode in ("pallas", "pallas_interpret")
    n0 = origins.shape[0]
    if deferred:
        # Pre-pad the ray batch to a whole number of kernel blocks ONCE, so
        # every march phase runs with pad == 0 (no per-phase pad copies of
        # every state row).  Pad rays repeat the last
        # ray (valid math, no NaN hazards) but start dead (active=False ->
        # status 2), so the march kernel's lane mask skips them and no
        # output field needs un-masking beyond the final row trim.
        from bhx.kernels.march_pallas import BLOCK

        pad = (-n0) % BLOCK
        if pad:
            origins = jnp.concatenate(
                [origins, jnp.broadcast_to(origins[-1:], (pad, 3))], axis=0
            )
            directions = jnp.concatenate(
                [directions, jnp.broadcast_to(directions[-1:], (pad, 3))],
                axis=0,
            )
            live = (
                jnp.ones((n0,), bool) if active is None
                else active.astype(bool)
            )
            active = jnp.concatenate([live, jnp.zeros((pad,), bool)])
    state = _init_state(origins, directions, deferred=deferred)
    if active is not None:
        state["status"] = jnp.where(active, state["status"], jnp.int32(2))
    cam_dist = jnp.linalg.norm(origins - bh.position, axis=-1)

    for r in range(rounds):
        state = _straight_phase(state, scene, cfg, cam_dist)
        march = partial(
            _march_phase, scene=scene, cfg=cfg, cam_dist=cam_dist,
            sparse=(active is not None) or r > 0, first_phase=(r == 0),
        )
        if r == 0:
            state = march(state)
        else:
            # Re-entry rounds (a feather-blended exit direction can point
            # back into the convex relativity sphere — the reference
            # re-tests entry every outside step, ray.wgsl:554-569) are
            # usually EMPTY; gate the whole march phase on any-active so
            # the common case pays one conditional pass-through instead of
            # a full-frame march phase.
            state = jax.lax.cond(
                jnp.any(state["status"] == 1), march, lambda s: s, state
            )
    # Rays still wanting a straight phase after the last march get it once
    # more; any that would re-enter yet again are treated as escapes.  In
    # the common case the gated re-entry march above was skipped and NO ray
    # is in status 0, so the whole pass is gated too.
    state = jax.lax.cond(
        jnp.any(state["status"] == 0),
        lambda s: _straight_phase(s, scene, cfg, cam_dist),
        lambda s: s,
        state,
    )
    state["status"] = jnp.where(state["status"] == 1, jnp.int32(2), state["status"])

    if deferred:
        (cr, cg, cb), amount = _shade_deferred(state, scene, cfg, cam_dist)
    else:
        cr, cg, cb = state["cr"], state["cg"], state["cb"]
        amount = state["amount"]

    # Classification (reference ray.wgsl:583-595): final-color pixels are
    # those that composited something, plus near-trivial marches (i <= 5);
    # the remaining escapees emit (direction, alpha=0).
    total_iters = state["march_steps"] + state["entered"].astype(jnp.int32)
    few = total_iters <= cfg.few_iters_threshold
    final_alpha1 = state["hit"] | few
    alpha = jnp.where(final_alpha1, 1.0, 0.0)

    rows = (cr, cg, cb, alpha, amount,
            state["dx"], state["dy"], state["dz"])
    if state["px"].shape[0] != n0:  # trim the block pre-pad (pallas modes)
        rows = tuple(r[:n0] for r in rows)
    return rows


def trace_rays_record(origins, directions, scene: Scene, cfg: RenderConfig,
                      rounds: int = DEFAULT_ROUNDS, active=None):
    """Trace a flat batch of rays to the sky-free record. (N, 3) -> (N, 8).

    Interleaved (array-of-structures) wrapper of
    :func:`trace_rays_record_rows` — record channels
    [color(3), alpha, amount, dir(3)].  Hot paths (the ladder pipeline)
    use the rows variant directly and never build this array.
    """
    rows = trace_rays_record_rows(
        origins, directions, scene, cfg, rounds, active
    )
    return jnp.stack(rows, axis=-1)


def crossing_overflow_stats(scene: Scene, cfg: RenderConfig, width: int,
                            height: int):
    """Per-frame K-slot crossing-overflow diagnostic (pallas march only).

    The kernel records at most K = max_crossings disk crossings per ray;
    further crossings still attenuate the early-exit transmission bound but
    are never shaded (the reference composites unboundedly,
    ray.wgsl:571-580).  Returns the fraction of rays that dropped at least
    one crossing and the total dropped count — reported in every bench
    JSON (bhx.bench.run_bench "overflow_frac"), shown in the viewer status
    line, and bounded by tests/test_pallas.py even for edge-on disks.
    """
    assert cfg.march_mode in ("pallas", "pallas_interpret")
    o, d = camera_rays(scene.camera, width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    bh = scene.black_hole
    state = _init_state(o, d, deferred=True)
    cam_dist = jnp.linalg.norm(o - bh.position, axis=-1)
    for r in range(DEFAULT_ROUNDS):
        state = _straight_phase(state, scene, cfg, cam_dist)
        state = _march_phase(
            state, scene, cfg, cam_dist, sparse=r > 0, first_phase=(r == 0)
        )
    dropped = jnp.maximum(state["true_count"] - state["count"], 0.0)
    return dict(
        overflow_frac=jnp.mean((dropped > 0.0).astype(jnp.float32)),
        dropped_total=jnp.sum(dropped),
        max_count=jnp.max(state["true_count"]),
    )


def _shade_deferred(state, scene: Scene, cfg: RenderConfig, cam_dist):
    """One batched shade + composite of the deferred record: disk crossing
    slots (front-to-back via cumprod), then the opaque mesh hit, then
    horizon capture.

    In procedural texture mode the per-slot shading (4-octave Perlin
    texel, blackbody tint, optical depth, ``disk_gain``) and the composite
    run as one Pallas kernel (bhx.kernels.shade_pallas) with a
    recompute-through-jnp backward.
    """
    from bhx.kernels.march_pallas import CROSS_FIELDS

    bh = scene.black_hole
    rot_mat, _ = bh.disk_frame()
    n = state["px"].shape[0]
    cr = cg = cb = jnp.zeros((n,), jnp.float32)
    trans_total = jnp.ones((n,), jnp.float32)
    if cfg.show_disk:
        CF = CROSS_FIELDS
        slots = state["slots"]  # tuple of K*CROSS_FIELDS (n,) rows
        K = len(slots) // CF
        if cfg.texture_mode == "procedural":
            from bhx.kernels.shade_pallas import (
                ShadeKernelConfig,
                pack_shade_params,
                shade_composite,
            )

            kcfg = ShadeKernelConfig(
                max_crossings=K,
                show_texture=cfg.show_disk_texture,
                show_redshift=cfg.show_redshift,
                interpret=cfg.march_mode == "pallas_interpret",
            )
            params = pack_shade_params(bh, rot_mat, scene.time)
            cr, cg, cb, trans_total = shade_composite(
                slots, cam_dist, params, scene.disk_gain, kcfg
            )
        else:
            valid_k = [slots[k * CF + 6] > 0.5 for k in range(K)]
            cam_kn = jnp.broadcast_to(cam_dist[None, :], (K, n)).reshape(-1)
            pos_f = jnp.stack(
                [jnp.stack([slots[k * CF + f] for f in range(3)], axis=-1)
                 for k in range(K)], axis=0).reshape(-1, 3)
            dir_f = jnp.stack(
                [jnp.stack([slots[k * CF + 3 + f] for f in range(3)], axis=-1)
                 for k in range(K)], axis=0).reshape(-1, 3)
            rgb_f, op_f = disk_shade(
                pos_f, dir_f, cam_kn, bh, rot_mat,
                scene.disk_texture, scene.temp_lut, scene.time,
                show_texture=cfg.show_disk_texture,
                show_redshift=cfg.show_redshift,
                texture_mode=cfg.texture_mode,
                disk_gain=scene.disk_gain,
            )
            valid_kn = jnp.stack(valid_k, axis=0)
            rgb_kn = jnp.clip(rgb_f.reshape(K, n, 3), 0.0, 1.0)
            op_kn = jnp.where(valid_kn, op_f.reshape(K, n), 0.0)
            trans = jnp.cumprod(1.0 - op_kn, axis=0)
            trans_before = jnp.concatenate(
                [jnp.ones((1, n), jnp.float32), trans[:-1]], axis=0
            )
            contrib = (trans_before * op_kn)[..., None] * rgb_kn
            color = contrib.sum(axis=0)
            cr, cg, cb = color[:, 0], color[:, 1], color[:, 2]
            trans_total = trans[-1]
    # Opaque mesh hit: weighted by the transmission through every recorded
    # crossing (all of which precede it on the ray).  Mesh colors were
    # clipped when recorded (straight phase).
    mesh_hit = state["mesh_hit"]
    cr = jnp.where(mesh_hit, cr + trans_total * state["mcr"], cr)
    cg = jnp.where(mesh_hit, cg + trans_total * state["mcg"], cg)
    cb = jnp.where(mesh_hit, cb + trans_total * state["mcb"], cb)
    amount = jnp.where(mesh_hit | state["horizon"], 0.0, trans_total)
    return (cr, cg, cb), amount


def finalize_sky(record, sky_tex, show_sky: bool = True,
                 texture_mode: str = "array"):
    """Public alpha-encoded output from a record: (N, 8) -> (N, 4).

    Final pixels get sky composited into their residual transmission
    (reference ray.wgsl:587-592, with its amount > 0.001 guard); escapes
    return (direction, 0) for the sky pass / ladder interpolation.
    """
    escape = record[..., REC_ALPHA] == 0.0
    color = record[..., REC_COLOR]
    if show_sky:
        amount = record[..., REC_AMOUNT]
        sky = sample_sky(sky_tex, record[..., REC_DIR], texture_mode)
        w = jnp.where(amount > 0.001, amount, 0.0)
        color = color + w[..., None] * sky
    rgb = jnp.where(escape[..., None], record[..., REC_DIR], color)
    return jnp.concatenate(
        [rgb, record[..., REC_ALPHA:REC_ALPHA + 1]], axis=-1
    )


def finalize_image(record, sky_tex, show_sky: bool = True,
                   texture_mode: str = "array"):
    """Final rgb from a record: (..., 8) -> (..., 3), sky sampled once.

    Unifies the reference's in-trace sky compositing (hit pixels) and sky
    pass (escape pixels): escapes carry color 0 / amount 1, so
    ``color + amount * sky(dir)`` is exact for both.
    """
    color = record[..., REC_COLOR]
    if not show_sky:
        return color
    amount = record[..., REC_AMOUNT]
    sky = sample_sky(sky_tex, record[..., REC_DIR], texture_mode)
    w = jnp.where(amount > 0.001, amount, 0.0)
    return color + w[..., None] * sky


def finalize_image_rows(rows, sky_tex, show_sky: bool = True,
                        texture_mode: str = "array"):
    """Final rgb rows from record rows: 8 x (...,) -> 3 x (...,).

    Rows-native variant of :func:`finalize_image`: sky sampled once,
    ``color + amount * sky(dir)`` exact for hits and escapes alike.  In
    procedural mode the radiance is evaluated channel-wise straight from
    the direction rows; array mode stacks the direction rows once for the
    bilinear texture fetch.
    """
    cr, cg, cb, _, amount, dx, dy, dz = rows
    if not show_sky:
        return cr, cg, cb
    w = jnp.where(amount > 0.001, amount, 0.0)
    if texture_mode == "procedural":
        from bhx.procedural import sky_radiance_channels
        from bhx.shading import sky_uv

        u, v = sky_uv(jnp.stack([dx, dy, dz], axis=-1))
        sr, sg, sb = sky_radiance_channels(u, v)
    else:
        sky = sample_sky(
            sky_tex, jnp.stack([dx, dy, dz], axis=-1), texture_mode
        )
        sr, sg, sb = sky[..., 0], sky[..., 1], sky[..., 2]
    return cr + w * sr, cg + w * sg, cb + w * sb


def trace_rays(origins, directions, scene: Scene, cfg: RenderConfig,
               rounds: int = DEFAULT_ROUNDS, active=None):
    """Trace a flat batch of rays. origins/directions: (N, 3).

    Returns (N, 4): rgb + the reference's alpha encoding — alpha 1 for rays
    whose color is final (sky already composited into the residual
    transmission), alpha 0 with rgb = escape direction for clean escapes
    (consumed by the ladder interpolation and the sky pass).
    """
    rec = trace_rays_record(origins, directions, scene, cfg, rounds, active)
    return finalize_sky(rec, scene.sky_texture, cfg.show_sky, cfg.texture_mode)


def trace_image(scene: Scene, cfg: RenderConfig, width: int, height: int,
                rounds: int = DEFAULT_ROUNDS):
    """Trace every pixel of a (height, width) image densely."""
    o, d = camera_rays(scene.camera, width, height)
    out = trace_rays(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, rounds)
    return out.reshape(height, width, 4)


def trace_image_record(scene: Scene, cfg: RenderConfig, width: int,
                       height: int, rounds: int = DEFAULT_ROUNDS):
    """Dense sky-free record image: (height, width, 8)."""
    o, d = camera_rays(scene.camera, width, height)
    out = trace_rays_record(
        o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, rounds
    )
    return out.reshape(height, width, 8)
