"""Reverse-differentiable Pallas geodesic march (recompute adjoint).

``march_pallas_diff`` wraps the forward march kernel
(:mod:`bhx.kernels.march_pallas`) in :func:`jax.custom_vjp` so that
``march_mode="pallas"`` renders are reverse-differentiable *on the kernel
path* — primal evaluation runs the unmodified fast kernel, and only under
differentiation does the backward sweep run, as a binary-rematerialized
jnp replay of the identical step math.  (The reference has no gradients
at all; the hot loop whose adjoint this provides lives at
ray.wgsl:482-596.)

Design (same recompute-adjoint pattern as
:mod:`bhx.kernels.shade_pallas`, extended along the time axis):

* **Primal-only calls pay nothing.**  ``custom_vjp``'s fwd rule returns
  the kernel output and stashes only the *inputs* — no checkpoints are
  written, no extra kernel variant exists, the forward stays at full
  throughput whether or not it sits under ``jax.grad``.
* **Backward = replay + VJP of a step-exact jnp replay.**  The bwd rule
  calls ``jax.vjp`` on :func:`march_jnp`, a pure-jnp march whose substep
  (:func:`step_pure`) IS the kernel's substep — both call sites inline
  the single shared definition in :mod:`bhx.kernels.march_substep`, so
  trajectory identity holds by construction — then pulls the output
  cotangent back through it.  Memory is bounded by binary-recursive
  :func:`jax.checkpoint` over the step count: peak live state is
  O(log2(T) + leaf) ray-state copies instead of O(T).
* **Step-count parity.**  The kernel executes substeps in blocks of
  ``B = (vote_every // unroll) * unroll`` between all-lanes-done votes,
  so a tile with any live lane runs ``ceil(max_iterations / B) * B``
  substeps; per-lane activity masks (budget / exit / absorb) make the
  overrun steps identities.  The mirror runs exactly that many masked
  substeps, so trajectories agree to float associativity.
* **Masks don't differentiate.**  Termination, crossing and budget
  decisions are boolean comparisons, and the kernel's heuristic
  transmission bound is wrapped in ``stop_gradient`` — the adjoint is
  exact for the piecewise-smooth map away from decision boundaries,
  matching the ``march_mode="diff"`` semantics (tested in
  tests/test_march_grad.py).

Gradients produced: w.r.t. the input rays (origin, direction, h,
incoming transmission — hence camera pose and fov) and the scalar
parameter vector (hole position, mass, disk plane normal, and — on the
Kerr path — spin; disk inner/outer/horizon/relativity radii enter the
march only through masks — their smooth gradients flow through shading
instead, exactly like the jnp "diff" path).  All three integration paths
are mirrored: Euler, RK45 (with the controller's h-carry — rejected
lanes retry with the shrunken step, differentiated like the "diff" mode
scan does), and the Kerr Hamiltonian RK4 (whose dH/dx inner ``jax.vjp``
the backward rule differentiates again — second-order AD).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bhx.kernels.march_pallas import (
    CROSS_FIELDS,
    OUT_FIXED,
    MarchKernelConfig,
    _OUT_FIXED,
    _P,
    march_pallas,
)

# Substeps per rematerialization leaf (one inline scan's worth of
# stored residuals during the backward pass).
_LEAF = 32
# Leaves per rematerialized segment: the time axis is decomposed as
# scan(n_seg) ∘ remat ∘ scan(_SEG_LEAVES) ∘ remat ∘ scan(_LEAF) so the
# step body is traced ONCE per level (fast compile) while backward peak
# memory stays O(n_seg + _SEG_LEAVES + _LEAF) ray states.
_SEG_LEAVES = 7


def _block_steps(kcfg: MarchKernelConfig) -> int:
    """Substeps the kernel executes between all-lanes-done votes."""
    inner = max(1, kcfg.vote_every // kcfg.unroll)
    return inner * kcfg.unroll


def total_steps(kcfg: MarchKernelConfig) -> int:
    """Exact substep count a tile with a live lane executes."""
    b = _block_steps(kcfg)
    return -(-kcfg.max_iterations // b) * b


def step_pure(s, sc, kcfg: MarchKernelConfig):
    """The replay substep: :func:`bhx.kernels.march_substep.march_substep`
    — the SAME definition the Pallas kernel inlines — with
    ``sg=stop_gradient`` (mask heuristics stay out of the autodiff graph)
    and crossing slots folded into the scan carry instead of scattered
    into an output ref.  Trajectory identity with the kernel holds by
    construction (was: a hand-maintained operation-for-operation mirror).

    ``s``: dict of per-ray arrays — px py pz dx dy dz h act steps steps0
    closest2 count amount_ub horizon exited slots (slots: (K*7, N)
    field-major, matching the kernel's output rows; plus qx qy qz for
    geodesics="kerr").  ``sc``: scalar dict keyed like march_pallas._P.
    """
    from bhx.kernels.march_substep import march_substep

    K = kcfg.max_crossings
    slots_cell = [s["slots"]]

    def record(crossing, count, hit_vals):
        slots = slots_cell[0]
        new_rows = []
        for k in range(K):
            put = crossing & (count == float(k))
            base = k * CROSS_FIELDS
            for f in range(6):
                new_rows.append(
                    jnp.where(put, hit_vals[f], slots[base + f])
                )
            new_rows.append(jnp.where(put, 1.0, slots[base + 6]))
        slots_cell[0] = jnp.stack(new_rows, axis=0)

    ss = {k: v for k, v in s.items() if k != "slots"}
    new = march_substep(
        ss, lambda name: sc[name], kcfg,
        sg=jax.lax.stop_gradient, record=record,
    )
    new["slots"] = slots_cell[0]
    return new


def _leaf(state, sc, kcfg: MarchKernelConfig, n: int):
    def body(s, _):
        return step_pure(s, sc, kcfg), None

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


def _run_steps(state, sc, kcfg: MarchKernelConfig, t: int):
    """Run exactly ``t`` substeps, rematerialized along the time axis.

    Structure: an outer scan over t // (_SEG_LEAVES * _LEAF) segments whose
    body is a checkpointed scan over _SEG_LEAVES checkpointed _LEAF-step
    leaves, plus a remainder chain.  Backward peak memory is
    O(n_seg + _SEG_LEAVES + _LEAF) ray-state copies instead of O(t), and
    the step body is traced once per nesting level instead of once per
    leaf (compile time)."""
    big = _SEG_LEAVES * _LEAF

    @jax.checkpoint
    def leaf_ck(s, scc):
        return _leaf(s, scc, kcfg, _LEAF)

    n_big = t // big
    if n_big:
        @jax.checkpoint
        def seg(s, scc):
            def inner(ss, _):
                return leaf_ck(ss, scc), None

            ss, _ = jax.lax.scan(inner, s, None, length=_SEG_LEAVES)
            return ss

        def outer(s, _):
            return seg(s, sc), None

        state, _ = jax.lax.scan(outer, state, None, length=n_big)

    rem = t - n_big * big
    n_leaf = rem // _LEAF
    if n_leaf:
        def inner2(s, _):
            return leaf_ck(s, sc), None

        state, _ = jax.lax.scan(inner2, state, None, length=n_leaf)
    tail = rem - n_leaf * _LEAF
    if tail:
        state = _leaf(state, sc, kcfg, tail)
    return state


def march_jnp(rays, params, kcfg: MarchKernelConfig):
    """Step-exact jnp mirror of :func:`march_pallas` — all three
    integration paths (Euler / RK45 pseudo-Newtonian, Kerr Hamiltonian).

    Same tuple-of-rows I/O contract: kcfg.in_fields (N,) rows in,
    kcfg.out_fields (N,) rows out.  Differentiable; used as the recompute
    target of the backward rule and as an interpret-free parity oracle in
    tests.
    """
    kerr = kcfg.geodesics == "kerr"
    assert len(rays) == kcfg.in_fields
    sc = {
        k: params[_P[k]]
        for k in (
            "bh_x", "bh_y", "bh_z", "mass", "horizon_r", "rel_r",
            "disk_nx", "disk_ny", "disk_nz", "disk_inner", "disk_outer",
            "cutoff", "budget", "step_size", "spin",
            "rtol", "safety", "min_f", "max_f", "h_min", "h_max",
        )
    }
    px0, py0, pz0 = rays[0], rays[1], rays[2]
    dx0, dy0, dz0 = rays[3], rays[4], rays[5]
    h0, act0, amount0, steps0 = rays[6], rays[7], rays[8], rays[9]
    n = rays[0].shape[0]
    K = kcfg.max_crossings
    zeros = jnp.zeros_like(px0)

    state = dict(
        px=px0, py=py0, pz=pz0, dx=dx0, dy=dy0, dz=dz0,
        h=h0,
        act=jnp.where(steps0 < sc["budget"], act0, 0.0),
        steps=zeros, steps0=steps0,
        closest2=(px0 - sc["bh_x"]) ** 2 + (py0 - sc["bh_y"]) ** 2
        + (pz0 - sc["bh_z"]) ** 2,
        count=zeros, amount_ub=amount0,
        horizon=zeros, exited=zeros,
        slots=jnp.zeros((K * CROSS_FIELDS, n), jnp.float32),
    )
    if kerr:
        state.update(qx=rays[10], qy=rays[11], qz=rays[12])
    final = _run_steps(state, sc, kcfg, total_steps(kcfg))

    rows = [None] * OUT_FIXED
    rows[_OUT_FIXED["px"]] = final["px"]
    rows[_OUT_FIXED["py"]] = final["py"]
    rows[_OUT_FIXED["pz"]] = final["pz"]
    rows[_OUT_FIXED["dx"]] = final["dx"]
    rows[_OUT_FIXED["dy"]] = final["dy"]
    rows[_OUT_FIXED["dz"]] = final["dz"]
    rows[_OUT_FIXED["steps"]] = final["steps"]
    rows[_OUT_FIXED["closest"]] = jnp.sqrt(final["closest2"])
    rows[_OUT_FIXED["horizon"]] = final["horizon"]
    rows[_OUT_FIXED["exited"]] = final["exited"]
    rows[_OUT_FIXED["h"]] = final["h"]
    rows[_OUT_FIXED["amount"]] = final["amount_ub"]
    rows[_OUT_FIXED["count"]] = final["count"]
    slots = final["slots"]
    out = tuple(rows) + tuple(
        slots[i] for i in range(K * CROSS_FIELDS)
    )
    if kerr:
        out = out + (final["qx"], final["qy"], final["qz"])
    return out


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def march_pallas_diff(rays, params, kcfg: MarchKernelConfig):
    """:func:`march_pallas` with a recompute-adjoint backward rule.

    Primal forward is the unmodified kernel; the backward replays the
    march through :func:`march_jnp` under binary rematerialization and
    pulls the cotangent back with ``jax.vjp``.
    """
    return march_pallas(rays, params, kcfg)


def _march_fwd(rays, params, kcfg):
    return march_pallas(rays, params, kcfg), (rays, params)


def _march_bwd(kcfg, res, g):
    rays, params = res
    C = kcfg.bwd_chunks
    n = rays[0].shape[0]
    if C > 1 and n % C != 0:
        # Keep the memory bound when the requested chunk count doesn't
        # divide the ray count (e.g. a resolution change): fall back to the
        # largest divisor of n that is <= C rather than silently replaying
        # single-shot.  n is a multiple of the kernel block, so a nearby
        # divisor always exists.
        C = next(c for c in range(C, 0, -1) if n % c == 0)
    if C <= 1:
        _, vjp = jax.vjp(lambda r, p: march_jnp(r, p, kcfg), rays, params)
        return vjp(g)
    # Ray-chunked adjoint: rays are independent through the march, so the
    # replay splits along the ray axis with zero error; chunks run
    # sequentially (lax.map), dividing peak backward memory by C at the
    # cost of C sequential sweeps.  Parameter cotangents sum over chunks.
    m = n // C
    rays_c = tuple(r.reshape(C, m) for r in rays)
    g_c = tuple(x.reshape(C, m) for x in g)

    def chunk(args):
        rc, gc = args
        _, vjp = jax.vjp(lambda r, p: march_jnp(r, p, kcfg), rc, params)
        return vjp(gc)

    dr_c, dp_c = jax.lax.map(chunk, (rays_c, g_c))
    return tuple(x.reshape(n) for x in dr_c), jnp.sum(dp_c, axis=0)


march_pallas_diff.defvjp(_march_fwd, _march_bwd)
