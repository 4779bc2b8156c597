"""THE march substep: one definition shared by the Pallas kernel and the
custom_vjp replay mirror.

:func:`march_substep` is the single source of truth for one geodesic
integration substep — Euler / RK45 (pseudo-Newtonian bending force,
reference ray.wgsl:401-480) and the Kerr Hamiltonian RK4 (beyond the
reference) — including segment hit tests, crossing bookkeeping, and the
termination/budget masks.  Both call sites inline it:

* ``march_pallas._kernel`` calls it with ``sg=identity`` and a
  ``record`` callback that scatters crossing slots into the output ref
  under a ``pl.when`` guard (everything in here is elementwise jnp, so
  it lowers into the kernel unchanged);
* ``march_grad.step_pure`` calls it with ``sg=jax.lax.stop_gradient``
  (mask heuristics must not enter the autodiff graph) and a ``record``
  callback that folds slots into the scan carry.

Before round 5 these were two hand-maintained operation-for-operation
copies (~260 duplicated lines); the custom_vjp's premise — replayed
trajectory == kernel trajectory (march_grad.py module docs) — now holds
by construction instead of by test discipline (the parity tests remain
as the guard against regressions in the two thin call sites).

State dict keys: px py pz dx dy dz h act steps steps0 closest2 count
amount_ub horizon exited [qx qy qz for geodesics="kerr"].  ``p`` maps a
parameter name (march_pallas._P keys) to its scalar.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bhx.integrate import (
    A21, A31, A32, A41, A42, A43, A51, A52, A53, A54, A61, A62, A63, A64, A65,
    B1, B3, B4, B6, E1, E3, E4, E5, E6,
)


def kerr_scalars(rx, ry, rz, mass, a_k):
    """(r, f, l): Kerr-Schild radial coordinate, potential, null vector
    (component-wise mirror of bhx.kerr._kerr_scalars)."""
    a2_k = a_k * a_k
    rho2 = rx * rx + ry * ry + rz * rz
    b_ = rho2 - a2_k
    r2 = 0.5 * (b_ + jnp.sqrt(b_ * b_ + 4.0 * a2_k * rz * rz + 1e-20))
    r2 = jnp.maximum(r2, 1e-12)
    r = jnp.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2_k * rz * rz + 1e-20)
    denom = r2 + a2_k
    lx = (r * rx + a_k * ry) / denom
    ly = (r * ry - a_k * rx) / denom
    lz = rz / r
    return r, f, lx, ly, lz


def kerr_rhs(rx, ry, rz, qx, qy, qz, mass, a_k):
    """Hamilton's equations: dx = p - f lp l; dp = -dH/dx with dH/dx from
    ``jax.vjp`` (pure elementwise math, so it lowers inside the kernel
    and is twice-differentiable in the replay; bhx.kerr.rhs)."""
    _, f, lx, ly, lz = kerr_scalars(rx, ry, rz, mass, a_k)
    lp = 1.0 + lx * qx + ly * qy + lz * qz
    flp = f * lp
    dxx = qx - flp * lx
    dxy = qy - flp * ly
    dxz = qz - flp * lz

    def h_of_x(ax, ay, az):
        _, f_, lx_, ly_, lz_ = kerr_scalars(ax, ay, az, mass, a_k)
        lp_ = 1.0 + lx_ * qx + ly_ * qy + lz_ * qz
        return -0.5 * f_ * lp_ * lp_

    _, vjp = jax.vjp(h_of_x, rx, ry, rz)
    gx, gy, gz = vjp(jnp.ones_like(rx))
    return dxx, dxy, dxz, -gx, -gy, -gz


def march_substep(s, p, kcfg, *, sg=lambda x: x, record=None):
    """One integration substep; returns the advanced state dict.

    ``s``: per-ray state arrays (module docstring).  ``p``: name ->
    scalar parameter (a scalar load in the kernel, dict lookup in the
    mirror).  ``sg``: stop_gradient hook applied to the early-exit
    transmission-bound heuristic (identity in the kernel).  ``record``:
    ``record(crossing, count_before, hit_vals)`` stores a disk-crossing
    (hit_vals = hx, hy, hz, ndx, ndy, ndz); storage differs per caller
    (output-ref scatter vs scan carry), everything else lives here.
    """
    bx, by, bz = p("bh_x"), p("bh_y"), p("bh_z")
    mass = p("mass")
    horizon_r2 = p("horizon_r") * p("horizon_r")
    rel_r2 = p("rel_r") * p("rel_r")
    nx, ny, nz = p("disk_nx"), p("disk_ny"), p("disk_nz")
    d_in, d_out = p("disk_inner"), p("disk_outer")
    d_in2, d_out2 = d_in * d_in, d_out * d_out
    inv_d_out = 1.0 / d_out
    kerr = kcfg.geodesics == "kerr"

    px, py, pz = s["px"], s["py"], s["pz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    act = s["act"] > 0.5

    rx, ry, rz = px - bx, py - by, pz - bz
    cxv = ry * dz - rz * dy
    cyv = rz * dx - rx * dz
    czv = rx * dy - ry * dx
    h2 = cxv * cxv + cyv * cyv + czv * czv

    def accel(qx_, qy_, qz_):
        """Pseudo-Newtonian bending force -1.5 h^2 r / |r|^5
        (ray.wgsl:401-403), r^-5 as rsqrt^5 — no pow."""
        arx, ary, arz = qx_ - bx, qy_ - by, qz_ - bz
        r2_ = arx * arx + ary * ary + arz * arz
        ir_ = jax.lax.rsqrt(r2_ + 1e-12)
        ir2_ = ir_ * ir_
        inv_r5_ = ir2_ * ir2_ * ir_
        a_s_ = (-3.0) * mass * h2 * inv_r5_
        return a_s_ * arx, a_s_ * ary, a_s_ * arz

    def norm3(x, y, z):
        inv = jax.lax.rsqrt(x * x + y * y + z * z + 1e-20)
        return x * inv, y * inv, z * inv

    q_out = {}
    kerr_captured = None
    if kerr:
        # --- exact Kerr null geodesics: Hamiltonian RK4 on (x, p) with a
        # field-strength-scaled step; the hit-test "direction" is the step
        # segment's chord, like the jnp path (bhx/tracer.py kerr branch).
        a_k = p("spin") * mass
        spin = p("spin")
        r_plus = mass * (1.0 + jnp.sqrt(jnp.clip(1.0 - spin * spin, 0.0, 1.0)))
        inv_3m = 1.0 / (3.0 * mass)
        qx, qy, qz = s["qx"], s["qy"], s["qz"]
        r0, _, _, _, _ = kerr_scalars(rx, ry, rz, mass, a_k)
        t_ = r0 * inv_3m
        hk = jnp.clip(p("step_size") * t_ * jnp.sqrt(t_), 2e-3, 1.0)

        def rhs(arx, ary, arz, aqx, aqy, aqz):
            return kerr_rhs(arx, ary, arz, aqx, aqy, aqz, mass, a_k)

        k1 = rhs(rx, ry, rz, qx, qy, qz)
        k2 = rhs(
            rx + 0.5 * hk * k1[0], ry + 0.5 * hk * k1[1],
            rz + 0.5 * hk * k1[2],
            qx + 0.5 * hk * k1[3], qy + 0.5 * hk * k1[4],
            qz + 0.5 * hk * k1[5],
        )
        k3 = rhs(
            rx + 0.5 * hk * k2[0], ry + 0.5 * hk * k2[1],
            rz + 0.5 * hk * k2[2],
            qx + 0.5 * hk * k2[3], qy + 0.5 * hk * k2[4],
            qz + 0.5 * hk * k2[5],
        )
        k4 = rhs(
            rx + hk * k3[0], ry + hk * k3[1], rz + hk * k3[2],
            qx + hk * k3[3], qy + hk * k3[4], qz + hk * k3[5],
        )
        sixth = hk * (1.0 / 6.0)
        nrx = rx + sixth * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        nry = ry + sixth * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        nrz = rz + sixth * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        nqx = qx + sixth * (k1[3] + 2 * k2[3] + 2 * k3[3] + k4[3])
        nqy = qy + sixth * (k1[4] + 2 * k2[4] + 2 * k3[4] + k4[4])
        nqz = qz + sixth * (k1[5] + 2 * k2[5] + 2 * k3[5] + k4[5])
        sgx, sgy, sgz = nrx - rx, nry - ry, nrz - rz
        seg_len = jnp.sqrt(sgx * sgx + sgy * sgy + sgz * sgz + 1e-24)
        inv_seg = 1.0 / seg_len
        ndx, ndy, ndz = sgx * inv_seg, sgy * inv_seg, sgz * inv_seg
        npx, npy, npz = nrx + bx, nry + by, nrz + bz
        h_used = seg_len
        h_next = s["h"]
        applied = act
        # Capture: inside the (spin-dependent) outer horizon.
        r_new, _, _, _, _ = kerr_scalars(nrx, nry, nrz, mass, a_k)
        kerr_captured = applied & (r_new <= r_plus)
        app3 = jnp.where(applied, 1.0, 0.0)
        q_out = dict(
            qx=app3 * nqx + (1.0 - app3) * qx,
            qy=app3 * nqy + (1.0 - app3) * qy,
            qz=app3 * nqz + (1.0 - app3) * qz,
        )
    elif kcfg.integrator == "euler":
        # Euler: dir += f h; normalize; pos += dir h (ray.wgsl:467-480).
        h_used = s["h"]
        ax, ay, az = accel(px, py, pz)
        ndx, ndy, ndz = norm3(
            dx + ax * h_used, dy + ay * h_used, dz + az * h_used
        )
        npx = px + ndx * h_used
        npy = py + ndy * h_used
        npz = pz + ndz * h_used
        applied = act
        h_next = h_used
    else:
        # --- RK45 Cash-Karp with a REAL per-lane controller: rejected
        # lanes retry with the shrunken h on the next pass (the
        # reference's controller at ray.wgsl:440-462 accepts everything
        # in practice; divergence documented in bhx.integrate).
        h_used = s["h"]

        def stage(cx_, cy_, cz_):
            return accel(px + cx_ * h_used, py + cy_ * h_used, pz + cz_ * h_used)

        k1 = accel(px, py, pz)
        k2 = stage(A21 * k1[0], A21 * k1[1], A21 * k1[2])
        k3 = stage(A31 * k1[0] + A32 * k2[0], A31 * k1[1] + A32 * k2[1],
                   A31 * k1[2] + A32 * k2[2])
        k4 = stage(A41 * k1[0] + A42 * k2[0] + A43 * k3[0],
                   A41 * k1[1] + A42 * k2[1] + A43 * k3[1],
                   A41 * k1[2] + A42 * k2[2] + A43 * k3[2])
        k5 = stage(A51 * k1[0] + A52 * k2[0] + A53 * k3[0] + A54 * k4[0],
                   A51 * k1[1] + A52 * k2[1] + A53 * k3[1] + A54 * k4[1],
                   A51 * k1[2] + A52 * k2[2] + A53 * k3[2] + A54 * k4[2])
        k6 = stage(
            A61 * k1[0] + A62 * k2[0] + A63 * k3[0] + A64 * k4[0] + A65 * k5[0],
            A61 * k1[1] + A62 * k2[1] + A63 * k3[1] + A64 * k4[1] + A65 * k5[1],
            A61 * k1[2] + A62 * k2[2] + A63 * k3[2] + A64 * k4[2] + A65 * k5[2],
        )
        ix = B1 * k1[0] + B3 * k3[0] + B4 * k4[0] + B6 * k6[0]
        iy = B1 * k1[1] + B3 * k3[1] + B4 * k4[1] + B6 * k6[1]
        iz = B1 * k1[2] + B3 * k3[2] + B4 * k4[2] + B6 * k6[2]
        ex = h_used * (E1 * k1[0] + E3 * k3[0] + E4 * k4[0] + E5 * k5[0] + E6 * k6[0])
        ey = h_used * (E1 * k1[1] + E3 * k3[1] + E4 * k4[1] + E5 * k5[1] + E6 * k6[1])
        ez = h_used * (E1 * k1[2] + E3 * k3[2] + E4 * k4[2] + E5 * k5[2] + E6 * k6[2])
        err = jnp.maximum(jnp.abs(ex), jnp.maximum(jnp.abs(ey), jnp.abs(ez)))
        ratio = err / p("rtol")
        accept = ratio <= 1.0
        # Controller without pow: ratio^-0.25 = rsqrt(rsqrt(ratio)).
        r4 = jax.lax.rsqrt(jax.lax.rsqrt(ratio + 1e-12))
        grow = jnp.clip(p("safety") * r4, 1.0, p("max_f"))
        shrink = jnp.clip(p("safety") * r4, p("min_f"), 1.0)
        h_next = jnp.clip(h_used * jnp.where(accept, grow, shrink),
                          p("h_min"), p("h_max"))
        ndx, ndy, ndz = norm3(dx + h_used * ix, dy + h_used * iy, dz + h_used * iz)
        # Position advances along the old direction (reference parity).
        npx = px + dx * h_used
        npy = py + dy * h_used
        npz = pz + dz * h_used
        applied = act & accept

    # --- segment hit tests (masks only; no gradient paths) ---
    if kerr:
        hit_h = kerr_captured
        t_h = jnp.where(kerr_captured, 0.0, 1e9)
    else:
        # Horizon sphere against [pos, pos + ndir * h_used]
        # (reference ray.wgsl:539-541, 725-766; a == 1 for unit dir).
        half_b = rx * ndx + ry * ndy + rz * ndz
        c_q = rx * rx + ry * ry + rz * rz - horizon_r2
        disc4 = half_b * half_b - c_q
        sq = jnp.sqrt(jnp.maximum(disc4, 0.0))
        t1 = -half_b - sq
        t2 = -half_b + sq
        v1 = (disc4 > 0.0) & (t1 > 1e-8) & (t1 < h_used)
        v2 = (disc4 > 0.0) & (t2 > 1e-8) & (t2 < h_used)
        t_h = jnp.where(v1, t1, jnp.where(v2, t2, 1e9))
        hit_h = v1 | v2

    if kcfg.show_disk:
        # Disk annulus plane hit (reference hit_torus2d, ray.wgsl:668-701).
        denom = nx * ndx + ny * ndy + nz * ndz
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        t_d = ((bx - px) * nx + (by - py) * ny + (bz - pz) * nz) / denom
        hx = px + ndx * t_d
        hy = py + ndy * t_d
        hz = pz + ndz * t_d
        rr2 = (hx - bx) ** 2 + (hy - by) ** 2 + (hz - bz) ** 2
        hit_d = (
            (t_d > 1e-8) & (t_d < h_used) & (rr2 >= d_in2) & (rr2 <= d_out2)
        )
    else:
        hit_d = jnp.zeros_like(hit_h)
        t_d = jnp.full_like(t_h, 1e9)
        hx = hy = hz = jnp.zeros_like(px)

    horizon_first = hit_h & (t_h <= t_d)
    crossing = applied & hit_d & jnp.logical_not(horizon_first)
    hit_horizon = applied & horizon_first

    count = s["count"]
    amount_ub = s["amount_ub"]
    if kcfg.show_disk:
        # Early-exit transmission bound, pow-free minorant
        # x^1.3 >= min(x, x^2) of (30*dens)^1.3 (ray.wgsl:618-626).  A
        # heuristic MASK input, so the whole block rides through ``sg``
        # (stop_gradient in the replay, identity in the kernel).
        rr2_ng = sg(rr2)
        irr = jax.lax.rsqrt(rr2_ng + 1e-20)
        rr = rr2_ng * irr
        inv_sqrt_rr = jnp.sqrt(irr)
        dens = 1.0 - rr * sg(inv_d_out)
        tt = jnp.clip(rr - sg(d_in), 0.0, 1.0)
        dens = dens * (tt * tt * (3.0 - 2.0 * tt))
        dens = jnp.maximum(dens * inv_sqrt_rr, 0.0)
        x = 30.0 * dens
        od_lb = jnp.where(x < 1.0, x * x, x)
        op_lb = jnp.clip(od_lb * 0.2, 0.0, 1.0) * kcfg.tex_opacity_min

        if record is not None:
            record(crossing, count, (hx, hy, hz, ndx, ndy, ndz))
        count = count + jnp.where(crossing, 1.0, 0.0)
        amount_ub = amount_ub * jnp.where(crossing, 1.0 - op_lb, 1.0)

    # --- advance state ---
    applied_f = jnp.where(applied, 1.0, 0.0)
    napplied_f = 1.0 - applied_f
    out_px = applied_f * npx + napplied_f * px
    out_py = applied_f * npy + napplied_f * py
    out_pz = applied_f * npz + napplied_f * pz
    out_dx = applied_f * ndx + napplied_f * dx
    out_dy = applied_f * ndy + napplied_f * dy
    out_dz = applied_f * ndz + napplied_f * dz

    dist2 = (out_px - bx) ** 2 + (out_py - by) ** 2 + (out_pz - bz) ** 2
    closest2 = jnp.where(
        applied, jnp.minimum(s["closest2"], dist2), s["closest2"]
    )

    exited_now = applied & (dist2 > rel_r2)
    absorbed = hit_horizon | (act & (amount_ub < p("cutoff")))
    horizon = jnp.where(hit_horizon, 1.0, s["horizon"])
    exited = jnp.where(exited_now, 1.0, s["exited"])
    steps = s["steps"] + jnp.where(act, 1.0, 0.0)
    act_out = jnp.where(
        act & (s["steps0"] + steps < p("budget"))
        & jnp.logical_not(exited_now | absorbed),
        1.0,
        0.0,
    )

    return dict(
        px=out_px, py=out_py, pz=out_pz,
        dx=out_dx, dy=out_dy, dz=out_dz,
        h=jnp.where(act, h_next, s["h"]), act=act_out, steps=steps,
        steps0=s["steps0"],
        closest2=closest2, count=count, amount_ub=amount_ub,
        horizon=horizon, exited=exited,
        **q_out,
    )
