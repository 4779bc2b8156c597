"""Pallas kernel (Triton route) for deferred disk shading.

**shade_composite** — the march kernel's recorded disk-crossing slots
(march_pallas.py, record-don't-shade) -> (r, g, b, transmission) rows: per
slot the optical depth, procedural texel, blackbody tint and ``disk_gain``
sample, then the front-to-back composite, in one pass with the running
composite in registers.  A block whose rays have no valid slot-k crossing
skips slot k's shading.  On the 1080p default frame it beats the jnp
version XLA compiles (PERF.md).

It is wrapped in jax.custom_vjp whose backward recomputes through the
*equivalent jnp implementation* (shared code in this module and
bhx.procedural), so pallas-mode renders are reverse-differentiable w.r.t.
every scene quantity that flows through shading (disk params, rotation,
time, mass via the gravitational shift, disk_gain).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltri

from bhx.kernels.march_pallas import _any
from bhx.procedural import blackbody_tint_channels, disk_texel_m

# Rays per program and warps per program.
BLOCK = 256
NUM_WARPS = 4

# ---------------------------------------------------------------------------
# Deferred disk-slot shading
# ---------------------------------------------------------------------------

# Scalar parameter vector for the shade kernel.
_SP = dict(
    bh_x=0, bh_y=1, bh_z=2, mass=3, disk_inner=4, disk_outer=5,
    r00=6, r01=7, r02=8, r10=9, r11=10, r12=11, r20=12, r21=13, r22=14,
    spun=15,  # time * rotation_speed
)
NUM_SHADE_PARAMS = len(_SP)

# Per-slot input layout (march kernel record): hx, hy, hz, dx, dy, dz, valid.
SLOT_FIELDS = 7


@dataclasses.dataclass(frozen=True)
class ShadeKernelConfig:
    max_crossings: int = 4
    show_texture: bool = True
    show_redshift: bool = True
    interpret: bool = False


def _slot_ingredients(hx, hy, hz, dx, dy, dz, cam_dist, p, kcfg):
    """Shading ingredients (od, m, tint rgb, u, v) for one slot's geometry.

    Shared elementwise math for the kernel body AND the jnp reference /
    backward path (reference hit_black_hole disk branch, ray.wgsl:612-662).
    ``p`` maps scalar names to values.
    """
    rx = hx - p["bh_x"]
    ry = hy - p["bh_y"]
    rz = hz - p["bh_z"]
    dist2 = rx * rx + ry * ry + rz * rz
    inv_dist = jax.lax.rsqrt(dist2 + 1e-20)
    dist = dist2 * inv_dist

    # Reference quirk kept: the first density factor uses |hit_point|
    # (absolute position, ray.wgsl:619), the rest the hole-relative radius.
    abs2 = hx * hx + hy * hy + hz * hz
    abs_dist = abs2 * jax.lax.rsqrt(abs2 + 1e-20)
    density = 1.0 - abs_dist / p["disk_outer"]
    tt = jnp.clip(dist - p["disk_inner"], 0.0, 1.0)
    density = density * (tt * tt * (3.0 - 2.0 * tt))
    density = jnp.maximum(density * jnp.sqrt(inv_dist), 0.0)
    x = 30.0 * density
    od = jnp.where(
        x > 0.0, jnp.exp(1.3 * jnp.log(jnp.maximum(x, 1e-20))), 0.0
    )

    if kcfg.show_texture:
        r_norm = (dist - p["disk_inner"]) / (p["disk_outer"] - p["disk_inner"])
        inv_outer = 1.0 / p["disk_outer"]
        sx = rx * inv_outer
        sy = ry * inv_outer
        sz = rz * inv_outer
        rot_x = p["r00"] * sx + p["r01"] * sy + p["r02"] * sz
        rot_z = p["r20"] * sx + p["r21"] * sy + p["r22"] * sz
        # arctan2's gradient at (0, 0) is 0/0: INVALID slots sit exactly
        # there (zero geometry, hole at origin), and although their
        # cotangents are select-masked to 0 downstream, the 0 * nan of
        # the arctan2 grad leaks into the SCALAR disk_outer cotangent.
        # Substitute x=1 on degenerate lanes via a select — forward
        # unchanged (arctan2(0,1) == arctan2(0,0) == 0), gradient finite.
        degen = rot_x * rot_x + rot_z * rot_z < 1e-24
        angle = -jnp.arctan2(rot_z, jnp.where(degen, 1.0, rot_x))
        spun = angle + p["spun"]
        u = (jnp.sin(spun) * r_norm + 1.0) * 0.5
        v = (jnp.cos(spun) * r_norm + 1.0) * 0.5
        m = disk_texel_m(u, v)
    else:
        u = jnp.zeros_like(od)
        v = jnp.zeros_like(od)
        m = jnp.zeros_like(od)

    if kcfg.show_redshift:
        rhx = rx * inv_dist
        rhz = rz * inv_dist
        # shift_vec = 0.6 * cross(rhat, (0,-1,0)) = 0.6 * (rhz, 0, -rhx)
        velocity = 0.6 * (dx * rhz - dz * rhx)
        doppler = jnp.sqrt(
            jnp.maximum((1.0 - velocity) / (1.0 + velocity), 0.0)
        )
        rs = 2.0 * p["mass"]
        grav = jnp.sqrt(
            jnp.maximum(
                (1.0 - rs / jnp.maximum(dist, rs + 1e-3))
                / (1.0 - rs / jnp.maximum(cam_dist, rs + 1e-3)),
                0.0,
            )
        )
        shift = jnp.clip(grav * doppler, 0.0, 1.0)
        shift = shift * shift
        tr, tg, tb = blackbody_tint_channels(shift)
    else:
        tr = tg = tb = jnp.ones_like(od)

    return od, m, tr, tg, tb, u, v


def _slot_rgb_opacity(ing, gain, kcfg: ShadeKernelConfig):
    """(r, g, b, opacity) of one slot from its ingredients.  ``gain`` is
    the sampled (r, g, b, a) disk_gain, or None.  Shared by the kernel and
    the jnp reference."""
    od, m, tr, tg, tb, _, _ = ing
    opacity = jnp.clip(od * 0.2, 0.0, 1.0)
    r = g = b = od
    if kcfg.show_texture:
        tex_a = m if gain is None else m * gain[3]
        gr, gg, gb = (1.0, 1.0, 1.0) if gain is None else gain[:3]
        r = r * m * gr * tex_a
        g = g * m * gg * tex_a
        b = b * m * gb * tex_a
        opacity = opacity * jnp.clip(0.7 + tex_a * 0.5, 0.0, 1.0)
    if kcfg.show_redshift:
        r, g, b = r * tr, g * tg, b * tb
    return r, g, b, opacity


def pack_shade_params(black_hole, rot_mat, time) -> jnp.ndarray:
    """Traced scalar vector for the shade kernel (differentiable: grads
    flow back through this stack to the scene leaves)."""
    vals = [
        black_hole.position[0], black_hole.position[1], black_hole.position[2],
        black_hole.mass, black_hole.disk_inner, black_hole.disk_outer,
        rot_mat[0, 0], rot_mat[0, 1], rot_mat[0, 2],
        rot_mat[1, 0], rot_mat[1, 1], rot_mat[1, 2],
        rot_mat[2, 0], rot_mat[2, 1], rot_mat[2, 2],
        time * black_hole.rotation_speed,
    ]
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


def _gain_bilinear(u, v, gain_ref, gh: int, gw: int):
    """Per-lane bilinear sample of the flattened (gh, gw, 4) gain grid:
    clamp-addressed, texel centers at (i + 0.5)/size — the math of
    bhx.shading.sample_grid_mxu — as indexed loads of the 4 corners."""
    x = jnp.clip(u * gw - 0.5, 0.0, gw - 1.0)
    y = jnp.clip(v * gh - 0.5, 0.0, gh - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, gw - 1)
    y1i = jnp.minimum(y0i + 1, gh - 1)

    def corner(yi, xi):
        base = (yi * gw + xi) * 4
        return [pltri.load(gain_ref.at[base + c]) for c in range(4)]

    c00, c01 = corner(y0i, x0i), corner(y0i, x1i)
    c10, c11 = corner(y1i, x0i), corner(y1i, x1i)
    return [
        (c00[c] * (1.0 - fx) + c01[c] * fx) * (1.0 - fy)
        + (c10[c] * (1.0 - fx) + c11[c] * fx) * fy
        for c in range(4)
    ]


def _composite_kernel(params_ref, gain_ref, *refs,
                      kcfg: ShadeKernelConfig, gain_shape):
    """Fused per-block shade + front-to-back composite.

    refs: K*SLOT_FIELDS slot rows, cam row, then outputs r, g, b, trans.
    The running composite (rgb, transmission) is the carry of one
    ``lax.cond`` per slot, which skips slot k's shading when no ray of the
    block has a valid slot-k crossing.
    """
    K = kcfg.max_crossings
    nslots = K * SLOT_FIELDS
    slot_refs = refs[:nslots]
    cam_ref = refs[nslots]
    out_refs = refs[nslots + 1:nslots + 5]
    p = {name: params_ref[i] for name, i in _SP.items()}
    cam_dist = cam_ref[...]
    zeros = jnp.zeros_like(cam_dist)
    acc = (zeros, zeros, zeros, zeros + 1.0)

    for k in range(K):
        sbase = k * SLOT_FIELDS
        valid = slot_refs[sbase + 6][...] > 0.5

        def shade(acc, sbase=sbase, valid=valid):
            ing = _slot_ingredients(
                *(slot_refs[sbase + f][...] for f in range(6)),
                cam_dist, p, kcfg,
            )
            gain = None
            if kcfg.show_texture and gain_shape is not None:
                gain = _gain_bilinear(ing[5], ing[6], gain_ref, *gain_shape)
            r, g, b, opacity = _slot_rgb_opacity(ing, gain, kcfg)
            ar, ag, ab, trans = acc
            op = jnp.where(valid, opacity, 0.0)
            w = trans * op
            return (
                ar + w * jnp.clip(r, 0.0, 1.0),
                ag + w * jnp.clip(g, 0.0, 1.0),
                ab + w * jnp.clip(b, 0.0, 1.0),
                trans * (1.0 - op),
            )

        acc = jax.lax.cond(_any(valid), shade, lambda a: a, acc)

    for ref, val in zip(out_refs, acc):
        ref[...] = val


def _pad_to(x, size: int, fill=0.0):
    pad = size - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])


def _composite_pallas(slots, cam_dist, params, gain, kcfg: ShadeKernelConfig):
    K = kcfg.max_crossings
    assert len(slots) == K * SLOT_FIELDS
    n = slots[0].shape[0]
    npad = -(-n // BLOCK) * BLOCK
    rows = [_pad_to(r, npad) for r in slots]
    cam_r = _pad_to(cam_dist, npad, fill=1.0)
    params_p = _pad_to(params.astype(jnp.float32), 32)
    if gain is not None:
        gain_shape = (gain.shape[0], gain.shape[1])
        flat = gain.reshape(-1).astype(jnp.float32)
        gain_p = _pad_to(flat, 1 << max(0, (flat.shape[0] - 1).bit_length()))
    else:
        gain_shape = None
        gain_p = jnp.zeros((4,), jnp.float32)
    row_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))

    out = pl.pallas_call(
        functools.partial(
            _composite_kernel, kcfg=kcfg, gain_shape=gain_shape
        ),
        grid=(npad // BLOCK,),
        in_specs=[
            pl.BlockSpec((32,), lambda i: (0,)),
            pl.BlockSpec(gain_p.shape, lambda i: (0,)),
        ] + [row_spec] * (len(rows) + 1),
        out_specs=[row_spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * 4,
        compiler_params=pltri.CompilerParams(num_warps=NUM_WARPS),
        interpret=kcfg.interpret,
        name="bhx_shade_composite",
    )(params_p, gain_p, *rows, cam_r)

    return tuple(o[:n] for o in out)


def _composite_jnp(slots, cam_dist, params, gain, kcfg: ShadeKernelConfig):
    """jnp reference of the fused kernel (the custom_vjp backward and the
    parity oracle).  Returns (r, g, b, trans) rows like the kernel."""
    from bhx.shading import sample_grid_mxu

    p = {name: params[i] for name, i in _SP.items()}
    n = cam_dist.shape[0]
    acc = [jnp.zeros((n,), jnp.float32) for _ in range(3)]
    trans = jnp.ones((n,), jnp.float32)
    for k in range(kcfg.max_crossings):
        s = k * SLOT_FIELDS
        ing = _slot_ingredients(*slots[s:s + 6], cam_dist, p, kcfg)
        g = None
        if kcfg.show_texture and gain is not None:
            sampled = sample_grid_mxu(gain, ing[5], ing[6])
            g = [sampled[..., c] for c in range(4)]
        r, gg, b, opacity = _slot_rgb_opacity(ing, g, kcfg)
        op = jnp.where(slots[s + 6] > 0.5, opacity, 0.0)
        w = trans * op
        for c, val in enumerate((r, gg, b)):
            acc[c] = acc[c] + w * jnp.clip(val, 0.0, 1.0)
        trans = trans * (1.0 - op)
    return acc[0], acc[1], acc[2], trans


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def shade_composite(slots, cam_dist, params, gain, kcfg: ShadeKernelConfig):
    """Fused deferred-shade composite: slot rows -> (r, g, b, trans) rows.

    Forward = Pallas; backward recomputes through the shared jnp math
    (differentiable w.r.t. slots, cam_dist, params, and gain).
    """
    return _composite_pallas(slots, cam_dist, params, gain, kcfg)


def _composite_fwd(slots, cam_dist, params, gain, kcfg):
    return shade_composite(slots, cam_dist, params, gain, kcfg), (
        slots, cam_dist, params, gain,
    )


def _composite_bwd(kcfg, res, g):
    slots, cam_dist, params, gain = res
    if gain is None:
        _, vjp = jax.vjp(
            lambda s, c, p: _composite_jnp(s, c, p, None, kcfg),
            slots, cam_dist, params,
        )
        return vjp(g) + (None,)
    _, vjp = jax.vjp(
        lambda s, c, p, ga: _composite_jnp(s, c, p, ga, kcfg),
        slots, cam_dist, params, gain,
    )
    return vjp(g)


shade_composite.defvjp(_composite_fwd, _composite_bwd)
