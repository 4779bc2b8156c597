"""Pallas kernel for the geodesic march (the hot loop), Triton route.

Replaces the jnp march of bhx.tracer._march_phase for the forward path.
The reference's per-pixel megakernel interleaves integration, hit tests,
texture sampling and compositing in one divergent loop (ray.wgsl:518-581).
The kernel keeps that shape — one program per small block of rays, the
whole march in registers, early exit per block — and moves the texture
work out of the loop:

* **Structure of arrays.** A program owns a 1-D block of ``BLOCK`` rays;
  every ray field is its own (N,) row, loaded once into registers, carried
  through the march, and stored once.  The plain XLA march
  (``march_mode="fast"``) instead sends the whole frame's state through
  device memory on every step.
* **Record, don't shade.** The kernel never touches textures: it
  *records* the geometry of up to K disk crossings per ray (position +
  direction per crossing) with masked stores into the output rows, under a
  guard so crossing-free steps (the vast majority) skip the bookkeeping.
  Shading and compositing run afterwards over the recorded slots — exactly
  equivalent because shading depends only on crossing geometry.
* **Masked lane adaptivity.** RK45 step rejection/acceptance is a lane
  mask (rejected lanes retry with the shrunken h on the next loop pass);
  termination is a lane mask + an all-lanes-done vote (``jnp.max`` over
  the block) in the while_loop condition, so a block exits as soon as
  *its* rays are done.
* **Transcendental-free steps.** r^-5 is rsqrt^5 (no pow), radial window
  tests compare squared distances, and the early-exit opacity bound uses
  the pow-free minorant x^1.3 >= min(x, x^2) instead of (30*dens)^1.3
  (ray.wgsl:623).
* **Unrolled loop.** ``unroll`` integration steps per inner iteration and
  a vote every ``vote_every`` steps amortize the loop and vote overhead.

The kernel runs in float32 (geodesics near the horizon need the mantissa;
r^-5 in bf16 is hopeless).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltri

from bhx.kernels.march_substep import march_substep

# Rays per program, and warps per program (one ray per thread).
BLOCK = 128
NUM_WARPS = 4

# Input ray fields.  Kerr marches carry 3 extra momentum fields (10-12).
IN_FIELDS = 10  # px, py, pz, dx, dy, dz, h, active, amount, steps_done

# Scalar parameter vector layout.
_P = dict(
    bh_x=0, bh_y=1, bh_z=2, mass=3, horizon_r=4, rel_r=5,
    disk_nx=6, disk_ny=7, disk_nz=8, disk_inner=9, disk_outer=10,
    step_size=11, cutoff=12, rtol=13, safety=14, min_f=15, max_f=16,
    h_min=17, h_max=18,
    # Per-ray total step budget (float): a lane deactivates exactly when
    # steps_done + steps_this_call reaches it, so multi-round marching
    # matches the single-call budget semantics bit-for-bit.
    budget=19,
    # Dimensionless spin (geodesics="kerr" only; a = spin * mass).
    spin=20,
)
NUM_PARAMS = len(_P)
# The parameter block is padded to a power of two (Triton block shapes).
PARAMS_PAD = 32

# Output field layout.  ``count`` is the TRUE number of disk crossings the
# ray made (not capped at max_crossings) — callers use it to measure how
# many crossings the K-slot record dropped (tests bound that fraction).
_OUT_FIXED = dict(
    px=0, py=1, pz=2, dx=3, dy=4, dz=5,
    steps=6, closest=7, horizon=8, exited=9, h=10, amount=11, count=12,
)
OUT_FIXED = len(_OUT_FIXED)
CROSS_FIELDS = 7  # hx, hy, hz, dx, dy, dz, valid

# Substeps fully unrolled per inner-loop iteration.  Triton's compile
# time grows steeply with the unrolled body (PERF.md), so 1.
UNROLL = 1
# Steps between all-lanes-done votes.  The final round may overrun a
# budget-capped ray by < VOTE_EVERY steps (such rays are photon-sphere
# orbiters that output their current direction; the overrun only changes
# that direction marginally).
VOTE_EVERY = 32


@dataclasses.dataclass(frozen=True)
class MarchKernelConfig:
    integrator: str = "euler"  # "euler" | "rk45"
    # "pseudo": the reference's pseudo-Newtonian bending force
    # (ray.wgsl:401-403).  "kerr": exact Kerr null geodesics — Hamiltonian
    # RK4 in Kerr-Schild coordinates with dH/dx from jax.vjp *inside* the
    # kernel body (pure elementwise math); mirrors bhx.kerr.
    geodesics: str = "pseudo"
    max_iterations: int = 2000
    max_crossings: int = 4
    # Disk-texture opacity factor lower bound (1.0 when texture disabled).
    tex_opacity_min: float = 0.7
    show_disk: bool = True
    vote_every: int = VOTE_EVERY
    # Integration substeps unrolled per inner-loop iteration.
    unroll: int = UNROLL
    # Backward-pass ray chunking (march_grad custom_vjp): the adjoint
    # replays the jnp mirror over all rays; peak backward memory is
    # O(rays * state / bwd_chunks) because chunks run sequentially via
    # lax.map.  1 = single-shot (fastest when it fits).
    bwd_chunks: int = 1
    # Guard slot recording behind a per-substep any(crossing) vote — skips
    # the masked stores on crossing-free substeps at the cost of a block
    # reduce every substep.  False records unconditionally.
    record_guard: bool = True
    interpret: bool = False

    @property
    def in_fields(self) -> int:
        return IN_FIELDS + (3 if self.geodesics == "kerr" else 0)

    @property
    def out_fields(self) -> int:
        # Kerr appends the final conjugate momentum after the slot block
        # (multi-round marching resumes from it).
        return (
            OUT_FIXED
            + CROSS_FIELDS * self.max_crossings
            + (3 if self.geodesics == "kerr" else 0)
        )


def _any(mask):
    """Block-wide any() as a max-reduce: the Triton route has no
    ``reduce_or`` lowering."""
    return jnp.max(jnp.where(mask, 1.0, 0.0)) > 0.5


def _kernel(params_ref, *refs, kcfg: MarchKernelConfig):
    # refs = in_fields input row refs followed by out_fields output row
    # refs; each is this program's (BLOCK,) slice of its own (N,) field.
    ins = refs[:kcfg.in_fields]
    outs = refs[kcfg.in_fields:]
    p = lambda name: params_ref[_P[name]]

    bx, by, bz = p("bh_x"), p("bh_y"), p("bh_z")

    px0, py0, pz0 = ins[0][...], ins[1][...], ins[2][...]
    dx0, dy0, dz0 = ins[3][...], ins[4][...], ins[5][...]
    h0 = ins[6][...]
    act0 = ins[7][...]
    amount0 = ins[8][...]
    steps0 = ins[9][...]
    budget = p("budget")

    zeros = jnp.zeros_like(px0)
    K = kcfg.max_crossings
    kerr = kcfg.geodesics == "kerr"

    # Crossing slots live in the output rows, not the loop carry.
    for k in range(K):
        base = OUT_FIXED + k * CROSS_FIELDS
        for f in range(CROSS_FIELDS):
            outs[base + f][...] = zeros

    init = dict(
        px=px0, py=py0, pz=pz0, dx=dx0, dy=dy0, dz=dz0,
        h=h0,
        act=jnp.where(steps0 < budget, act0, 0.0),
        steps=zeros,
        closest2=(px0 - bx) ** 2 + (py0 - by) ** 2 + (pz0 - bz) ** 2,
        # Continue the running transmission bound across march rounds.
        amount_ub=amount0,
        horizon=zeros,
        exited=zeros,
        count=zeros,
        it=jnp.int32(0),
    )
    if kerr:
        init.update(qx=ins[10][...], qy=ins[11][...], qz=ins[12][...])

    def cond(s):
        return jnp.logical_and(
            s["it"] < kcfg.max_iterations, _any(s["act"] > 0.5)
        )

    def record(crossing, count, hit_vals):
        """Store a crossing into its K-slot output rows with masked stores
        (only the lanes that cross write; no read-modify-write)."""

        def _record():
            for k in range(K):
                base = OUT_FIXED + k * CROSS_FIELDS
                put = jnp.logical_and(crossing, count == float(k))
                for f in range(6):
                    pltri.store(outs[base + f], hit_vals[f], mask=put)
                pltri.store(outs[base + 6], jnp.ones_like(count), mask=put)

        if kcfg.record_guard:
            pl.when(_any(crossing))(_record)
        else:
            _record()

    def substep(s):
        # THE substep — the same shared definition the custom_vjp replay
        # scans (bhx.kernels.march_substep); sg=identity (no autodiff
        # through the kernel itself), slot storage via record above.
        ss = {k: v for k, v in s.items() if k != "it"}
        ss["steps0"] = steps0
        new = march_substep(ss, p, kcfg, record=record)
        del new["steps0"]  # block-constant; lives in the input row
        new["it"] = s["it"] + 1
        return new

    inner_iters = max(1, kcfg.vote_every // kcfg.unroll)

    def body(s):
        def inner(_, ss):
            for _ in range(kcfg.unroll):
                ss = substep(ss)
            return ss

        if inner_iters == 1:
            return inner(0, s)
        return jax.lax.fori_loop(0, inner_iters, inner, s)

    final = jax.lax.while_loop(cond, body, init)

    outs[_OUT_FIXED["px"]][...] = final["px"]
    outs[_OUT_FIXED["py"]][...] = final["py"]
    outs[_OUT_FIXED["pz"]][...] = final["pz"]
    outs[_OUT_FIXED["dx"]][...] = final["dx"]
    outs[_OUT_FIXED["dy"]][...] = final["dy"]
    outs[_OUT_FIXED["dz"]][...] = final["dz"]
    outs[_OUT_FIXED["steps"]][...] = final["steps"]
    outs[_OUT_FIXED["closest"]][...] = jnp.sqrt(final["closest2"])
    outs[_OUT_FIXED["horizon"]][...] = final["horizon"]
    outs[_OUT_FIXED["exited"]][...] = final["exited"]
    outs[_OUT_FIXED["h"]][...] = final["h"]
    outs[_OUT_FIXED["amount"]][...] = final["amount_ub"]
    outs[_OUT_FIXED["count"]][...] = final["count"]
    if kerr:
        # Final conjugate momentum after the slot block — multi-round
        # marching resumes the Hamiltonian state from it.
        base = OUT_FIXED + CROSS_FIELDS * K
        outs[base + 0][...] = final["qx"]
        outs[base + 1][...] = final["qy"]
        outs[base + 2][...] = final["qz"]


@functools.partial(jax.jit, static_argnames=("kcfg",))
def march_pallas(rays, params, kcfg: MarchKernelConfig):
    """Run the march kernel.

    rays: TUPLE of kcfg.in_fields float32 (N,) row arrays — px, py, pz,
    dx, dy, dz, h0, active, amount, steps_done [, qx, qy, qz for
    geodesics="kerr"] — N a multiple of BLOCK.  params: (NUM_PARAMS,)
    float32 per _P.  Returns a tuple of kcfg.out_fields (N,) row arrays
    (OUT_FIXED fixed fields + 7K slot fields [, final momentum for kerr]).

    Tuple-of-rows I/O: every field is its own contiguous row, so each
    program's loads and stores are coalesced and callers never stack or
    slice a combined array.
    """
    fin = kcfg.in_fields
    fout = kcfg.out_fields
    assert len(rays) == fin, f"{len(rays)} ray fields, kcfg expects {fin}"
    n = rays[0].shape[0]
    assert n % BLOCK == 0, f"ray count {n} not a multiple of {BLOCK}"

    params_p = jnp.zeros((PARAMS_PAD,), jnp.float32).at[:NUM_PARAMS].set(params)
    row_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))

    return tuple(pl.pallas_call(
        functools.partial(_kernel, kcfg=kcfg),
        grid=(n // BLOCK,),
        in_specs=[pl.BlockSpec((PARAMS_PAD,), lambda i: (0,))]
        + [row_spec] * fin,
        out_specs=[row_spec] * fout,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * fout,
        compiler_params=pltri.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=kcfg.interpret,
        name=f"bhx_march_{kcfg.geodesics}_{kcfg.integrator}",
    )(params_p, *rays))


def pack_params(black_hole, disk_normal, cfg) -> jnp.ndarray:
    """Build the scalar parameter vector from scene + config."""
    vals = [
        black_hole.position[0], black_hole.position[1], black_hole.position[2],
        black_hole.mass, black_hole.horizon_radius, black_hole.relativity_radius,
        disk_normal[0], disk_normal[1], disk_normal[2],
        black_hole.disk_inner, black_hole.disk_outer,
        jnp.float32(cfg.step_size), jnp.float32(cfg.opacity_cutoff),
        jnp.float32(cfg.rk_rtol), jnp.float32(cfg.rk_safety),
        jnp.float32(cfg.rk_min_factor), jnp.float32(cfg.rk_max_factor),
        jnp.float32(cfg.rk_h_min), jnp.float32(cfg.rk_h_max),
        jnp.float32(cfg.max_iterations),
        black_hole.spin,
    ]
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])
