"""Golden-image regression tests (SURVEY §4.2; VERDICT r4 missing #3).

Small-resolution renders of the BASELINE milestone configs, compared
against committed snapshots under ``tests/golden/``.  These catch
numerical regressions in shading / post-chain / ladder code that the
invariant tests only see indirectly.  The reference's de-facto
validation was "cargo run and look at the screen" (README.md:15-21);
these are the recorded version.

Tolerance: goldens are stored float16 (quantization ~5e-4 at 1.0);
the gate is ``atol=2e-3`` which passes same-platform re-renders with
margin while failing any real numerics change (a one-ULP change in the
march propagates to >1e-2 in lensed pixels).

Regenerate (after an INTENTIONAL image change) with:

    python tests/test_golden.py --regen

and commit the updated .npz files alongside the change that explains
them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ATOL = 2e-3


def _cases():
    """name -> (scene, cfg) for each BASELINE milestone config, at test
    scale.  Configs reuse tests.common instances wherever possible so the
    suite shares one jit cache entry with the other tests."""
    import jax.numpy as jnp

    from bhx.config import BloomConfig, FxaaConfig, Integrator
    from tests.common import (
        FAST_CFG,
        LADDER_CFG,
        cube_mesh,
        outside_camera,
        small_scene,
    )

    scene = small_scene()
    kerr_scene = dataclasses.replace(
        scene,
        black_hole=dataclasses.replace(
            scene.black_hole, spin=jnp.float32(0.9), mass=jnp.float32(0.5)
        ),
    )
    mesh_scene = dataclasses.replace(
        scene, camera=outside_camera(), meshes=(cube_mesh(),)
    )
    return {
        # BASELINE config 1: Euler Schwarzschild, sky only.
        "euler_sky": (
            scene,
            dataclasses.replace(FAST_CFG, show_disk=False),
        ),
        # BASELINE config 2: RK45 + disk + Doppler/gravitational shift.
        "rk45_disk_shift": (
            scene,
            dataclasses.replace(FAST_CFG, integrator=Integrator.RK45),
        ),
        # BASELINE config 3: mesh BVH + relativity sphere + feathering.
        "mesh_feather": (mesh_scene, FAST_CFG),
        # BASELINE config 4 (at test scale): ladder + bloom + ACES + FXAA.
        "ladder_post": (
            scene,
            dataclasses.replace(
                LADDER_CFG,
                bloom=BloomConfig(enabled=True),
                fxaa=FxaaConfig(enabled=True),
                tonemap=True,
            ),
        ),
        # Beyond-reference capability: exact Kerr geodesics, spin 0.9.
        "kerr_spin09": (
            kerr_scene,
            dataclasses.replace(FAST_CFG, geodesics="kerr",
                                max_iterations=400),
        ),
    }


@pytest.mark.parametrize("name", [
    "euler_sky", "rk45_disk_shift", "mesh_feather", "ladder_post",
    "kerr_spin09",
])
def test_golden(name):
    from bhx.pipeline import render_jit

    scene, cfg = _cases()[name]
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    assert os.path.exists(path), (
        f"golden snapshot missing: {path} — run "
        "`python tests/test_golden.py --regen` and commit it"
    )
    want = np.load(path)["img"].astype(np.float32)
    got = np.asarray(render_jit(scene, cfg), np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, (
        f"golden {name}: max|diff|={diff.max():.5f} at "
        f"{np.unravel_index(diff.argmax(), diff.shape)} "
        f"(bad_frac={(diff > ATOL).mean():.4f}) — if the image change is "
        "intentional, regenerate with `python tests/test_golden.py --regen`"
    )


def _regen():
    from bhx.pipeline import render_jit

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (scene, cfg) in _cases().items():
        img = np.asarray(render_jit(scene, cfg), np.float16)
        np.savez_compressed(
            os.path.join(GOLDEN_DIR, f"{name}.npz"), img=img
        )
        print(f"wrote {name}.npz  shape={img.shape} "
              f"mean={float(img.astype(np.float32).mean()):.4f}")


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        # Goldens are CPU snapshots (the suite runs on CPU — conftest.py);
        # force the same platform here so a regen run on a GPU machine
        # doesn't bake device-specific numerics into the files.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(
            0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        _regen()
    else:
        print(__doc__)
