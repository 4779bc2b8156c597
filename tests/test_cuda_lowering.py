"""Every kernel lowers for CUDA (Triton route) without a card.

``jax.jit(f).trace(...).lower(lowering_platforms=("cuda",))`` runs the
Pallas -> Triton IR lowering on the CPU, so a primitive the Triton route
cannot lower (``reduce_or`` from ``jnp.any`` in a kernel body, say) fails
here instead of on the card.  Compiling the IR to PTX still needs the
card.
"""

import jax
import jax.numpy as jnp
import pytest

from bhx.kernels.march_pallas import (
    BLOCK,
    NUM_PARAMS,
    MarchKernelConfig,
    march_pallas,
)
from bhx.kernels.shade_pallas import (
    NUM_SHADE_PARAMS,
    SLOT_FIELDS,
    ShadeKernelConfig,
    shade_composite,
)


def _lower_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


def _march(kw):
    kcfg = MarchKernelConfig(**kw)
    rays = tuple(
        jnp.zeros((2 * BLOCK,), jnp.float32) for _ in range(kcfg.in_fields)
    )
    params = jnp.zeros((NUM_PARAMS,), jnp.float32)
    return lambda r, p: march_pallas(r, p, kcfg), rays, params


def _composite(gain):
    kcfg = ShadeKernelConfig()
    n = 300  # not a block multiple: exercises the pad
    slots = tuple(
        jnp.zeros((n,), jnp.float32)
        for _ in range(kcfg.max_crossings * SLOT_FIELDS)
    )
    cam = jnp.ones((n,), jnp.float32)
    params = jnp.zeros((NUM_SHADE_PARAMS,), jnp.float32)
    g = jnp.ones((16, 16, 4), jnp.float32) if gain else None
    return (
        lambda s, c, p: shade_composite(s, c, p, g, kcfg), slots, cam, params
    )


CASES = {
    "march_euler": lambda: _march({}),
    "march_rk45": lambda: _march({"integrator": "rk45"}),
    "march_kerr": lambda: _march({"geodesics": "kerr"}),
    "march_unguarded_record": lambda: _march({"record_guard": False}),
    "composite_gain": lambda: _composite(True),
    "composite_no_gain": lambda: _composite(False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_lowers_for_cuda(case):
    fn, *args = CASES[case]()
    text = _lower_cuda(fn, *args).as_text()
    # The Triton route emits the kernel as a Triton IR custom call.
    assert "__gpu$xla.gpu.triton" in text or "triton" in text.lower()
