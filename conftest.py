"""Test environment: force CPU with 8 virtual devices.

Tests run on a simulated 8-device CPU mesh so sharding/collective paths are
exercised without accelerators (SURVEY.md §4.4), and so the test workers
never open a GPU: a JAX process reserves most of a card's memory when it
first uses it.  bench.py and chip_smoke.py run on the GPU and do not
import this.  The platform is set through jax.config before any backend
is initialized.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
