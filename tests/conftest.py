"""Test configuration: the CPU with 8 virtual devices, so sharding tests run
without accelerator hardware (SURVEY.md §4 — the reference gets the same
effect from Taichi's silent arch fallback on CI). Run the suite with
``JAX_PLATFORMS=cpu``; the platform and device count are set here before
JAX starts. On a GPU machine, ``RTGS_TEST_GPU=1 python -m pytest tests -m
gpu`` runs the tests marked ``gpu`` on the card instead.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgs_tpu.utils.platform import (enable_compilation_cache,  # noqa: E402
                                     force_cpu_devices)

ON_GPU = bool(os.environ.get("RTGS_TEST_GPU"))
if not ON_GPU:
    force_cpu_devices(8)

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache, same rule as the program's: most of the
# suite's wall time is XLA compiles repeated on every run.
enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert ON_GPU or jax.local_devices()[0].platform == "cpu"


def pytest_collection_modifyitems(config, items):
    """Default suite stays <5 min: tests marked ``slow`` (the 1M-splat crop
    dominates wall time; multihost spawns real processes) only run with
    ``RTGS_SLOW=1`` or an explicit ``-m slow``."""
    if os.environ.get("RTGS_SLOW") or "slow" in config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow; set RTGS_SLOW=1 or -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(42)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default device is a GPU.
    Decided here, at run time, never while a module is imported."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernel); chip_smoke.py "
                    "covers this path on the card")
