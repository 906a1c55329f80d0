"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run without accelerator hardware; multi-device sharding paths are
exercised on a virtual CPU mesh per the reference test strategy (SURVEY.md
section 4d).  JAX runs on the CPU unless ``JAX_PLATFORMS`` names other
platforms: the tests marked ``gpu`` need ``JAX_PLATFORMS=cuda,cpu`` on a
machine with a card, and skip everywhere else (see the ``gpu`` fixture).

``jax.config.update`` is used rather than the environment so the setting
holds even where jax was imported before this file.
"""
import os
import sys

import pytest

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]
