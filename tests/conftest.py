"""Test harness: an 8-device virtual CPU mesh before JAX initializes.

Multi-device logic is validated without accelerators via the standard JAX
fake-backend technique (SURVEY.md section 4): 8 host platform devices let
shard_map/pjit paths compile and run under pytest. The tests run on the
CPU even where a GPU is present.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
