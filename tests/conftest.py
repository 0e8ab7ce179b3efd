"""Test configuration: run everything on a virtual 8-device CPU mesh.

Unit and sharding tests use XLA's host-platform device emulation, forced
through jax.config, which wins over the environment. ``--gpu`` leaves the
default platform alone instead, so the tests marked ``gpu`` can run on a
card (``python -m pytest tests/ --gpu -m gpu``); without a card they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="keep JAX's default platform (for tests marked "
                     "gpu) instead of the virtual CPU mesh")


def pytest_configure(config):
    if not config.getoption("--gpu"):
        jax.config.update("jax_platforms", "cpu")
