"""Test configuration: run on a virtual 8-device CPU backend so tests are
hermetic and the sharding paths are exercised — the standard JAX
fake-backend pattern (SURVEY.md §4).  Tests marked `gpu` need the card and
skip elsewhere; run them there with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the slow tier too (multi-process tests; also enabled by "
             "TPU_VITERBI_FULL_TESTS=1)")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: the default run stays under a few minutes; the
    slowest tests (multi-process runs, each covering a contract that also
    has a faster guard) form the `slow` tier, run by `pytest tests/
    --full`."""
    if config.getoption("--full") or \
            os.environ.get("TPU_VITERBI_FULL_TESTS") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: run with --full (or "
                            "TPU_VITERBI_FULL_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Tests marked `gpu` run the compiled CUDA kernel, which has no
    interpret mode: they skip unless JAX runs on a GPU.  Decided here, at
    run time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the CUDA decode kernel has no "
                    "interpret mode")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
