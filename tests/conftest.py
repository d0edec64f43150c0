# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Test configuration: force an 8-device virtual CPU mesh.

The whole suite — including the multi-device sharding tests — runs on the
CPU, mirroring the reference's CPU-CI strategy (its
``.github/workflows/CI.yml``). Runs on the GPU are ``python chip_smoke.py``
(one card) and ``python chip_smoke.py --chips 4`` (four cards).
"""

import os

# Must be set before the CPU client is created.
os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8'
)

import jax  # noqa: E402

# a CPU suite unless JAX_PLATFORMS names the card: on the GPU machine,
# `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the tests
# marked `gpu` (they skip everywhere else, see the gpu_device fixture)
if not os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', 'cpu')

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Auto-mark slow backends, mirroring reference ``conftest.py:36-59``."""
    for item in items:
        params = getattr(item, 'callspec', None)
        if params is None:
            continue
        backend = params.params.get('backend')
        if backend in ('numba', 'numba_cuda', 'warp', 'taichi'):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope='module')
def _clear_jax_caches_per_module():
    """Bound compiler-state growth over the full suite.

    The suite compiles thousands of distinct XLA programs in one process;
    letting the executable/tracing caches accumulate across all ~27
    modules has produced an XLA CPU compiler segfault late in the run
    (in ``backend_compile_and_load``, ~80% through, while each module
    passes in isolation). Dropping the caches at module boundaries keeps
    the process at single-module footprint; cross-module cache reuse is
    minimal anyway (modules exercise disjoint primitives)."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: the device is decided here, at run time,
    never while a module is imported (workers must collect the same
    tests)."""
    devices = jax.devices('gpu') if _has_gpu() else []
    if not devices:
        pytest.skip('needs an NVIDIA GPU; run on the card with '
                    '`python -m pytest -m gpu` or `python chip_smoke.py`')
    return devices[0]


def _has_gpu() -> bool:
    try:
        return bool(jax.devices('gpu'))
    except RuntimeError:
        return False


@pytest.fixture
def rng():
    import numpy as np
    return np.random.default_rng(20260816)
