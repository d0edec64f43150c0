# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Failure-detection probes: every taxonomy class, the dispatch error
messages' remediation content, and the parity stubs' guidance (reference
``brainevent/_error.py`` + ``_op/main.py:418-467`` friendly stubs)."""

import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be

_HIERARCHY = [
    ('MathError', 'BrainEventError'),
    ('UnsupportedOperationError', 'BrainEventError'),
    ('BenchmarkDataFnNotProvidedError', 'BrainEventError'),
    ('KernelError', 'BrainEventError'),
    ('KernelNotAvailableError', 'KernelError'),
    ('KernelCompilationError', 'KernelError'),
    ('CompilationError', 'KernelCompilationError'),
    ('HostCompilerIncompatibleError', 'CompilationError'),
    ('KernelFallbackExhaustedError', 'KernelError'),
    ('KernelExecutionError', 'KernelError'),
    ('CUDANotInstalledError', 'KernelError'),
    ('KernelToolchainError', 'KernelError'),
    ('NvccNotFoundError', 'KernelToolchainError'),
    ('HostCompilerNotFoundError', 'KernelToolchainError'),
    ('HeaderNotFoundError', 'KernelToolchainError'),
    ('GpuArchDetectionError', 'KernelToolchainError'),
    ('UnsupportedArchError', 'KernelToolchainError'),
    ('KernelLoadError', 'KernelError'),
    ('KernelRegistrationError', 'KernelError'),
]


@pytest.mark.parametrize('name,parent', _HIERARCHY)
def test_taxonomy_hierarchy(name, parent):
    """The 20-class tree matches the reference's (SURVEY §5)."""
    cls = getattr(be, name)
    pcls = getattr(be, parent)
    assert issubclass(cls, pcls)
    assert issubclass(cls, be.BrainEventError)
    with pytest.raises(pcls):
        raise cls('probe')


def test_dispatch_error_lists_backends():
    """Requesting an unregistered backend names the available ones and
    how to switch (reference ``_op/main.py:557-584``)."""
    from brainevent_tpu.csr.binary import binary_csrmv_p_call
    data = jnp.asarray([1.0])
    indices = jnp.asarray([0, 1], jnp.int32)
    indptr = jnp.asarray([0, 1, 2], jnp.int32)
    v = jnp.asarray([True, False])
    with pytest.raises(be.KernelNotAvailableError) as ei:
        binary_csrmv_p_call(data, indices, indptr, v, shape=(2, 2),
                            backend='warp')
    msg = str(ei.value)
    assert 'jax_raw' in msg and 'backend=' in msg


def test_cuda_stub_guidance():
    """CUDA-only paths raise with guidance, not AttributeError."""
    with pytest.raises(be.CUDANotInstalledError):
        be.numba_cuda_kernel(lambda: None, outs=[])
    with pytest.raises(be.CUDANotInstalledError):
        be.load_cuda_inline('// @BE f\nvoid f() {}', 'm')


def test_gpu_device_info_without_gpu_raises():
    # measurements never fall back to the CPU: no GPU is an error
    from brainevent_tpu.ops import gpu_device_info
    with pytest.raises(RuntimeError, match='no GPU'):
        gpu_device_info()


def test_benchmark_without_data_fn():
    from brainevent_tpu.ops.core import XLACustomKernel
    prim = XLACustomKernel('probe_no_benchdata')
    with pytest.raises(be.BenchmarkDataFnNotProvidedError):
        prim.benchmark(platform='cpu')
