# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""API-parity test: every public name of the reference package
(chaobrain/brainevent v0.2.0 ``__all__``, 165 names) must exist here, so
downstream code migrates with an import swap (or none, via the
``brainevent`` alias module)."""

import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be

# the reference's complete __all__ (brainevent/__init__.py, v0.2.0)
REFERENCE_ALL = [
    'EventRepresentation', 'BinaryArray', 'BitPackedBinary', 'bitpack',
    'CompactBinary', 'DataRepresentation', 'CSR', 'CSC',
    'binary_csrmv', 'binary_csrmv_p', 'binary_csrmv_indexed', 'binary_csrmv_indexed_p',
    'binary_csrmm', 'binary_csrmm_p', 'binary_csrmm_indexed', 'binary_csrmm_indexed_p',
    'csrmv', 'csrmv_p', 'csrmm', 'csrmm_p',
    'csrmv_dt2t', 'cscmv_dt2t', 'csrmv_dt2t_p', 'csrmm_dt2t',
    'cscmm_dt2t', 'csrmm_dt2t_p', 'update_csr_on_binary_pre', 'update_csr_on_binary_pre_p', 'update_csr_on_binary_post',
    'update_csr_on_binary_post_p', 'update_csc_on_binary_pre', 'update_csc_on_binary_post', 'csr_slice_rows',
    'csr_slice_rows_p', 'Dense', 'binary_densemv', 'binary_densemv_p',
    'binary_densemm', 'binary_densemm_p', 'update_dense_on_binary_pre', 'update_dense_on_binary_pre_p',
    'update_dense_on_binary_post', 'update_dense_on_binary_post_p', 'JITCMatrix', 'JITCScalarMatrix',
    'JITCScalarR', 'JITCScalarC', 'binary_jitsmv', 'binary_jitsmv_p',
    'binary_jitsmm', 'binary_jitsmm_p', 'jits', 'jits_p',
    'jitsmv', 'jitsmv_p', 'jitsmm', 'jitsmm_p',
    'jitsmv_dt2t', 'JITCNormalR', 'JITCNormalC', 'binary_jitnmv',
    'binary_jitnmv_p', 'binary_jitnmm', 'binary_jitnmm_p', 'jitn',
    'jitn_p', 'jitnmv', 'jitnmv_p', 'jitnmm',
    'jitnmm_p', 'jitnmv_dt2t', 'JITCUniformR', 'JITCUniformC',
    'binary_jitumv', 'binary_jitumv_p', 'binary_jitumm', 'binary_jitumm_p',
    'jitu', 'jitu_p', 'jitumv', 'jitumv_p',
    'jitumm', 'jitumm_p', 'jitumv_dt2t', 'FixedNumConn',
    'FixedNumPerPost', 'FixedNumPerPre', 'binary_fcnmv', 'binary_fcnmv_p',
    'binary_fcnmm', 'binary_fcnmm_p', 'fcnmv', 'fcnmm',
    'fcnmv_dt2t', 'fcnmm_dt2t', 'update_fixed_post_conn_on_binary_pre', 'update_fixed_pre_conn_on_binary_post',
    'fcn_plasticity_row_p', 'XLACustomKernel', 'KernelEntry', 'BenchmarkConfig',
    'BenchmarkRecord', 'BenchmarkResult', 'benchmark_function', 'numba_kernel',
    'numba_cuda_kernel', 'numba_cuda_callable', 'defjvp', 'general_batching_rule',
    'jaxtype_to_warptype', 'jaxinfo_to_warpinfo', 'load_cuda_inline', 'load_cuda_file',
    'load_cuda_dir', 'load_cpp_inline', 'load_cpp_file', 'set_cache_dir',
    'get_cache_dir', 'clear_cache', 'print_diagnostics', 'CompiledModule',
    'register_ffi_target', 'list_registered_targets', 'normalize_tokens', 'CompilerBackend',
    'CUDABackend', 'CPPBackend', 'HIPBackend', 'PallasLFSR88RNG',
    'PallasLFSR113RNG', 'PallasLFSR128RNG', 'PallasLFSRRNG', 'get_pallas_lfsr_rng_class',
    'BrainEventError', 'MathError', 'UnsupportedOperationError', 'KernelError',
    'KernelNotAvailableError', 'KernelCompilationError', 'KernelFallbackExhaustedError', 'KernelExecutionError',
    'KernelToolchainError', 'CompilationError', 'KernelRegistrationError', 'BenchmarkDataFnNotProvidedError',
    'CUDANotInstalledError', 'NvccNotFoundError', 'HostCompilerNotFoundError', 'HeaderNotFoundError',
    'GpuArchDetectionError', 'HostCompilerIncompatibleError', 'UnsupportedArchError', 'KernelLoadError',
    'csr_to_coo_index', 'coo_to_csc_index', 'csr_to_csc_index', 'csc_to_csr_index',
    'coo2csr', 'config', 'get_registry', 'get_primitives_by_tags',
    'get_all_primitive_names',
]


def test_every_reference_export_exists():
    missing = [n for n in REFERENCE_ALL if not hasattr(be, n)]
    assert not missing, f'missing reference exports: {missing}'


def test_alias_module_has_them_too():
    import brainevent
    missing = [n for n in REFERENCE_ALL if not hasattr(brainevent, n)]
    assert not missing, f'missing from alias module: {missing}'


def test_every_primitive_has_jax_raw_on_cpu_and_gpu():
    """Every library primitive offers its XLA kernel on both platforms."""
    # ignore throwaway primitives registered by other test modules
    reg = {n: p for n, p in be.get_registry().items()
           if not n.startswith(('test_', 'probe_', 'my_'))}
    assert len(reg) >= 45
    missing = {
        name: (prim.available_backends('cpu'), prim.available_backends('gpu'))
        for name, prim in reg.items()
        if 'jax_raw' not in prim.available_backends('cpu')
        or 'jax_raw' not in prim.available_backends('gpu')
    }
    assert not missing, f'primitives lacking an XLA kernel: {missing}'


def test_unregistered_backend_is_an_actionable_error():
    """A backend name that is not registered raises, naming the ones that
    are (e.g. code written for a removed accelerator-specific kernel)."""
    from brainevent_tpu.events import binary_2d_csr_row_count_p_call
    x = jnp.asarray(np.random.default_rng(0).random((16, 10)) < 0.3)
    with pytest.raises(be.KernelNotAvailableError, match='jax_raw'):
        binary_2d_csr_row_count_p_call(x, backend='pallas')
    (b,) = binary_2d_csr_row_count_p_call(x, backend='jax_raw')
    np.testing.assert_array_equal(np.asarray(b),
                                  np.asarray(x).sum(axis=1))


class TestDropInUsage:
    """End-to-end snippets a reference user would write against
    ``import brainevent`` must run unchanged."""

    def test_csr_matmul_snippet(self, rng):
        import brainevent
        dense = (rng.random((20, 30)) < 0.2) * rng.normal(size=(20, 30))
        csr = brainevent.CSR.fromdense(jnp.asarray(dense, jnp.float32))
        v = jnp.asarray(rng.normal(size=30), jnp.float32)
        out = csr @ v
        np.testing.assert_allclose(np.asarray(out),
                                   dense.astype(np.float32) @ np.asarray(v),
                                   rtol=1e-4, atol=1e-4)

    def test_binary_array_event_matmul(self, rng):
        import brainevent
        spikes = brainevent.BinaryArray(jnp.asarray(rng.random(20) < 0.3))
        W = jnp.asarray(rng.normal(size=(20, 16)), jnp.float32)
        out = spikes @ W
        want = np.asarray(spikes.value, np.float32) @ np.asarray(W)
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                                   atol=1e-4)

    def test_jitc_class_snippet(self, rng):
        import brainevent
        m = brainevent.JITCNormalR((0.5, 0.2, 0.1, 5), shape=(24, 36))
        v = jnp.asarray(rng.normal(size=36), jnp.float32)
        out = m @ v
        dense = np.asarray(m.todense())
        np.testing.assert_allclose(np.asarray(out),
                                   dense @ np.asarray(v), rtol=1e-4,
                                   atol=1e-4)

    def test_deprecated_rename_warns_and_resolves(self):
        import brainevent
        with pytest.warns(DeprecationWarning):
            cls = brainevent.EventArray     # v0.0.7 name of BinaryArray
        assert cls is brainevent.BinaryArray

    def test_version_and_dir(self):
        import brainevent
        import brainevent_tpu
        assert brainevent.__version__ == brainevent_tpu.__version__
        assert 'binary_csrmv' in dir(brainevent)

    def test_cli_entry_runs(self):
        from brainevent_tpu._cli import main
        assert main(['list-primitives', '--data', 'csr']) == 0
