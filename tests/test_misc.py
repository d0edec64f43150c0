# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Tests for conversions, sddmm, deprecation shim, CLI, and namescope."""

import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu._misc import NameScope, namescope


class TestConversions:
    def test_csr_to_coo(self):
        indptr = jnp.asarray([0, 2, 3, 5], jnp.int32)
        indices = jnp.asarray([0, 2, 1, 0, 3], jnp.int32)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        np.testing.assert_array_equal(np.asarray(rows), [0, 0, 1, 2, 2])
        np.testing.assert_array_equal(np.asarray(cols), np.asarray(indices))

    def test_csr_to_csc_roundtrip(self, rng):
        dense = ((rng.random((8, 10)) < 0.4) * rng.normal(size=(8, 10))
                 ).astype(np.float32)
        A = be.CSR.fromdense(jnp.asarray(dense))
        csc_indptr, csc_rows, perm = be.csr_to_csc_index(
            A.indptr, A.indices, shape=A.shape)
        data_csc = np.asarray(A.data)[np.asarray(perm)]
        # rebuild dense from CSC
        out = np.zeros((8, 10), np.float32)
        csc_indptr = np.asarray(csc_indptr)
        csc_rows = np.asarray(csc_rows)
        for c in range(10):
            for k in range(csc_indptr[c], csc_indptr[c + 1]):
                out[csc_rows[k], c] = data_csc[k]
        np.testing.assert_allclose(out, dense)
        # and back
        r_indptr, r_cols, perm2 = be.csc_to_csr_index(
            jnp.asarray(csc_indptr), jnp.asarray(csc_rows), shape=A.shape)
        np.testing.assert_array_equal(np.asarray(r_indptr),
                                      np.asarray(A.indptr))
        np.testing.assert_array_equal(np.asarray(r_cols),
                                      np.asarray(A.indices))

    def test_coo2csr(self):
        rows = jnp.asarray([2, 0, 1, 0], jnp.int32)
        cols = jnp.asarray([1, 0, 2, 3], jnp.int32)
        data = jnp.asarray([1.0, 2.0, 3.0, 4.0])
        d, idx, indptr = be.coo2csr(rows, cols, data, shape=(3, 4))
        np.testing.assert_array_equal(np.asarray(indptr), [0, 2, 3, 4])
        np.testing.assert_array_equal(np.asarray(idx), [0, 3, 2, 1])
        np.testing.assert_allclose(np.asarray(d), [2, 4, 3, 1])


class TestSDDMM:
    def test_coo_indices(self, rng):
        A = rng.normal(size=(6, 4)).astype(np.float32)
        B = rng.normal(size=(4, 7)).astype(np.float32)
        pre = jnp.asarray([0, 2, 5], jnp.int32)
        post = jnp.asarray([1, 3, 6], jnp.int32)
        out = be.sddmm_coo_indices(jnp.asarray(A), jnp.asarray(B), pre, post)
        want = (A @ B)[np.asarray(pre), np.asarray(post)]
        np.testing.assert_allclose(np.asarray(out.data), want, rtol=1e-5)

    def test_bcoo(self, rng):
        from jax.experimental.sparse import BCOO
        A = rng.normal(size=(5, 3)).astype(np.float32)
        B = rng.normal(size=(3, 5)).astype(np.float32)
        idx = jnp.asarray([[0, 0], [2, 3]], jnp.int32)
        pattern = BCOO((jnp.ones(2), idx), shape=(5, 5))
        out = be.sddmm_bcoo(jnp.asarray(A), jnp.asarray(B), pattern)
        want = (A @ B)[[0, 2], [0, 3]]
        np.testing.assert_allclose(np.asarray(out.data), want, rtol=1e-5)


class TestDeprecation:
    def test_rename_warns_and_resolves(self):
        with pytest.warns(DeprecationWarning, match='BinaryArray'):
            cls = be.EventArray
        assert cls is be.BinaryArray

    def test_removed_raises_with_migration(self):
        with pytest.raises(AttributeError, match='CSR / CSC'):
            be.COO

    def test_unknown_name(self):
        with pytest.raises(AttributeError, match='no attribute'):
            be.definitely_not_a_name

    def test_dir_includes_renames(self):
        assert 'EventArray' in dir(be)

    def test_jitc_homo_rename(self):
        with pytest.warns(DeprecationWarning):
            assert be.JITCHomoR is be.JITCScalarR


class TestCLI:
    def test_list_primitives(self, capsys):
        from brainevent_tpu._cli import main
        assert main(['list-primitives', '--data', 'csr', 'binary']) == 0
        out = capsys.readouterr().out
        assert 'binary_csrmv' in out

    def test_no_match(self, capsys):
        from brainevent_tpu._cli import main
        assert main(['benchmark-performance', '--data', 'nope_tag']) == 1

    def test_help(self, capsys):
        from brainevent_tpu._cli import main
        assert main([]) == 0

    @pytest.mark.slow
    def test_benchmark_small(self, tmp_path):
        from brainevent_tpu._cli import main
        out = tmp_path / 'r.json'
        code = main(['benchmark-performance', '--data', 'dense', 'mv',
                     '--n-runs', '1', '--n-warmup', '0',
                     '--output', str(out)])
        assert code == 0 and out.exists()

    def test_list_primitives_shows_cpu_and_gpu_kernels(self, capsys):
        from brainevent_tpu._cli import main
        assert main(['list-primitives', '--data', 'fcn', 'binary']) == 0
        out = capsys.readouterr().out
        assert 'binary_fcnmv' in out
        assert "backends={'cpu': [" in out and "'gpu': ['jax_raw']}" in out


class TestNameScope:
    def test_wraps_and_caches(self):
        calls = []

        @namescope(name='myop', static_argnames=('flag',))
        def op(x, *, flag=False):
            calls.append(1)
            return x * (2 if flag else 3)

        a = op(jnp.asarray(2.0), flag=True)
        b = op(jnp.asarray(2.0), flag=False)
        assert float(a) == 4.0 and float(b) == 6.0

    def test_registry_counts(self):
        # all 45+ reference primitives should be registered
        names = be.get_all_primitive_names()
        expected = [
            'binary_csrmv', 'binary_csrmm', 'binary_csrmv_indexed',
            'binary_csrmm_indexed', 'csrmv', 'csrmm', 'csrmv_dt2t',
            'csrmm_dt2t', 'update_csr_on_binary_pre',
            'update_csr_on_binary_post', 'csr_slice_rows',
            'csr_slice_rows_grad',
            'binary_densemv', 'binary_densemm', 'update_dense_on_binary_pre',
            'update_dense_on_binary_post',
            'binary_1d_array_index', 'binary_2d_array_index',
            'binary_2d_compact_only', 'binary_2d_csc_encode',
            'binary_2d_csr_fill', 'binary_2d_csr_row_count',
            'binary_2d_pair_stream_encode', 'binary_2d_row_sparse_encode',
            'binary_fcnmv', 'binary_fcnmm', 'fcn_plasticity_row',
            'fcnmv', 'fcnmm',
            'jits', 'jitsmv', 'jitsmm', 'binary_jitsmv', 'binary_jitsmm',
            'jits_csr_count', 'jits_csr_fill',
            'jitn', 'jitnmv', 'jitnmm', 'binary_jitnmv', 'binary_jitnmm',
            'jitn_csr_count', 'jitn_csr_fill',
            'jitu', 'jitumv', 'jitumm', 'binary_jitumv', 'binary_jitumm',
            'jitu_csr_count', 'jitu_csr_fill',
        ]
        missing = [n for n in expected if n not in names]
        assert not missing, f'missing primitives: {missing}'
        assert len(expected) >= 45


class TestNumbaBridge:
    def test_numba_kernel_executes(self):
        import jax
        import jax.numpy as jnp
        from brainevent_tpu import numba_kernel

        def kern(x, y, out):
            for i in range(x.shape[0]):
                out[i] = x[i] * 2 + y[i]

        call = numba_kernel(kern, outs=[jax.ShapeDtypeStruct((4,), jnp.float32)])
        x = jnp.arange(4.0)
        y = jnp.ones(4)
        (out,) = call(x, y)
        np.testing.assert_allclose(np.asarray(out), np.arange(4.0) * 2 + 1)

    def test_numba_kernel_alias_init(self):
        import jax
        import jax.numpy as jnp
        from brainevent_tpu import numba_kernel

        def kern(w, delta, out):
            for i in range(w.shape[0]):
                out[i] += delta[i]

        call = numba_kernel(kern, outs=[jax.ShapeDtypeStruct((3,), jnp.float32)],
                            input_output_aliases={0: 0})
        (out,) = call(jnp.asarray([1.0, 2.0, 3.0]), jnp.ones(3))
        np.testing.assert_allclose(np.asarray(out), [2, 3, 4])

    def test_cuda_stubs(self):
        from brainevent_tpu import numba_cuda_kernel, numba_cuda_callable
        from brainevent_tpu._error import CUDANotInstalledError
        with pytest.raises(CUDANotInstalledError):
            numba_cuda_kernel(lambda: None)
        with pytest.raises(CUDANotInstalledError):
            numba_cuda_callable(lambda: None)


class TestScalarRNGParity:
    def test_scalar_light_matches_vectorized(self):
        from brainevent_tpu.rng import scalar as srng
        from brainevent_tpu import rng as vrng
        import jax.numpy as jnp
        rows = np.arange(16, dtype=np.uint32)
        want = np.array([srng.light_rng_uniform01(9, r, 3) for r in rows],
                        dtype=np.float32)
        got = np.asarray(vrng.light_rng_uniform01(
            jnp.uint32(9), jnp.asarray(rows), jnp.uint32(3)))
        np.testing.assert_array_equal(got, want)

    def test_scalar_lfsr_matches_class(self):
        from brainevent_tpu.rng import scalar as srng
        from brainevent_tpu.rng import PallasLFSR88RNG
        st = srng.lfsr88_seed(42)
        want = [int(srng.lfsr88_randint(st)) for _ in range(5)]
        g = PallasLFSR88RNG(42)
        got = [int(g.randint()) for _ in range(5)]
        assert got == want

    def test_dispatch_tables(self):
        from brainevent_tpu.rng import get_numba_lfsr_funcs, get_numba_light_rng_funcs
        fns = get_numba_lfsr_funcs()
        assert set(fns) >= {'seed', 'rand', 'randn'}
        lf = get_numba_light_rng_funcs()
        assert set(lf) >= {'mix32', 'next', 'initial_q'}


class TestBraineventAlias:
    def test_import_brainevent(self):
        import brainevent
        assert brainevent.BinaryArray is be.BinaryArray
        assert brainevent.__version__ == be.__version__

    def test_alias_deprecation_hooks(self):
        import brainevent
        with pytest.warns(DeprecationWarning):
            assert brainevent.EventArray is be.BinaryArray

    def test_submodule_alias(self):
        import brainevent.config as cfg
        assert cfg.get_lfsr_algorithm() in ('lfsr88', 'lfsr113', 'lfsr128')
