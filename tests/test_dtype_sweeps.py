# Copyright 2026 The brainevent-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
# ==============================================================================

"""Systematic dtype-policy sweeps per op family.

Mirrors the reference's per-package dtype matrices (weight dtype x index
dtype x transpose x homo/hetero x backend against a dense oracle — e.g.
``brainevent/_csr/main_test.py``, ``brainevent/_misc.py:196-270``): f32 /
bf16 / f64-under-x64 weights, int32 / int64-under-x64 indices, bool / float
events. Backends sweep ``available_backends`` (every registered kernel)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be


@contextlib.contextmanager
def x64_enabled():
    old = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', True)
    try:
        yield
    finally:
        jax.config.update('jax_enable_x64', old)


def _tol(dtype):
    if dtype == jnp.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    if dtype == jnp.float64:
        return dict(rtol=1e-10, atol=1e-12)
    return dict(rtol=1e-5, atol=1e-6)


def _maybe_x64(dtype):
    needs = dtype in (jnp.float64, jnp.int64)
    return x64_enabled() if needs else contextlib.nullcontext()


def _csr_fixture(rng, m, k, wdtype, idtype, homo):
    dense_mask = rng.random((m, k)) < 0.25
    rows, cols = np.nonzero(dense_mask)
    counts = np.bincount(rows, minlength=m)
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                         dtype=idtype)
    indices = jnp.asarray(cols, dtype=idtype)
    if homo:
        w = jnp.asarray([1.5], dtype=wdtype)
        dense = dense_mask.astype(np.float64) * 1.5
    else:
        vals = rng.normal(size=rows.shape[0])
        w = jnp.asarray(vals, dtype=wdtype)
        dense = np.zeros((m, k))
        dense[rows, cols] = np.asarray(jnp.asarray(vals, dtype=wdtype),
                                       dtype=np.float64)
    return w, indices, indptr, dense


WDTYPES = [jnp.float32, jnp.bfloat16, jnp.float64]
IDTYPES = [jnp.int32, jnp.int64]


class TestCsrDtypeSweep:
    @pytest.mark.parametrize('wdtype', WDTYPES)
    @pytest.mark.parametrize('idtype', IDTYPES)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [False, True])
    def test_binary_csrmv(self, rng, wdtype, idtype, transpose, homo):
        with _maybe_x64(wdtype if wdtype == jnp.float64 else idtype):
            w, indices, indptr, dense = _csr_fixture(
                rng, 12, 16, wdtype, idtype, homo)
            n_in = 12 if transpose else 16
            spk = rng.random(n_in) < 0.4
            want = (dense.T if transpose else dense) @ spk
            for backend in be.csr.binary.binary_csrmv_p.available_backends('cpu'):
                got = be.binary_csrmv(w, indices, indptr, jnp.asarray(spk),
                                      shape=(12, 16), transpose=transpose,
                                      backend=backend)
                assert got.dtype == wdtype
                np.testing.assert_allclose(
                    np.asarray(got, dtype=np.float64), want,
                    **_tol(wdtype), err_msg=backend)

    @pytest.mark.parametrize('wdtype', WDTYPES)
    @pytest.mark.parametrize('transpose', [False, True])
    def test_csrmv_float_operand(self, rng, wdtype, transpose):
        with _maybe_x64(wdtype):
            w, indices, indptr, dense = _csr_fixture(
                rng, 12, 16, wdtype, jnp.int32, homo=False)
            n_in = 12 if transpose else 16
            v = jnp.asarray(rng.normal(size=n_in), dtype=wdtype)
            want = (dense.T if transpose else dense) @ np.asarray(
                v, dtype=np.float64)
            got = be.csrmv(w, indices, indptr, v, shape=(12, 16),
                           transpose=transpose)
            assert got.dtype == wdtype
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))

    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('sdtype', ['bool', 'float'])
    def test_binary_csrmm(self, rng, wdtype, transpose, sdtype):
        with _maybe_x64(wdtype):
            w, indices, indptr, dense = _csr_fixture(
                rng, 10, 14, wdtype, jnp.int32, homo=False)
            n_in = 10 if transpose else 14
            S_b = rng.random((n_in, 3)) < 0.4
            S = jnp.asarray(S_b if sdtype == 'bool'
                            else S_b.astype(np.float32))
            want = (dense.T if transpose else dense) @ S_b
            got = be.binary_csrmm(w, indices, indptr, S, shape=(10, 14),
                                  transpose=transpose)
            assert got.dtype == wdtype
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))

    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_csrmm(self, rng, wdtype, transpose):
        with _maybe_x64(wdtype):
            w, indices, indptr, dense = _csr_fixture(
                rng, 10, 14, wdtype, jnp.int32, homo=False)
            n_in = 10 if transpose else 14
            B = jnp.asarray(rng.normal(size=(n_in, 3)), dtype=wdtype)
            want = (dense.T if transpose else dense) @ np.asarray(
                B, dtype=np.float64)
            got = be.csrmm(w, indices, indptr, B, shape=(10, 14),
                           transpose=transpose)
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))

    @pytest.mark.parametrize('idtype', IDTYPES)
    def test_indexed_variants(self, rng, idtype):
        """Perm-fused (CSC-mirror) products against the direct route."""
        with _maybe_x64(idtype):
            w, indices, indptr, dense = _csr_fixture(
                rng, 12, 12, jnp.float32, idtype, homo=False)
            csc_indptr, csc_rows, perm = be.csr_to_csc_index(
                indptr, indices, shape=(12, 12))
            spk = rng.random(12) < 0.4
            want = dense.T @ spk
            got = be.csr.binary.binary_csrmv_indexed(
                w, jnp.asarray(csc_rows, dtype=idtype),
                jnp.asarray(csc_indptr, dtype=idtype),
                jnp.asarray(np.asarray(perm), dtype=idtype),
                jnp.asarray(spk), shape=(12, 12), transpose=False)
            np.testing.assert_allclose(np.asarray(got), want,
                                       rtol=1e-5, atol=1e-6)


class TestFcnDtypeSweep:
    @pytest.mark.parametrize('wdtype', WDTYPES)
    @pytest.mark.parametrize('idtype', IDTYPES)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [False, True])
    def test_binary_fcnmv(self, rng, wdtype, idtype, transpose, homo):
        with _maybe_x64(wdtype if wdtype == jnp.float64 else idtype):
            n_pre, n_post, K = 10, 14, 4
            idx_np = rng.integers(0, n_post, (n_pre, K))
            indices = jnp.asarray(idx_np, dtype=idtype)
            if homo:
                w = jnp.asarray([0.5], dtype=wdtype)
                wd = np.full((n_pre, K), 0.5)
            else:
                vals = rng.normal(size=(n_pre, K))
                w = jnp.asarray(vals, dtype=wdtype)
                wd = np.asarray(w, dtype=np.float64)
            dense = np.zeros((n_pre, n_post))
            for i in range(n_pre):
                for j in range(K):
                    dense[i, idx_np[i, j]] += wd[i, j]
            n_in = n_pre if transpose else n_post
            spk = rng.random(n_in) < 0.4
            want = (dense.T if transpose else dense) @ spk
            for backend in be.fcn.binary.binary_fcnmv_p.available_backends('cpu'):
                got = be.binary_fcnmv(w, indices, jnp.asarray(spk),
                                      shape=(n_pre, n_post),
                                      transpose=transpose, backend=backend)
                assert got.dtype == wdtype
                np.testing.assert_allclose(
                    np.asarray(got, dtype=np.float64), want,
                    **_tol(wdtype), err_msg=backend)

    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_fcnmm(self, rng, wdtype, transpose):
        with _maybe_x64(wdtype):
            n_pre, n_post, K, nb = 10, 14, 4, 3
            idx_np = rng.integers(0, n_post, (n_pre, K))
            vals = rng.normal(size=(n_pre, K))
            w = jnp.asarray(vals, dtype=wdtype)
            dense = np.zeros((n_pre, n_post))
            for i in range(n_pre):
                for j in range(K):
                    dense[i, idx_np[i, j]] += float(
                        np.asarray(w, dtype=np.float64)[i, j])
            n_in = n_pre if transpose else n_post
            B = jnp.asarray(rng.normal(size=(n_in, nb)), dtype=wdtype)
            want = (dense.T if transpose else dense) @ np.asarray(
                B, dtype=np.float64)
            got = be.fcn.float.fcnmm(w, jnp.asarray(idx_np, jnp.int32), B,
                                     shape=(n_pre, n_post),
                                     transpose=transpose)
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))


class TestDenseDtypeSweep:
    @pytest.mark.parametrize('wdtype', WDTYPES)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('sdtype', ['bool', 'float'])
    def test_binary_densemv(self, rng, wdtype, transpose, sdtype):
        with _maybe_x64(wdtype):
            w = jnp.asarray(rng.normal(size=(8, 12)), dtype=wdtype)
            n_in = 8 if transpose else 12
            spk_b = rng.random(n_in) < 0.4
            spk = jnp.asarray(spk_b if sdtype == 'bool'
                              else spk_b.astype(np.float32))
            wd = np.asarray(w, dtype=np.float64)
            want = (wd.T if transpose else wd) @ spk_b
            for backend in be.dense.binary.binary_densemv_p.available_backends('cpu'):
                got = be.binary_densemv(w, spk, transpose=transpose,
                                        backend=backend)
                assert got.dtype == wdtype
                np.testing.assert_allclose(
                    np.asarray(got, dtype=np.float64), want,
                    **_tol(wdtype), err_msg=backend)

    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_binary_densemm(self, rng, wdtype, transpose):
        with _maybe_x64(wdtype):
            w = jnp.asarray(rng.normal(size=(8, 12)), dtype=wdtype)
            n_in = 8 if transpose else 12
            S_b = rng.random((n_in, 3)) < 0.4
            wd = np.asarray(w, dtype=np.float64)
            want = (wd.T if transpose else wd) @ S_b
            for backend in be.dense.binary.binary_densemm_p.available_backends('cpu'):
                got = be.binary_densemm(w, jnp.asarray(S_b),
                                        transpose=transpose, backend=backend)
                np.testing.assert_allclose(
                    np.asarray(got, dtype=np.float64), want,
                    **_tol(wdtype), err_msg=backend)


class TestPlasticityDtypeSweep:
    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('op', ['pre', 'post'])
    def test_csr_plasticity(self, rng, wdtype, op):
        with _maybe_x64(wdtype):
            m, k = 10, 12
            w, indices, indptr, dense = _csr_fixture(
                rng, m, k, wdtype, jnp.int32, homo=False)
            counts = np.diff(np.asarray(indptr))
            rows = np.repeat(np.arange(m), counts)
            cols = np.asarray(indices)
            if op == 'pre':
                spk = rng.random(m) < 0.5
                trace = rng.normal(size=k)
                want = np.asarray(w, np.float64) + np.where(
                    spk[rows], trace[cols], 0.0)
                got = be.update_csr_on_binary_pre(
                    w, indices, indptr, jnp.asarray(spk),
                    jnp.asarray(trace, dtype=wdtype), shape=(m, k))
            else:
                spk = rng.random(k) < 0.5
                trace = rng.normal(size=m)
                want = np.asarray(w, np.float64) + np.where(
                    spk[cols], trace[rows], 0.0)
                _, _, perm = be.csr_to_csc_index(indptr, indices,
                                                 shape=(m, k))
                got = be.update_csr_on_binary_post(
                    w, indices, indptr, jnp.asarray(np.asarray(perm)),
                    jnp.asarray(trace, dtype=wdtype), jnp.asarray(spk),
                    shape=(m, k))
            assert got.dtype == wdtype
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))

    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    def test_dense_plasticity(self, rng, wdtype):
        with _maybe_x64(wdtype):
            m, k = 8, 10
            w = jnp.asarray(rng.normal(size=(m, k)), dtype=wdtype)
            spk = rng.random(m) < 0.5
            trace = rng.normal(size=k)
            want = np.asarray(w, np.float64) + np.where(
                spk[:, None], trace[None, :], 0.0)
            got = be.update_dense_on_binary_pre(
                w, jnp.asarray(spk), jnp.asarray(trace, dtype=wdtype))
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))


class TestDt2tDtypeSweep:
    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_csrmv_dt2t(self, rng, wdtype, transpose):
        with _maybe_x64(wdtype):
            m, k = 10, 12
            w, indices, indptr, dense = _csr_fixture(
                rng, m, k, wdtype, jnp.int32, homo=False)
            counts = np.diff(np.asarray(indptr))
            rows = np.repeat(np.arange(m), counts)
            cols = np.asarray(indices)
            y = rng.normal(size=k if transpose else m)
            # out[e] = w[e] * y[col(e)] (transpose) or y[row(e)]
            want = np.asarray(w, np.float64) * (
                y[cols] if transpose else y[rows])
            got = be.csrmv_dt2t(jnp.asarray(y, dtype=wdtype), w, indices,
                                indptr, shape=(m, k), transpose=transpose)
            np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                       want, **_tol(wdtype))


class TestJitcDtypeSweep:
    @pytest.mark.parametrize('wdtype', [jnp.float32, jnp.float64])
    @pytest.mark.parametrize('fam', ['jits', 'jitn', 'jitu'])
    def test_mv_dtype_follows_weights(self, rng, wdtype, fam):
        from brainevent_tpu import jitc
        with _maybe_x64(wdtype):
            v = jnp.asarray(rng.normal(size=30), dtype=wdtype)
            if fam == 'jits':
                out = jitc.jitsmv(jnp.asarray(1.5, wdtype), 0.2, v, 7,
                                  shape=(20, 30), corder=True)
                mat = jitc.jits(jnp.asarray(1.5, wdtype), 0.2, 7,
                                shape=(20, 30), corder=True)
            elif fam == 'jitn':
                out = jitc.jitnmv(jnp.asarray(0.5, wdtype),
                                  jnp.asarray(0.1, wdtype), 0.2, v, 7,
                                  shape=(20, 30), corder=True)
                mat = jitc.jitn(jnp.asarray(0.5, wdtype),
                                jnp.asarray(0.1, wdtype), 0.2, 7,
                                shape=(20, 30), corder=True)
            else:
                out = jitc.jitumv(jnp.asarray(0.2, wdtype),
                                  jnp.asarray(0.9, wdtype), 0.2, v, 7,
                                  shape=(20, 30), corder=True)
                mat = jitc.jitu(jnp.asarray(0.2, wdtype),
                                jnp.asarray(0.9, wdtype), 0.2, 7,
                                shape=(20, 30), corder=True)
            assert out.dtype == wdtype
            np.testing.assert_allclose(
                np.asarray(out, dtype=np.float64),
                np.asarray(mat, dtype=np.float64) @ np.asarray(
                    v, dtype=np.float64),
                rtol=1e-4 if wdtype == jnp.float32 else 1e-10,
                atol=1e-4 if wdtype == jnp.float32 else 1e-10)


class TestFloatEventGating:
    """Float events gate at ``> 0`` and do NOT scale the weights — the
    reference contract (``brainevent/_dense/binary.py:141-142``,
    ``_csr/binary.py:213``). Negative float entries are inactive."""

    def test_dense_negative_floats_inactive(self, rng):
        w = jnp.asarray(rng.normal(size=(6, 8)), dtype=jnp.float32)
        s = jnp.asarray([0.5, -1.0, 0.0, 2.0, -0.1, 0.0, 3.0, -4.0],
                        jnp.float32)
        want = np.asarray(w)[:, np.asarray(s) > 0].sum(axis=1)
        for backend in be.dense.binary.binary_densemv_p.available_backends('cpu'):
            got = be.binary_densemv(w, s, transpose=False, backend=backend)
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                       atol=1e-6, err_msg=backend)

    def test_csr_negative_floats_inactive(self, rng):
        w, indices, indptr, dense = _csr_fixture(
            rng, 10, 8, jnp.float32, jnp.int32, homo=False)
        s = jnp.asarray(rng.normal(size=8), jnp.float32)
        want = dense @ (np.asarray(s) > 0)
        for backend in be.csr.binary.binary_csrmv_p.available_backends('cpu'):
            got = be.binary_csrmv(w, indices, indptr, s, shape=(10, 8),
                                  transpose=False, backend=backend)
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                       atol=1e-6, err_msg=backend)

    def test_fcn_negative_floats_inactive(self, rng):
        n_pre, n_post, K = 10, 12, 4
        idx_np = rng.integers(0, n_post, (n_pre, K))
        w = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32)
        s = jnp.asarray(rng.normal(size=n_pre), jnp.float32)
        dense = np.zeros((n_pre, n_post))
        for i in range(n_pre):
            for j in range(K):
                dense[i, idx_np[i, j]] += float(w[i, j])
        want = dense.T @ (np.asarray(s) > 0)
        for backend in be.fcn.binary.binary_fcnmv_p.available_backends('cpu'):
            got = be.binary_fcnmv(w, jnp.asarray(idx_np, jnp.int32), s,
                                  shape=(n_pre, n_post), transpose=True,
                                  backend=backend)
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                       atol=1e-5, err_msg=backend)


class TestBf16Weights:
    """bfloat16 weight paths: outputs follow the weight dtype and match
    the f32 reference within bf16 tolerance (half-width weight storage)."""

    @pytest.mark.parametrize('transpose', [False, True])
    def test_binary_fcnmv_bf16(self, rng, transpose):
        from brainevent_tpu.fcn.binary import binary_fcnmv_p_call
        n_pre, n_post, K = 64, 80, 8
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), jnp.int32)
        w32 = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32)
        s = jnp.asarray(rng.random(n_pre if transpose else n_post) < 0.2)
        (ref,) = binary_fcnmv_p_call(w32, idx, s, shape=(n_pre, n_post),
                                     transpose=transpose)
        (out,) = binary_fcnmv_p_call(w32.astype(jnp.bfloat16), idx, s,
                                     shape=(n_pre, n_post),
                                     transpose=transpose)
        assert out.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref), rtol=2e-2, atol=2e-2)

    def test_csrmv_bf16(self, rng):
        from brainevent_tpu.csr.float import csrmv_p_call
        m, k, per = 32, 40, 4
        indices = jnp.asarray(rng.integers(0, k, m * per), jnp.int32)
        indptr = jnp.asarray(np.arange(m + 1) * per, jnp.int32)
        w = jnp.asarray(rng.normal(size=m * per), jnp.float32)
        v = jnp.asarray(rng.normal(size=k), jnp.float32)
        (ref,) = csrmv_p_call(w, indices, indptr, v, shape=(m, k))
        (out,) = csrmv_p_call(w.astype(jnp.bfloat16), indices, indptr,
                              v.astype(jnp.bfloat16), shape=(m, k))
        assert out.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref), rtol=5e-2, atol=5e-2)

    def test_jitsmv_bf16_params(self, rng):
        from brainevent_tpu import jitsmv
        v = jnp.asarray(rng.normal(size=40), jnp.float32)
        ref = jitsmv(1.5, 0.2, v, 11, shape=(32, 40))
        out = jitsmv(jnp.bfloat16(1.5), 0.2, v, 11, shape=(32, 40))
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref), rtol=2e-2, atol=2e-2)


class TestIndexDtypes:
    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.uint32])
    def test_fcn_index_dtypes(self, rng, idtype):
        from brainevent_tpu.fcn.float import fcnmv_p_call
        n_pre, n_post, K = 48, 64, 4
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), idtype)
        w = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32)
        v = jnp.asarray(rng.normal(size=n_post), jnp.float32)
        (out,) = fcnmv_p_call(w, idx, v, shape=(n_pre, n_post))
        dense = np.zeros((n_pre, n_post), np.float32)
        np.add.at(dense, (np.repeat(np.arange(n_pre), K),
                          np.asarray(idx, np.int64).reshape(-1)),
                  np.asarray(w).reshape(-1))
        np.testing.assert_allclose(np.asarray(out),
                                   dense @ np.asarray(v), rtol=1e-4,
                                   atol=1e-4)

    def test_event_bool_vs_float_spikes_agree(self, rng):
        from brainevent_tpu.fcn.binary import binary_fcnmv_p_call
        n, K = 40, 4
        idx = jnp.asarray(rng.integers(0, n, (n, K)), jnp.int32)
        w = jnp.asarray([0.5], jnp.float32)
        sb = jnp.asarray(rng.random(n) < 0.3)
        sf = sb.astype(jnp.float32)
        (a,) = binary_fcnmv_p_call(w, idx, sb, shape=(n, n),
                                   transpose=True)
        (b,) = binary_fcnmv_p_call(w, idx, sf, shape=(n, n),
                                   transpose=True)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
