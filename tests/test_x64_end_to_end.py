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

"""x64 / int64-indptr END-TO-END sweeps through the class layer
(VERDICT r3 item 7: the dtype sweeps covered the primitives; these drive
the ``@`` operator, plasticity methods, conversions, and grads under
``jax_enable_x64`` with int64 structure — the reference's x64 discipline,
``brainevent/_misc.py:196-270``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', True)
    try:
        yield
    finally:
        jax.config.update('jax_enable_x64', old)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _mk_csr(rng, wdtype, idtype, m=20, k=28):
    mask = rng.random((m, k)) < 0.25
    rows, cols = np.nonzero(mask)
    counts = np.bincount(rows, minlength=m)
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]), idtype)
    indices = jnp.asarray(cols, idtype)
    vals = rng.normal(size=rows.shape[0])
    w = jnp.asarray(vals, wdtype)
    dense = np.zeros((m, k), np.float64)
    dense[rows, cols] = np.asarray(w, np.float64)
    A = be.CSR((w, indices, indptr), shape=(m, k))
    return A, dense


class TestCSRX64EndToEnd:
    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.int64])
    def test_matmul_f64(self, x64, rng, idtype):
        A, dense = _mk_csr(rng, jnp.float64, idtype)
        v = jnp.asarray(rng.normal(size=A.shape[1]), jnp.float64)
        u = jnp.asarray(rng.normal(size=A.shape[0]), jnp.float64)
        np.testing.assert_allclose(np.asarray(A @ v), dense @ np.asarray(v),
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(u @ A),
                                   np.asarray(u) @ dense, rtol=1e-10)
        assert (A @ v).dtype == jnp.float64

    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.int64])
    def test_event_matmul(self, x64, rng, idtype):
        A, dense = _mk_csr(rng, jnp.float64, idtype)
        spk = be.BinaryArray(jnp.asarray(rng.random(A.shape[1]) < 0.3))
        out = A @ spk
        np.testing.assert_allclose(
            np.asarray(out),
            dense @ np.asarray(spk.value, np.float64), rtol=1e-10)

    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.int64])
    def test_plasticity_methods(self, x64, rng, idtype):
        A, dense = _mk_csr(rng, jnp.float64, idtype)
        m, k = A.shape
        spk = jnp.asarray(rng.random(m) < 0.3)
        tr = jnp.asarray(rng.normal(size=k), jnp.float64)
        B = A.update_on_pre(spk, tr)
        rows = np.repeat(np.arange(m), np.diff(np.asarray(A.indptr)))
        expect = (np.asarray(A.data, np.float64)
                  + np.asarray(spk, np.float64)[rows]
                  * np.asarray(tr)[np.asarray(A.indices, np.int64)])
        np.testing.assert_allclose(np.asarray(B.data), expect, rtol=1e-12)
        assert B.data.dtype == jnp.float64

    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.int64])
    def test_grad_through_product(self, x64, rng, idtype):
        A, dense = _mk_csr(rng, jnp.float64, idtype)
        v = jnp.asarray(rng.normal(size=A.shape[1]), jnp.float64)
        u = jnp.asarray(rng.normal(size=A.shape[0]), jnp.float64)

        def loss(d):
            return jnp.vdot(A.with_data(d) @ v, u)

        g = jax.grad(loss)(A.data)
        rows = np.repeat(np.arange(A.shape[0]),
                         np.diff(np.asarray(A.indptr)))
        expect = (np.asarray(u)[rows]
                  * np.asarray(v)[np.asarray(A.indices, np.int64)])
        np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-10)

    def test_conversions_roundtrip_int64(self, x64, rng):
        A, dense = _mk_csr(rng, jnp.float64, jnp.int64)
        np.testing.assert_allclose(np.asarray(A.tocsc().todense()), dense,
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(A.todense()), dense,
                                   rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(A.transpose().todense()), dense.T, rtol=1e-12)

    def test_dt2t_f64(self, x64, rng):
        A, dense = _mk_csr(rng, jnp.float64, jnp.int64)
        y = jnp.asarray(rng.normal(size=A.shape[0]), jnp.float64)
        out = A.dt2t(y)
        rows = np.repeat(np.arange(A.shape[0]),
                         np.diff(np.asarray(A.indptr)))
        np.testing.assert_allclose(
            np.asarray(out),
            np.asarray(A.data, np.float64) * np.asarray(y)[rows],
            rtol=1e-12)


class TestFCNX64EndToEnd:
    @pytest.mark.parametrize('idtype', [jnp.int32, jnp.int64])
    def test_matmul_f64(self, x64, rng, idtype):
        n_pre, n_post, K = 20, 24, 4
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), idtype)
        w = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float64)
        m = be.FixedNumPerPre((w, idx), shape=(n_pre, n_post))
        v = jnp.asarray(rng.normal(size=n_post), jnp.float64)
        dense = np.zeros((n_pre, n_post), np.float64)
        np.add.at(dense, (np.repeat(np.arange(n_pre), K),
                          np.asarray(idx, np.int64).reshape(-1)),
                  np.asarray(w).reshape(-1))
        np.testing.assert_allclose(np.asarray(m @ v), dense @ np.asarray(v),
                                   rtol=1e-10)
        assert (m @ v).dtype == jnp.float64

    def test_event_matmul_int64(self, x64, rng):
        n_pre, n_post, K = 20, 24, 4
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), jnp.int64)
        w = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float64)
        m = be.FixedNumPerPre((w, idx), shape=(n_pre, n_post))
        spk = be.BinaryArray(jnp.asarray(rng.random(n_post) < 0.3))
        dense = np.zeros((n_pre, n_post), np.float64)
        np.add.at(dense, (np.repeat(np.arange(n_pre), K),
                          np.asarray(idx, np.int64).reshape(-1)),
                  np.asarray(w).reshape(-1))
        np.testing.assert_allclose(
            np.asarray(m @ spk),
            dense @ np.asarray(spk.value, np.float64), rtol=1e-10)


class TestJITCX64:
    @pytest.mark.parametrize('fam', ['s', 'n', 'u'])
    def test_mv_f64_vector(self, x64, rng, fam):
        # f64 OPERAND with f32 params: output follows the promotion rule
        # and the walk runs in the operand dtype
        mv = getattr(be, f'jit{fam}mv')
        params = {'s': (1.5,), 'n': (0.5, 1.5), 'u': (0.2, 1.7)}[fam]
        v64 = jnp.asarray(rng.normal(size=30), jnp.float64)
        v32 = v64.astype(jnp.float32)
        out64 = mv(*params, 0.3, v64, 42, shape=(20, 30))
        out32 = mv(*params, 0.3, v32, 42, shape=(20, 30))
        np.testing.assert_allclose(np.asarray(out64, np.float64),
                                   np.asarray(out32, np.float64),
                                   rtol=1e-5, atol=1e-5)


class TestDenseX64:
    def test_binary_densemv_f64(self, x64, rng):
        w = jnp.asarray(rng.normal(size=(20, 24)), jnp.float64)
        spk = jnp.asarray(rng.random(24) < 0.3)
        out = be.binary_densemv(w, spk, transpose=False)
        np.testing.assert_allclose(
            np.asarray(out),
            np.asarray(w) @ np.asarray(spk, np.float64), rtol=1e-12)
        assert out.dtype == jnp.float64
