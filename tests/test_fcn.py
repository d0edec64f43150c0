# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""FCN (ELL) package tests against dense NumPy oracles
(mirrors reference ``brainevent/_fcn/*_test.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.fcn import (
    FixedNumPerPre, FixedNumPerPost,
    binary_fcnmv, binary_fcnmm, fcnmv, fcnmm, fcnmv_dt2t, fcnmm_dt2t,
    update_fixed_post_conn_on_binary_pre,
    update_fixed_pre_conn_on_binary_post,
)


def make_ell(rng, n_pre=30, n_post=40, n_conn=8, homo=False):
    indices = np.stack([
        rng.choice(n_post, size=n_conn, replace=False) for _ in range(n_pre)
    ]).astype(np.int32)
    if homo:
        data = np.array([0.5], np.float32)
        dense = np.zeros((n_pre, n_post), np.float32)
        for i in range(n_pre):
            np.add.at(dense[i], indices[i], 0.5)
    else:
        data = rng.normal(size=(n_pre, n_conn)).astype(np.float32)
        dense = np.zeros((n_pre, n_post), np.float32)
        for i in range(n_pre):
            np.add.at(dense[i], indices[i], data[i])
    return jnp.asarray(data), jnp.asarray(indices), dense


class TestBinaryFcnmv:
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [True, False])
    @pytest.mark.parametrize('bool_event', [True, False])
    def test_oracle(self, rng, transpose, homo, bool_event):
        data, indices, dense = make_ell(rng, homo=homo)
        n_pre, n_post = dense.shape
        spk = rng.random(n_pre if transpose else n_post) < 0.3
        v = spk if bool_event else spk.astype(np.float32) * 2.0
        out = binary_fcnmv(data, indices, jnp.asarray(v),
                           shape=(n_pre, n_post), transpose=transpose)
        gate = spk.astype(np.float32)
        want = dense.T @ gate if transpose else dense @ gate
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    def test_compact_scatter_overflow_fallback(self, rng):
        """All neurons firing (overflow of the compact capacity) stays exact."""
        n_pre, n_post, n_conn = 2000, 2000, 16
        data, indices, dense = make_ell(rng, n_pre, n_post, n_conn, homo=True)
        spk = np.ones(n_pre, bool)  # way beyond capacity n_pre//8
        out = binary_fcnmv(data, indices, jnp.asarray(spk),
                           shape=(n_pre, n_post), transpose=True)
        want = dense.T @ np.ones(n_pre, np.float32)
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-3, atol=1e-3)

    def test_scatter_sparse_events(self, rng):
        n_pre, n_post, n_conn = 2000, 2000, 16
        data, indices, dense = make_ell(rng, n_pre, n_post, n_conn)
        spk = rng.random(n_pre) < 0.005
        out = binary_fcnmv(data, indices, jnp.asarray(spk),
                           shape=(n_pre, n_post), transpose=True)
        want = dense.T @ spk.astype(np.float32)
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-3, atol=1e-4)

    def test_grad_weights(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        spk = jnp.asarray(rng.random(n_post) < 0.3)

        def loss(d):
            return binary_fcnmv(d, indices, spk,
                                shape=(n_pre, n_post)).sum()

        g = jax.grad(loss)(data)
        want = np.asarray(spk).astype(np.float32)[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4)

    def test_grad_spikes_surrogate(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        v = jnp.asarray((rng.random(n_post) < 0.3).astype(np.float32))

        def loss(v):
            return binary_fcnmv(data, indices, v,
                                shape=(n_pre, n_post)).sum()

        g = jax.grad(loss)(v)
        np.testing.assert_allclose(np.asarray(g), dense.sum(0), rtol=1e-3,
                                   atol=1e-4)

    def test_vmap_to_mm(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        S = rng.random((5, n_post)) < 0.3
        out = jax.vmap(lambda s: binary_fcnmv(
            data, indices, s, shape=(n_pre, n_post)))(jnp.asarray(S))
        want = S.astype(np.float32) @ dense.T
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-3, atol=1e-4)


class TestBinaryFcnmm:
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [True, False])
    def test_oracle(self, rng, transpose, homo):
        data, indices, dense = make_ell(rng, homo=homo)
        n_pre, n_post = dense.shape
        S = rng.random(((n_pre if transpose else n_post), 6)) < 0.25
        out = binary_fcnmm(data, indices, jnp.asarray(S),
                           shape=(n_pre, n_post), transpose=transpose)
        g = S.astype(np.float32)
        want = dense.T @ g if transpose else dense @ g
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)


class TestFloatOps:
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [True, False])
    def test_fcnmv(self, rng, transpose, homo):
        data, indices, dense = make_ell(rng, homo=homo)
        n_pre, n_post = dense.shape
        v = rng.normal(size=n_pre if transpose else n_post).astype(np.float32)
        out = fcnmv(data, indices, jnp.asarray(v), shape=(n_pre, n_post),
                    transpose=transpose)
        want = dense.T @ v if transpose else dense @ v
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    def test_fcnmm(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        B = rng.normal(size=(n_post, 5)).astype(np.float32)
        out = fcnmm(data, indices, jnp.asarray(B), shape=(n_pre, n_post))
        np.testing.assert_allclose(np.asarray(out), dense @ B, rtol=2e-4,
                                   atol=1e-4)

    def test_fcnmv_grad(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        v = jnp.asarray(rng.normal(size=n_post).astype(np.float32))

        def loss(d):
            return fcnmv(d, indices, v, shape=(n_pre, n_post)).sum()

        g = jax.grad(loss)(data)
        want = np.asarray(v)[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4)

    def test_dt2t(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        y = rng.normal(size=n_pre).astype(np.float32)
        out = fcnmv_dt2t(jnp.asarray(y), data, indices, shape=(n_pre, n_post))
        want = np.asarray(data) * y[:, None]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)
        yt = rng.normal(size=n_post).astype(np.float32)
        out_t = fcnmv_dt2t(jnp.asarray(yt), data, indices,
                           shape=(n_pre, n_post), transpose=True)
        want_t = np.asarray(data) * yt[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(out_t), want_t, rtol=1e-5)

    def test_dt2t_mm(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        Y = rng.normal(size=(n_pre, 3)).astype(np.float32)
        out = fcnmm_dt2t(jnp.asarray(Y), data, indices, shape=(n_pre, n_post))
        want = np.asarray(data)[:, :, None] * Y[:, None, :]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)


class TestPlasticity:
    def test_on_pre(self, rng):
        data, indices, dense = make_ell(rng)
        n_pre, n_post = dense.shape
        spk = rng.random(n_pre) < 0.4
        trace = rng.normal(size=n_post).astype(np.float32)
        out = update_fixed_post_conn_on_binary_pre(
            data, indices, jnp.asarray(spk), jnp.asarray(trace))
        want = np.asarray(data) + spk[:, None] * trace[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)

    def test_on_post(self, rng):
        # post-grouped storage: rows are post neurons, indices list pre ids
        data, indices, _ = make_ell(rng, n_pre=40, n_post=30)
        spk = rng.random(40) < 0.4       # post spikes (40 ELL rows)
        trace = rng.normal(size=30).astype(np.float32)
        out = update_fixed_pre_conn_on_binary_post(
            data, indices, jnp.asarray(trace), jnp.asarray(spk))
        want = np.asarray(data) + spk[:, None] * trace[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)


class TestClasses:
    def test_per_pre_roundtrip_and_matmul(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        np.testing.assert_allclose(np.asarray(A.todense()), dense, rtol=1e-6)
        v = rng.normal(size=dense.shape[1]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(v)), dense @ v,
                                   rtol=1e-4, atol=1e-4)
        s = rng.random(dense.shape[0]) < 0.2
        out = be.BinaryArray(jnp.asarray(s)) @ A
        np.testing.assert_allclose(np.asarray(out),
                                   s.astype(np.float32) @ dense,
                                   rtol=1e-3, atol=1e-4)

    def test_per_pre_fromdense(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre.fromdense(jnp.asarray(dense))
        np.testing.assert_allclose(np.asarray(A.todense()), dense, rtol=1e-6)

    def test_transpose_roundtrip(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        At = A.T
        assert isinstance(At, FixedNumPerPost)
        np.testing.assert_allclose(np.asarray(At.todense()), dense.T, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(At.T.todense()), dense, rtol=1e-6)

    def test_per_post_matmul(self, rng):
        data, indices, dense_t = make_ell(rng, n_pre=30, n_post=40)
        # post-grouped matrix: logical A = dense_t.T with shape (40, 30)
        A = FixedNumPerPost((data, indices), shape=(40, 30))
        np.testing.assert_allclose(np.asarray(A.todense()), dense_t.T,
                                   rtol=1e-6)
        v = rng.normal(size=30).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(v)),
                                   dense_t.T @ v, rtol=1e-3, atol=1e-4)
        s = rng.random(40) < 0.3
        out = be.BinaryArray(jnp.asarray(s)) @ A
        np.testing.assert_allclose(np.asarray(out),
                                   s.astype(np.float32) @ dense_t.T,
                                   rtol=1e-3, atol=1e-4)

    def test_tocsr(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        np.testing.assert_allclose(np.asarray(A.tocsr().todense()), dense,
                                   rtol=1e-6)

    def test_pytree_jit(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        v = jnp.asarray(rng.normal(size=dense.shape[1]).astype(np.float32))
        out = jax.jit(lambda a, v: a @ v)(A, v)
        np.testing.assert_allclose(np.asarray(out), dense @ np.asarray(v),
                                   rtol=1e-4, atol=1e-4)

    def test_update_on_pre_method(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        spk = rng.random(dense.shape[0]) < 0.5
        trace = rng.normal(size=dense.shape[1]).astype(np.float32)
        A2 = A.update_on_pre(jnp.asarray(spk), jnp.asarray(trace))
        want = np.asarray(data) + spk[:, None] * trace[np.asarray(indices)]
        np.testing.assert_allclose(np.asarray(A2.data), want, rtol=1e-5)

    def test_elementwise(self, rng):
        data, indices, dense = make_ell(rng)
        A = FixedNumPerPre((data, indices), shape=dense.shape)
        A2 = A * 2.0
        np.testing.assert_allclose(np.asarray(A2.data), np.asarray(data) * 2,
                                   rtol=1e-6)


class TestFcnClassProducts:
    """The class ``@`` float products, both ELL orientations and both
    directions, against the densified matrix — eager, jitted over traced
    structure or data, and under ``jax.grad``."""

    def _pair(self, rng, n_pre=100, n_post=130, K=8):
        from brainevent_tpu.fcn.main import FixedNumPerPre, FixedNumPerPost
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), jnp.int32)
        data = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32)
        pre = FixedNumPerPre((data, idx), shape=(n_pre, n_post))
        idx2 = jnp.asarray(rng.integers(0, n_pre, (n_post, K)), jnp.int32)
        d2 = jnp.asarray(rng.normal(size=(n_post, K)), jnp.float32)
        post = FixedNumPerPost((d2, idx2), shape=(n_pre, n_post))
        return pre, post

    def _check_both_directions(self, m, rng):
        dense = np.asarray(m.todense(), np.float64)
        v = rng.normal(size=m.shape[1]).astype(np.float32)
        u = rng.normal(size=m.shape[0]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(m @ jnp.asarray(v)), dense @ v,
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(np.asarray(jnp.asarray(u) @ m), u @ dense,
                                   rtol=2e-4, atol=2e-4)

    def test_perpre_both_directions(self, rng):
        pre, _ = self._pair(rng)
        self._check_both_directions(pre, rng)

    def test_perpost_both_directions(self, rng):
        _, post = self._pair(rng)
        self._check_both_directions(post, rng)

    def test_homogeneous_data(self, rng):
        from brainevent_tpu.fcn.main import FixedNumPerPre
        idx = jnp.asarray(rng.integers(0, 96, (64, 4)), jnp.int32)
        m = FixedNumPerPre((jnp.asarray([0.5], jnp.float32), idx),
                           shape=(64, 96))
        self._check_both_directions(m, rng)

    def test_traced_structure_under_jit(self, rng):
        from brainevent_tpu.fcn.main import FixedNumPerPre
        d = jnp.asarray(rng.normal(size=(16, 2)), jnp.float32)
        idx = jnp.asarray(rng.integers(0, 32, (16, 2)), jnp.int32)
        v = jnp.asarray(rng.normal(size=32), jnp.float32)
        expect = np.asarray(FixedNumPerPre((d, idx), shape=(16, 32))
                            .todense()) @ np.asarray(v)
        got = jax.jit(lambda i: FixedNumPerPre((d, i), shape=(16, 32)) @ v)(
            idx)
        np.testing.assert_allclose(np.asarray(got), expect, rtol=2e-4,
                                   atol=2e-4)

    def test_traced_data_under_jit(self, rng):
        from brainevent_tpu.fcn.main import FixedNumPerPre
        idx = jnp.asarray(rng.integers(0, 32, (16, 2)), jnp.int32)
        m0 = FixedNumPerPre(
            (jnp.asarray(rng.normal(size=(16, 2)), jnp.float32), idx),
            shape=(16, 32))
        v = jnp.asarray(rng.normal(size=32), jnp.float32)
        expect = np.asarray(m0.todense()) @ np.asarray(v)
        got = jax.jit(lambda d: FixedNumPerPre((d, idx), shape=(16, 32))
                      @ v)(m0.data)
        np.testing.assert_allclose(np.asarray(got), expect,
                                   rtol=2e-4, atol=2e-4)

    def test_grad_wrt_vector_matches_dense(self, rng):
        from brainevent_tpu.fcn.main import FixedNumPerPre
        idx = jnp.asarray(rng.integers(0, 96, (64, 4)), jnp.int32)
        d = jnp.asarray(rng.normal(size=(64, 4)), jnp.float32)
        m = FixedNumPerPre((d, idx), shape=(64, 96))
        v = jnp.asarray(rng.normal(size=96), jnp.float32)
        u = rng.normal(size=64).astype(np.float32)
        g = jax.grad(lambda x: jnp.vdot(m @ x, jnp.asarray(u)))(v)
        np.testing.assert_allclose(np.asarray(g),
                                   u @ np.asarray(m.todense()),
                                   rtol=2e-4, atol=2e-4)
