# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""CSR package tests: eager and jitted dispatch against a dense NumPy
oracle, plus grad/vmap/jit sweeps (mirrors reference
``brainevent/_csr/*_test.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.csr import (
    CSR, CSC,
    binary_csrmv, binary_csrmm, binary_csrmv_indexed,
    csrmv, csrmm, csrmv_dt2t, csrmm_dt2t,
    update_csr_on_binary_pre, update_csr_on_binary_post,
    update_csc_on_binary_pre, update_csc_on_binary_post,
    csr_slice_rows, csr_diag_position, csr_diag_add, csr_solve,
)

# eager dispatch (the primitive's impl) and lowering inside jax.jit
MODES = ['eager', 'jit']


def run(mode, fn, *args, **kwargs):
    if mode == 'jit':
        return jax.jit(lambda *a: fn(*a, **kwargs))(*args)
    return fn(*args, **kwargs)


def make_csr(rng, m=40, k=50, conn=0.2, homo=False):
    dense = (rng.random((m, k)) < conn) * rng.normal(size=(m, k))
    dense = dense.astype(np.float32)
    rows, cols = np.nonzero(dense)
    counts = np.bincount(rows, minlength=m)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = cols.astype(np.int32)
    if homo:
        data = np.ones(1, np.float32) * 0.5
        dense = (dense != 0).astype(np.float32) * 0.5
    else:
        data = dense[rows, cols]
    return (jnp.asarray(data), jnp.asarray(indices), jnp.asarray(indptr),
            dense, (m, k))


class TestFloatOps:
    @pytest.mark.parametrize('mode', MODES)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [False, True])
    def test_csrmv(self, rng, mode, transpose, homo):
        data, indices, indptr, dense, shape = make_csr(rng, homo=homo)
        v = rng.normal(size=shape[0] if transpose else shape[1]).astype(np.float32)
        out = run(mode, csrmv, data, indices, indptr, jnp.asarray(v),
                  shape=shape, transpose=transpose)
        want = dense.T @ v if transpose else dense @ v
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [False, True])
    def test_csrmm(self, rng, transpose, homo):
        data, indices, indptr, dense, shape = make_csr(rng, homo=homo)
        B = rng.normal(size=((shape[0] if transpose else shape[1]), 7)
                       ).astype(np.float32)
        out = csrmm(data, indices, indptr, jnp.asarray(B), shape=shape,
                    transpose=transpose)
        want = dense.T @ B if transpose else dense @ B
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    def test_csrmv_grad_data(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        v = jnp.asarray(rng.normal(size=shape[1]).astype(np.float32))

        def loss(d):
            return csrmv(d, indices, indptr, v, shape=shape).sum()

        g = jax.grad(loss)(data)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        np.testing.assert_allclose(np.asarray(g), np.asarray(v)[np.asarray(cols)],
                                   rtol=1e-4)

    def test_csrmv_grad_vector(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        v = jnp.asarray(rng.normal(size=shape[1]).astype(np.float32))

        def loss(v):
            return csrmv(data, indices, indptr, v, shape=shape).sum()

        g = jax.grad(loss)(v)
        np.testing.assert_allclose(np.asarray(g), dense.sum(0), rtol=1e-3,
                                   atol=1e-4)

    def test_csrmv_vmap_to_mm(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        V = rng.normal(size=(5, shape[1])).astype(np.float32)
        out = jax.vmap(lambda v: csrmv(data, indices, indptr, v, shape=shape))(
            jnp.asarray(V))
        np.testing.assert_allclose(np.asarray(out), V @ dense.T, rtol=1e-3,
                                   atol=1e-4)


class TestBinaryOps:
    @pytest.mark.parametrize('mode', MODES)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('homo', [False, True])
    @pytest.mark.parametrize('bool_event', [True, False])
    def test_binary_csrmv(self, rng, mode, transpose, homo, bool_event):
        data, indices, indptr, dense, shape = make_csr(rng, homo=homo)
        spk = rng.random(shape[0] if transpose else shape[1]) < 0.2
        v = spk if bool_event else spk.astype(np.float32) * 1.5
        out = run(mode, binary_csrmv, data, indices, indptr, jnp.asarray(v),
                  shape=shape, transpose=transpose)
        gate = spk.astype(np.float32)  # events gate (not multiply) in csr ops
        want = dense.T @ gate if transpose else dense @ gate
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    @pytest.mark.parametrize('transpose', [False, True])
    def test_binary_csrmm(self, rng, transpose):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = rng.random(((shape[0] if transpose else shape[1]), 6)) < 0.2
        out = binary_csrmm(data, indices, indptr, jnp.asarray(spk), shape=shape,
                           transpose=transpose)
        gate = spk.astype(np.float32)
        want = dense.T @ gate if transpose else dense @ gate
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    def test_binary_grad_weights(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = jnp.asarray(rng.random(shape[1]) < 0.3)

        def loss(d):
            return binary_csrmv(d, indices, indptr, spk, shape=shape).sum()

        g = jax.grad(loss)(data)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        want = np.asarray(spk).astype(np.float32)[np.asarray(cols)]
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4)

    def test_binary_grad_vector_surrogate(self, rng):
        """Gradient w.r.t. events uses the float csrmv (surrogate-linear)."""
        data, indices, indptr, dense, shape = make_csr(rng)
        v = jnp.asarray((rng.random(shape[1]) < 0.3).astype(np.float32))

        def loss(v):
            return binary_csrmv(data, indices, indptr, v, shape=shape).sum()

        g = jax.grad(loss)(v)
        np.testing.assert_allclose(np.asarray(g), dense.sum(0), rtol=1e-3,
                                   atol=1e-4)

    def test_indexed_route_matches_csc_mirror(self, rng):
        """binary_csrmv_indexed over the CSC mirror == transpose product."""
        data, indices, indptr, dense, shape = make_csr(rng)
        m, k = shape
        csc_indptr, csc_rows, perm = be.csr_to_csc_index(
            indptr, indices, shape=shape)
        spk = rng.random(m) < 0.2
        # unfavorable direction A.T @ spk computed as gather over CSC mirror
        out = binary_csrmv_indexed(
            data, csc_rows, csc_indptr, perm, jnp.asarray(spk),
            shape=(k, m), transpose=False)
        want = dense.T @ spk.astype(np.float32)
        np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=1e-4)

    def test_workspace_kwarg_accepted(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = jnp.asarray(rng.random(shape[1]) < 0.2)
        out = binary_csrmv(data, indices, indptr, spk, shape=shape,
                           workspace=object())
        np.testing.assert_allclose(
            np.asarray(out), dense @ np.asarray(spk).astype(np.float32),
            rtol=2e-4, atol=1e-4)


class TestDt2t:
    @pytest.mark.parametrize('transpose', [False, True])
    def test_csrmv_dt2t(self, rng, transpose):
        data, indices, indptr, dense, shape = make_csr(rng)
        y = rng.normal(size=shape[1] if transpose else shape[0]).astype(np.float32)
        out = csrmv_dt2t(jnp.asarray(y), data, indices, indptr, shape=shape,
                         transpose=transpose)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        src = y[np.asarray(cols)] if transpose else y[np.asarray(rows)]
        np.testing.assert_allclose(np.asarray(out), np.asarray(data) * src,
                                   rtol=1e-5)

    def test_csrmm_dt2t(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        Y = rng.normal(size=(shape[0], 4)).astype(np.float32)
        out = csrmm_dt2t(jnp.asarray(Y), data, indices, indptr, shape=shape)
        rows, _ = be.csr_to_coo_index(indptr, indices)
        want = np.asarray(data)[:, None] * Y[np.asarray(rows)]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)

    def test_dt2t_grad_y(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        y = jnp.asarray(rng.normal(size=shape[0]).astype(np.float32))

        def loss(y):
            return csrmv_dt2t(y, data, indices, indptr, shape=shape).sum()

        g = jax.grad(loss)(y)
        rows, _ = be.csr_to_coo_index(indptr, indices)
        want = np.zeros(shape[0], np.float32)
        np.add.at(want, np.asarray(rows), np.asarray(data))
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4, atol=1e-5)


class TestPlasticity:
    @pytest.mark.parametrize('mode', MODES)
    def test_on_pre(self, rng, mode):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = rng.random(shape[0]) < 0.3
        trace = rng.normal(size=shape[1]).astype(np.float32)
        out = run(mode, update_csr_on_binary_pre,
                  data, indices, indptr, jnp.asarray(spk), jnp.asarray(trace),
                  shape=shape)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        want = np.asarray(data) + spk[np.asarray(rows)] * trace[np.asarray(cols)]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)

    def test_on_post(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = rng.random(shape[1]) < 0.3
        trace = rng.normal(size=shape[0]).astype(np.float32)
        out = update_csr_on_binary_post(
            data, indices, indptr, None, jnp.asarray(trace), jnp.asarray(spk),
            shape=shape)
        rows, cols = be.csr_to_coo_index(indptr, indices)
        want = np.asarray(data) + trace[np.asarray(rows)] * spk[np.asarray(cols)]
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)

    def test_clip(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        spk = np.ones(shape[0], bool)
        trace = np.full(shape[1], 100.0, np.float32)
        out = update_csr_on_binary_pre(
            data, indices, indptr, jnp.asarray(spk), jnp.asarray(trace),
            w_min=-1.0, w_max=1.0, shape=shape)
        assert np.asarray(out).max() <= 1.0


class TestSliceDiagSolve:
    def test_slice_rows(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        sel = jnp.asarray([3, 0, 7], dtype=jnp.int32)
        out = csr_slice_rows(data, indices, indptr, sel, shape=shape)
        np.testing.assert_allclose(np.asarray(out), dense[[3, 0, 7]], rtol=1e-5)

    def test_slice_grad(self, rng):
        data, indices, indptr, dense, shape = make_csr(rng)
        sel = jnp.asarray([1, 2], dtype=jnp.int32)

        def loss(d):
            return csr_slice_rows(d, indices, indptr, sel, shape=shape).sum()

        g = jax.grad(loss)(data)
        rows, _ = be.csr_to_coo_index(indptr, indices)
        want = np.isin(np.asarray(rows), [1, 2]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(g), want)

    def test_diag(self, rng):
        dense = np.diag(np.arange(1, 5, dtype=np.float32))
        dense[0, 3] = 2.0
        A = CSR.fromdense(jnp.asarray(dense))
        pos = csr_diag_position(A.indptr, A.indices, shape=A.shape)
        assert (np.asarray(pos) >= 0).all()
        new = csr_diag_add(A.data, pos, 1.0)
        A2 = A.with_data(new)
        np.testing.assert_allclose(np.asarray(A2.todense()),
                                   dense + np.eye(4, dtype=np.float32))

    def test_solve(self):
        dense = np.array([[4., 1., 0.], [1., 3., 0.], [0., 0., 2.]],
                         dtype=np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        b = jnp.asarray([1., 2., 3.], dtype=jnp.float32)
        x = csr_solve(A.data, A.indices, A.indptr, b)
        np.testing.assert_allclose(dense @ np.asarray(x), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)

    def test_solve_iterative_matches_direct(self, rng):
        n = 50
        dense = (rng.random((n, n)) < 0.1).astype(np.float32) \
            * rng.normal(size=(n, n)).astype(np.float32)
        dense += np.eye(n, dtype=np.float32) * (np.abs(dense).sum(1) + 1.0)
        A = CSR.fromdense(jnp.asarray(dense))
        b = jnp.asarray(rng.normal(size=n).astype(np.float32))
        xd = csr_solve(A.data, A.indices, A.indptr, b, method='direct')
        xi = csr_solve(A.data, A.indices, A.indptr, b, method='iterative',
                       tol=1e-8)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xd),
                                   rtol=1e-3, atol=1e-4)

    def test_solve_direct_size_guard(self):
        n = 5000
        idx = jnp.arange(n, dtype=jnp.int32)
        ptr = jnp.arange(n + 1, dtype=jnp.int32)
        d = jnp.ones(n, dtype=jnp.float32)
        b = jnp.ones(n, dtype=jnp.float32)
        with pytest.raises(ValueError, match='iterative'):
            csr_solve(d, idx, ptr, b, method='direct')
        # auto dispatches to iterative above the limit: identity solve
        x = csr_solve(d, idx, ptr, b)
        np.testing.assert_allclose(np.asarray(x), np.ones(n), rtol=1e-5)


class TestCSRClass:
    def test_fromdense_todense_roundtrip(self, rng):
        dense = ((rng.random((10, 12)) < 0.3) * rng.normal(size=(10, 12))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        np.testing.assert_allclose(np.asarray(A.todense()), dense, rtol=1e-6)

    def test_matmul_paths(self, rng):
        dense = ((rng.random((10, 12)) < 0.3) * rng.normal(size=(10, 12))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        v = rng.normal(size=12).astype(np.float32)
        u = rng.normal(size=10).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(v)), dense @ v,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jnp.asarray(u) @ A), u @ dense,
                                   rtol=1e-4, atol=1e-5)
        B = rng.normal(size=(12, 5)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(B)), dense @ B,
                                   rtol=1e-4, atol=1e-4)
        C = rng.normal(size=(5, 10)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(jnp.asarray(C) @ A), C @ dense,
                                   rtol=1e-4, atol=1e-4)

    def test_event_matmul(self, rng):
        dense = ((rng.random((10, 12)) < 0.3) * rng.normal(size=(10, 12))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        spk = rng.random(10) < 0.4
        out = be.BinaryArray(jnp.asarray(spk)) @ A
        np.testing.assert_allclose(np.asarray(out),
                                   spk.astype(np.float32) @ dense,
                                   rtol=1e-4, atol=1e-5)

    def test_transpose_and_csc(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        At = A.T
        assert isinstance(At, CSC) and At.shape == (8, 6)
        np.testing.assert_allclose(np.asarray(At.todense()), dense.T, rtol=1e-6)
        C = A.tocsc()
        assert isinstance(C, CSC) and C.shape == (6, 8)
        np.testing.assert_allclose(np.asarray(C.todense()), dense, rtol=1e-6)
        back = C.tocsr()
        np.testing.assert_allclose(np.asarray(back.todense()), dense, rtol=1e-6)

    def test_csc_matmul(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        C = CSC.fromdense(jnp.asarray(dense))
        v = rng.normal(size=8).astype(np.float32)
        np.testing.assert_allclose(np.asarray(C @ jnp.asarray(v)), dense @ v,
                                   rtol=1e-4, atol=1e-5)
        u = rng.normal(size=6).astype(np.float32)
        np.testing.assert_allclose(np.asarray(jnp.asarray(u) @ C), u @ dense,
                                   rtol=1e-4, atol=1e-5)

    def test_elementwise(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        A2 = (A * 2.0) + 1.0
        rows, cols = np.nonzero(dense)
        want = dense * 2
        want[rows, cols] += 1
        np.testing.assert_allclose(np.asarray(A2.todense()), want, rtol=1e-5)

    def test_update_on_pre_method(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        spk = rng.random(6) < 0.5
        trace = rng.normal(size=8).astype(np.float32)
        A2 = A.update_on_pre(jnp.asarray(spk), jnp.asarray(trace))
        assert isinstance(A2, CSR)

    def test_pytree_jit(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        v = jnp.asarray(rng.normal(size=8).astype(np.float32))
        out = jax.jit(lambda mat, v: mat @ v)(A, v)
        np.testing.assert_allclose(np.asarray(out), dense @ np.asarray(v),
                                   rtol=1e-4, atol=1e-5)

    def test_getitem_slice(self, rng):
        dense = ((rng.random((6, 8)) < 0.4) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        A = CSR.fromdense(jnp.asarray(dense))
        np.testing.assert_allclose(np.asarray(A[jnp.asarray([2, 4])]),
                                   dense[[2, 4]], rtol=1e-5)

    def test_csc_plasticity(self, rng):
        dense = ((rng.random((6, 8)) < 0.5) * rng.normal(size=(6, 8))
                 ).astype(np.float32)
        C = CSC.fromdense(jnp.asarray(dense))
        spk = rng.random(6) < 0.5
        trace = rng.normal(size=8).astype(np.float32)
        C2 = C.update_on_pre(jnp.asarray(spk), jnp.asarray(trace))
        # compare against dense rule: W[i,:] += trace for spiking i, on stored slots
        want_delta = np.outer(spk.astype(np.float32), trace) * (dense != 0)
        np.testing.assert_allclose(np.asarray(C2.todense()),
                                   dense + want_delta, rtol=1e-5)


class TestClassFloatProducts:
    """The CSR/CSC class ``@`` float products against the dense oracle:
    both directions, jitted over traced data, across a pytree round trip,
    after ``with_data``, and under ``jax.grad``."""

    def _mk(self, rng, m=300, k=400, conn=0.05):
        nse = int(m * k * conn)
        indices = np.sort(rng.integers(0, k, (m, nse // m)), axis=1)
        counts = np.full(m, nse // m)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        data = rng.normal(size=indptr[-1]).astype(np.float32)
        A = be.CSR((jnp.asarray(data), jnp.asarray(indices.reshape(-1),
                                                   dtype=jnp.int32),
                    jnp.asarray(indptr, dtype=jnp.int32)), shape=(m, k))
        return A

    def test_matvec_both_directions(self, rng):
        A = self._mk(rng)
        dense = np.asarray(A.todense(), np.float64)
        v = rng.normal(size=A.shape[1]).astype(np.float32)
        u = rng.normal(size=A.shape[0]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(v)), dense @ v,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(jnp.asarray(u) @ A), u @ dense,
                                   rtol=1e-4, atol=1e-4)

    def test_csc_route(self, rng):
        A = self._mk(rng)
        C = A.tocsc()
        v = rng.normal(size=A.shape[1]).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(C @ jnp.asarray(v)),
            np.asarray(A.todense(), np.float64) @ v, rtol=1e-4, atol=1e-4)

    def test_tree_roundtrip_products(self, rng):
        A = self._mk(rng)
        leaves, td = jax.tree_util.tree_flatten(A)
        A2 = jax.tree_util.tree_unflatten(td, leaves)
        v = jnp.asarray(rng.normal(size=A.shape[1]).astype(np.float32))
        np.testing.assert_allclose(np.asarray(A2 @ v), np.asarray(A @ v),
                                   rtol=1e-6, atol=1e-6)

    def test_matmat_both_directions(self, rng):
        A = self._mk(rng)
        dense = np.asarray(A.todense(), np.float64)
        B = rng.normal(size=(A.shape[1], 5)).astype(np.float32)
        Bt = rng.normal(size=(3, A.shape[0])).astype(np.float32)
        np.testing.assert_allclose(np.asarray(A @ jnp.asarray(B)), dense @ B,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(jnp.asarray(Bt) @ A),
                                   Bt @ dense, rtol=1e-4, atol=1e-4)

    def test_traced_data_under_jit(self, rng):
        A = self._mk(rng)
        v = jnp.asarray(rng.normal(size=A.shape[1]).astype(np.float32))
        expect = np.asarray(A.todense(), np.float64) @ np.asarray(v)

        def f(d):
            return be.CSR((d, A.indices, A.indptr), shape=A.shape) @ v

        np.testing.assert_allclose(np.asarray(jax.jit(f)(A.data)), expect,
                                   rtol=1e-4, atol=1e-4)

    def test_with_data_scales_product(self, rng):
        A = self._mk(rng)
        v = jnp.asarray(rng.normal(size=A.shape[1]).astype(np.float32))
        B = A.with_data(A.data * 2.0)
        np.testing.assert_allclose(np.asarray(B @ v), 2 * np.asarray(A @ v),
                                   rtol=1e-4, atol=1e-4)

    def test_grad_wrt_vector_matches_dense(self, rng):
        A = self._mk(rng)
        dense = np.asarray(A.todense(), np.float64)
        v = jnp.asarray(rng.normal(size=A.shape[1]).astype(np.float32))
        u = jnp.asarray(rng.normal(size=A.shape[0]).astype(np.float32))
        g = jax.grad(lambda x: jnp.vdot(A @ x, u))(v)
        np.testing.assert_allclose(np.asarray(g), np.asarray(u) @ dense,
                                   rtol=1e-4, atol=1e-4)
        g_t = jax.grad(lambda x: jnp.vdot(x @ A, v))(u)
        np.testing.assert_allclose(np.asarray(g_t), dense @ np.asarray(v),
                                   rtol=1e-4, atol=1e-4)

    def test_grad_wrt_data_matches_dense(self, rng):
        A = self._mk(rng, m=60, k=80, conn=0.1)
        v = jnp.asarray(rng.normal(size=A.shape[1]).astype(np.float32))
        u = rng.normal(size=A.shape[0]).astype(np.float32)

        def loss(d):
            return jnp.vdot(be.CSR((d, A.indices, A.indptr),
                                   shape=A.shape) @ v, jnp.asarray(u))

        rows, cols = be.csr_to_coo_index(A.indptr, A.indices)
        want = u[np.asarray(rows)] * np.asarray(v)[np.asarray(cols)]
        np.testing.assert_allclose(np.asarray(jax.grad(loss)(A.data)), want,
                                   rtol=1e-4, atol=1e-5)
