# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Event kernels against a dense reference.

``binary_fcnmv`` (both directions) and ``binary_csrmv`` (gather direction)
run their registered kernel — the XLA formulation every platform uses —
and must agree with the densified matrix times the 0/1 event vector
across shapes, rates (including zero and saturating), weight layouts,
float-gated events, and the compaction overflow of the scatter direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brainevent_tpu.csr.binary import binary_csrmv_p_call
from brainevent_tpu.fcn.binary import binary_fcnmv_p_call


def _fcn_dense(w, idx, n_post):
    n_pre, K = idx.shape
    w = np.broadcast_to(np.asarray(w, np.float64).reshape(-1)
                        if np.size(w) == 1 else np.asarray(w, np.float64),
                        (n_pre, K))
    dense = np.zeros((n_pre, n_post))
    np.add.at(dense, (np.repeat(np.arange(n_pre), K),
                      np.asarray(idx).reshape(-1)), w.reshape(-1))
    return dense


def _gate(spk):
    spk = np.asarray(spk)
    return (spk > 0).astype(np.float64)


@pytest.mark.parametrize('n_pre,n_post,K', [(100, 200, 10), (1000, 1000, 80),
                                            (300, 130, 7)])
@pytest.mark.parametrize('rate', [0.0, 0.05, 1.0])
@pytest.mark.parametrize('transpose', [False, True])
@pytest.mark.parametrize('homo', [True, False])
def test_fcn_event_vs_dense(n_pre, n_post, K, rate, transpose, homo):
    rng = np.random.default_rng(hash((n_pre, K, transpose)) % 2**31)
    idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), jnp.int32)
    m = n_pre if transpose else n_post
    spk = jnp.asarray(rng.random(m) < rate)
    w = (jnp.asarray([0.5], jnp.float32) if homo
         else jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32))
    got = binary_fcnmv_p_call(w, idx, spk, shape=(n_pre, n_post),
                              transpose=transpose)[0]
    dense = _fcn_dense(w, idx, n_post)
    want = _gate(spk) @ dense if transpose else dense @ _gate(spk)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


def test_fcn_float_gated_events():
    rng = np.random.default_rng(3)
    idx = jnp.asarray(rng.integers(0, 500, (500, 20)), jnp.int32)
    spk = jnp.asarray(rng.random(500) * (rng.random(500) < 0.05))
    w = jnp.asarray([1.5], jnp.float32)
    dense = _fcn_dense(w, idx, 500)
    for transpose in (False, True):
        got = binary_fcnmv_p_call(w, idx, spk, shape=(500, 500),
                                  transpose=transpose)[0]
        want = _gate(spk) @ dense if transpose else dense @ _gate(spk)
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=1e-5, atol=1e-4)


def _csr_dense(w, idx, indptr, shape):
    indptr = np.asarray(indptr)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    w = np.asarray(w, np.float64)
    w = np.broadcast_to(w, rows.shape) if w.size == 1 else w
    dense = np.zeros(shape)
    np.add.at(dense, (rows, np.asarray(idx)), w)
    return dense


@pytest.mark.parametrize('n,m,avg_deg', [(50, 70, 5), (1000, 1000, 20),
                                         (257, 130, 3)])
@pytest.mark.parametrize('rate', [0.0, 0.05, 0.5])
@pytest.mark.parametrize('homo', [True, False])
def test_csr_gather_vs_dense(n, m, avg_deg, rate, homo):
    rng = np.random.default_rng(hash((n, m, avg_deg)) % 2**31)
    deg = rng.poisson(avg_deg, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    idx = jnp.asarray(rng.integers(0, m, nnz), jnp.int32)
    indptr = jnp.asarray(indptr)
    spk = jnp.asarray(rng.random(m) < rate)
    w = (jnp.asarray([0.7], jnp.float32) if homo
         else jnp.asarray(rng.normal(size=nnz), jnp.float32))
    got = binary_csrmv_p_call(w, idx, indptr, spk, shape=(n, m),
                              transpose=False)[0]
    want = _csr_dense(w, idx, indptr, (n, m)) @ _gate(spk)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


def test_csr_gather_empty_rows_and_jit():
    """Rows with zero nonzeros + jit wrapping + grad passthrough."""
    rng = np.random.default_rng(9)
    deg = rng.poisson(4, 64)
    deg[::5] = 0
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(deg)]), jnp.int32)
    nnz = int(indptr[-1])
    idx = jnp.asarray(rng.integers(0, 96, nnz), jnp.int32)
    spk = jnp.asarray(rng.random(96) < 0.2)
    w = jnp.asarray(rng.normal(size=nnz), jnp.float32)

    fn = jax.jit(lambda w: binary_csrmv_p_call(
        w, idx, indptr, spk, shape=(64, 96), transpose=False)[0])
    want = _csr_dense(w, idx, indptr, (64, 96)) @ _gate(spk)
    np.testing.assert_allclose(np.asarray(fn(w)), want, rtol=1e-5, atol=1e-4)

    g = jax.grad(lambda w: fn(w).sum())(w)
    # d/dw of sum(D @ s) is the event gate at each nonzero's column
    np.testing.assert_allclose(np.asarray(g), _gate(spk)[np.asarray(idx)],
                               rtol=1e-6)
