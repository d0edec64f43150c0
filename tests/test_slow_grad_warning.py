# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Weight-gradient slow-path warning.

jax.grad w.r.t. heterogeneous CSR weights gathers both endpoints of every
nonzero per call. The transpose rule warns ONCE at trace time above 500k
nse, pointing at the ELL layout with its shared-gather backward
(models/training.ell_recurrent). Homogeneous weights stay silent.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import brainevent_tpu as be


def _structure(rng, m, per_row):
    counts = np.full(m, per_row)
    nse = int(counts.sum())
    indices = jnp.asarray(rng.integers(0, m, nse), jnp.int32)
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                         jnp.int32)
    return indices, indptr, nse


def test_small_nse_is_silent():
    rng = np.random.default_rng(0)
    indices, indptr, nse = _structure(rng, 200, 10)
    w = jnp.ones(nse, jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        jax.eval_shape(jax.grad(lambda ww: be.csrmv(
            ww, indices, indptr, jnp.ones(200), shape=(200, 200)).sum()), w)


def test_large_nse_warns_at_trace_time():
    rng = np.random.default_rng(0)
    indices, indptr, nse = _structure(rng, 3000, 200)   # 600k nse
    w = jnp.ones(nse, jnp.float32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        jax.eval_shape(jax.grad(lambda ww: be.csrmv(
            ww, indices, indptr, jnp.ones(3000), shape=(3000, 3000)).sum()),
            w)
    assert any('ell_recurrent' in str(x.message) for x in rec)


def test_homogeneous_weight_is_silent():
    # homogeneous (scalar) weights reduce to one sum — no slow gather
    rng = np.random.default_rng(0)
    indices, indptr, nse = _structure(rng, 3000, 200)
    w = jnp.ones(1, jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        jax.eval_shape(jax.grad(lambda ww: be.csrmv(
            ww, indices, indptr, jnp.ones(3000), shape=(3000, 3000)).sum()),
            w)


def test_vector_grad_is_silent():
    rng = np.random.default_rng(0)
    indices, indptr, nse = _structure(rng, 3000, 200)
    w = jnp.ones(nse, jnp.float32)
    v = jnp.ones(3000, jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        jax.eval_shape(jax.grad(lambda vv: be.csrmv(
            w, indices, indptr, vv, shape=(3000, 3000)).sum()), v)
