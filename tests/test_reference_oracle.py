# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Stream conformance against the REFERENCE's own pure-Python RNG.

The reference ships a numba-optional, plain-Python implementation of every
RNG primitive (``/root/reference/brainevent/_numba_random.py``). These tests
import that file directly (with its one relative import stubbed) and demand
stream-for-stream equality from this repo's implementations — the external
oracle the round-1 review asked for, replacing builder-checks-builder
NumPy transcriptions:

- LFSR88/113/128: seed expansion, ``next_key``, and every draw method,
  against both the scalar port (``rng/scalar.py``) and the vectorized
  JAX classes (``rng/lfsr.py``).
- light-RNG: ``mix32 / bounded / next / init / uniform01 / normal01 /
  initial_q`` against the vectorized ``rng/light.py``.
- JITC end-to-end: ``jits/jitn/jitu`` dense materialization against a
  transcription of the reference walk loop
  (``/root/reference/brainevent/_jit_scalar/float.py:436-496``) driven by
  the REFERENCE's RNG functions, plus ``jitnmv`` against the oracle dense.
"""

import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu.rng.scalar as my_scalar
from brainevent_tpu.rng.lfsr import (PallasLFSR88RNG, PallasLFSR113RNG,
                                     PallasLFSR128RNG)
from brainevent_tpu.rng import light as my_light

_REF = '/root/reference/brainevent/_numba_random.py'

pytestmark = pytest.mark.skipif(
    not os.path.exists(_REF), reason='reference checkout not available')


@pytest.fixture(scope='module')
def ref():
    """Load the reference RNG module standalone (config import stubbed)."""
    pkg = types.ModuleType('_refpkg')
    pkg.__path__ = []
    cfg = types.ModuleType('_refpkg.config')
    cfg.get_lfsr_algorithm = lambda: 'lfsr113'
    sys.modules['_refpkg'] = pkg
    sys.modules['_refpkg.config'] = cfg
    spec = importlib.util.spec_from_file_location('_refpkg._numba_random',
                                                  _REF)
    mod = importlib.util.module_from_spec(spec)
    sys.modules['_refpkg._numba_random'] = mod
    spec.loader.exec_module(mod)
    return mod


SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
ALGS = ['lfsr88', 'lfsr113', 'lfsr128']
_VEC = {'lfsr88': PallasLFSR88RNG, 'lfsr113': PallasLFSR113RNG,
        'lfsr128': PallasLFSR128RNG}


# ---------------------------------------------------------------------------
# LFSR families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('alg', ALGS)
@pytest.mark.parametrize('seed', SEEDS)
def test_lfsr_state_stream_vs_reference(ref, alg, seed):
    """Scalar port: seed expansion + 64 next_key steps, state-for-state."""
    r_seed = getattr(ref, f'{alg}_seed')
    r_next = getattr(ref, f'{alg}_next_key')
    m_seed = getattr(my_scalar, f'{alg}_seed')
    m_next = getattr(my_scalar, f'{alg}_next_key')
    rs, ms = r_seed(seed), m_seed(seed)
    np.testing.assert_array_equal(np.asarray(rs), np.asarray(ms))
    for _ in range(64):
        r_next(rs)
        m_next(ms)
        np.testing.assert_array_equal(np.asarray(rs), np.asarray(ms))


@pytest.mark.parametrize('alg', ALGS)
def test_lfsr_draws_vs_reference(ref, alg):
    """Scalar port: every draw method, sequence-for-sequence."""
    seed = 7
    rs = getattr(ref, f'{alg}_seed')(seed)
    ms = getattr(my_scalar, f'{alg}_seed')(seed)
    for name, args, exact in [
        ('randint', (), True),
        ('rand', (), True),
        ('randn', (), False),
        ('uniform', (-2.0, 3.0), True),
        ('normal', (1.0, 2.5), False),
        ('random_integers', (3, 17), True),
    ]:
        r_fn = getattr(ref, f'{alg}_{name}')
        m_fn = getattr(my_scalar, f'{alg}_{name}')
        for _ in range(32):
            rv, mv = r_fn(rs, *args), m_fn(ms, *args)
            if exact:
                assert rv == mv, (alg, name, rv, mv)
            else:
                np.testing.assert_allclose(rv, mv, rtol=1e-12)


@pytest.mark.parametrize('alg', ALGS)
@pytest.mark.parametrize('seed', [0, 42])
def test_lfsr_vectorized_stream_vs_reference(ref, alg, seed):
    """Vectorized JAX classes reproduce the reference scalar stream."""
    rs = getattr(ref, f'{alg}_seed')(seed)
    vec = _VEC[alg](seed)
    key = tuple(np.asarray(k, np.uint32) for k in vec.key)
    np.testing.assert_array_equal(np.asarray(rs), np.stack(key).reshape(-1))
    r_randint = getattr(ref, f'{alg}_randint')
    for _ in range(32):
        rv = r_randint(rs)
        mv = np.asarray(vec.randint(), np.uint32)
        assert np.uint32(rv) == mv
    # rand: reference computes in f64, this class in f32
    r_rand = getattr(ref, f'{alg}_rand')
    for _ in range(8):
        np.testing.assert_allclose(np.float32(r_rand(rs)),
                                   np.asarray(vec.rand()), rtol=2e-7)


# ---------------------------------------------------------------------------
# light-RNG (the JITC stream generator)
# ---------------------------------------------------------------------------

def test_light_rng_core_vs_reference(ref):
    xs = np.array([0, 1, 2, 0x6D2B79F5, 0xFFFFFFFF, 12345, 2**31],
                  np.uint32)
    got_mix = np.asarray(my_light.light_rng_mix32(jnp.asarray(xs)))
    want_mix = np.array([ref.light_rng_mix32(np.uint32(x)) for x in xs],
                        np.uint32)
    np.testing.assert_array_equal(got_mix, want_mix)

    got_next = np.asarray(my_light.light_rng_next(jnp.asarray(xs)))
    want_next = np.array([ref.light_rng_next(np.uint32(x)) for x in xs],
                         np.uint32)
    np.testing.assert_array_equal(got_next, want_next)

    bounds = np.array([1, 2, 17, 1000, 2**31 - 1], np.uint32)
    for b in bounds:
        got = np.asarray(my_light.light_rng_bounded(jnp.asarray(xs),
                                                    jnp.uint32(b)))
        want = np.array(
            [ref.light_rng_bounded(np.uint32(x), np.uint32(b)) for x in xs],
            np.uint32)
        np.testing.assert_array_equal(got, want)


def test_light_rng_init_grid_vs_reference(ref):
    seeds = [0, 42, 987654321]
    rows = np.arange(7, dtype=np.uint32)
    chunks = np.arange(5, dtype=np.uint32)
    lanes = np.arange(32, dtype=np.uint32)
    for seed in seeds:
        r3, c3, l3 = np.meshgrid(rows, chunks, lanes, indexing='ij')
        got = np.asarray(my_light.light_rng_init(
            jnp.uint32(seed), jnp.asarray(r3), jnp.asarray(c3),
            jnp.asarray(l3)))
        want = np.vectorize(
            lambda r, c, l: ref.light_rng_init(
                np.uint32(seed), np.uint32(r), np.uint32(c), np.uint32(l)),
            otypes=[np.uint32])(r3, c3, l3)
        np.testing.assert_array_equal(got, want)


def test_light_rng_uniform_normal_vs_reference(ref):
    rows = np.arange(16, dtype=np.uint32)
    cols = np.arange(33, dtype=np.uint32)
    r2, c2 = np.meshgrid(rows, cols, indexing='ij')
    for seed in (0, 42):
        got_u = np.asarray(my_light.light_rng_uniform01(
            jnp.uint32(seed), jnp.asarray(r2), jnp.asarray(c2)))
        want_u = np.vectorize(
            lambda r, c: ref.light_rng_uniform01(
                np.uint32(seed), np.uint32(r), np.uint32(c)),
            otypes=[np.float32])(r2, c2)
        np.testing.assert_array_equal(got_u, want_u)

        got_n = np.asarray(my_light.light_rng_normal01(
            jnp.uint32(seed), jnp.asarray(r2), jnp.asarray(c2)))
        want_n = np.vectorize(
            lambda r, c: ref.light_rng_normal01(
                np.uint32(seed), np.uint32(r), np.uint32(c)),
            otypes=[np.float32])(r2, c2)
        np.testing.assert_allclose(got_n, want_n, rtol=3e-7, atol=1e-7)


def test_light_rng_initial_q_vs_reference(ref):
    states = np.array([1, 2, 0x6D2B79F5, 999999, 2**32 - 5], np.uint32)
    for cl in (2, 3, 13, 1000):
        got_q, got_s = my_light.light_rng_initial_q(
            jnp.asarray(states), jnp.uint32(cl))
        for i, s in enumerate(states):
            q, ns = ref.light_rng_initial_q(np.uint32(s), np.uint32(cl))
            assert np.asarray(got_q)[i] == q, (s, cl)
            assert np.asarray(got_s)[i] == ns, (s, cl)


# ---------------------------------------------------------------------------
# JITC end-to-end: dense materialization vs the reference walk transcribed
# with the reference's own RNG functions
# ---------------------------------------------------------------------------

_MV_STRIDE = 32


def _oracle_dense(ref, weight_of, shape, prob, seed, corder):
    """Transcription of ``_jitc_homo_matrix_numba_kernel``
    (/root/reference/brainevent/_jit_scalar/float.py:436-496), with the
    connectivity and weight draws delegated to the reference RNG module.
    ``weight_of(row, col)`` encodes the family's weight law."""
    clen = max(2, int(np.ceil(2.0 / prob)))   # reference _data.py:1212
    # chunk_size keys on logical shape[1] (reference _misc.py:74)
    chunk_size = max(1, -(-shape[1] // 4))
    if corder:       # notrans: walk output rows/cols, write out[row, col]
        n_rows, n_cols = shape
    else:            # trans: streams keyed by shape[1], write out[col, row]
        n_rows, n_cols = shape[1], shape[0]
    out = np.zeros(shape, np.float64)
    seed0 = np.uint32(seed)
    cl = np.uint32(clen)
    n_chunks = (n_cols + chunk_size - 1) // chunk_size
    for row in range(n_rows):
        for chunk_id in range(n_chunks):
            chunk_start = chunk_id * chunk_size
            if chunk_start >= n_cols:
                break
            chunk_width = min(chunk_start + chunk_size, n_cols) - chunk_start
            for lane in range(_MV_STRIDE):
                state = ref.light_rng_init(seed0, np.uint32(row),
                                           np.uint32(chunk_id),
                                           np.uint32(lane))
                q, state = ref.light_rng_initial_q(state, cl)
                local_j = lane + _MV_STRIDE * int(q)
                while local_j < chunk_width:
                    col = chunk_start + local_j
                    w = weight_of(row, col)
                    if corder:
                        out[row, col] = w
                    else:
                        out[col, row] = w
                    state = ref.light_rng_next(state)
                    q = q + np.uint32(1) + ref.light_rng_bounded(
                        state, cl - np.uint32(1))
                    local_j = lane + _MV_STRIDE * int(q)
    return out


SHAPE = (25, 37)
PROB = 0.2
SEED = 2024


@pytest.mark.parametrize('corder', [True, False])
def test_jits_dense_vs_reference_walk(ref, corder):
    from brainevent_tpu.jitc import jits
    w = 1.5
    want = _oracle_dense(ref, lambda r, c: w, SHAPE, PROB, SEED, corder)
    got = np.asarray(jits(w, PROB, SEED, shape=SHAPE, corder=corder))
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize('corder', [True, False])
def test_jitn_dense_vs_reference_walk(ref, corder):
    from brainevent_tpu.jitc import jitn
    loc, scale = 0.5, 2.0

    def weight_of(row, col):
        n01 = ref.light_rng_normal01(np.uint32(SEED), np.uint32(row),
                                     np.uint32(col))
        return np.float32(loc) + n01 * np.float32(scale)

    want = _oracle_dense(ref, weight_of, SHAPE, PROB, SEED, corder)
    got = np.asarray(jitn(loc, scale, PROB, SEED, shape=SHAPE,
                          corder=corder))
    # connectivity pattern must be EXACT; weights may differ by f32
    # transcendental rounding (XLA vs NumPy log/sqrt in the Acklam tails)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize('corder', [True, False])
def test_jitu_dense_vs_reference_walk(ref, corder):
    from brainevent_tpu.jitc import jitu
    low, high = -1.0, 2.0

    def weight_of(row, col):
        u01 = ref.light_rng_uniform01(np.uint32(SEED), np.uint32(row),
                                      np.uint32(col))
        return np.float32(low) + u01 * np.float32(high - low)

    want = _oracle_dense(ref, weight_of, SHAPE, PROB, SEED, corder)
    got = np.asarray(jitu(low, high, PROB, SEED, shape=SHAPE,
                          corder=corder))
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=3e-7,
                               atol=1e-6)


def test_jitnmv_vs_reference_walk_dense(ref):
    """End-to-end: jitnmv output equals oracle-dense @ v."""
    from brainevent_tpu.jitc import jitnmv
    loc, scale = 0.5, 2.0

    def weight_of(row, col):
        n01 = ref.light_rng_normal01(np.uint32(SEED), np.uint32(row),
                                     np.uint32(col))
        return np.float32(loc) + n01 * np.float32(scale)

    dense = _oracle_dense(ref, weight_of, SHAPE, PROB, SEED, True)
    v = np.linspace(-1, 1, SHAPE[1]).astype(np.float32)
    want = dense.astype(np.float32) @ v
    got = np.asarray(jitnmv(loc, scale, PROB, v, SEED, shape=SHAPE,
                            corder=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
