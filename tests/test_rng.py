# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""RNG subsystem conformance tests.

The light-RNG vectorized JAX implementation is validated against an
independent scalar NumPy transcription of the published algorithm spec
(murmur-mix finalizer, xorshift32, umulhi bounded reduction, Acklam
inverse-CDF), mirroring the reference's dual-implementation conformance
strategy (``brainevent/_numba_random.py`` vs CUDA)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu.rng as rng
from brainevent_tpu import config

U32 = np.uint32
MASK = np.uint64(0xFFFFFFFF)


# --- independent scalar reference (NumPy, C-style uint32 wraparound) --------

def ref_mix32(x):
    x = U32(x)
    x = U32(x ^ (x >> U32(16)))
    x = U32((np.uint64(x) * np.uint64(0x7FEB352D)) & MASK)
    x = U32(x ^ (x >> U32(15)))
    x = U32((np.uint64(x) * np.uint64(0x846CA68B)) & MASK)
    return U32(x ^ (x >> U32(16)))


def ref_bounded(r, bound):
    return U32((np.uint64(r) * np.uint64(bound)) >> np.uint64(32))


def ref_next(x):
    x = U32(x)
    x = U32(x ^ U32((np.uint64(x) << np.uint64(13)) & MASK))
    x = U32(x ^ (x >> U32(17)))
    x = U32(x ^ U32((np.uint64(x) << np.uint64(5)) & MASK))
    return U32(0x6D2B79F5) if x == 0 else x


def ref_init(seed, row, chunk, lane):
    x = U32(U32(seed) ^ U32(0xD1B54A35))
    x = U32(x ^ U32((np.uint64(U32(row)) * np.uint64(0x85EBCA6B)) & MASK))
    x = U32(x ^ U32((np.uint64(U32(chunk)) * np.uint64(0xC2B2AE35)) & MASK))
    x = U32(x ^ U32((np.uint64(U32(lane)) * np.uint64(0x27D4EB2D)) & MASK))
    x = ref_mix32(x)
    return U32(0x6D2B79F5) if x == 0 else x


def ref_uniform01(seed, row, col):
    h = U32(U32(seed) ^ U32(0xA0761D65))
    h = U32(h ^ U32((np.uint64(U32(row)) * np.uint64(0xE7037ED1)) & MASK))
    h = U32(h ^ U32((np.uint64(U32(col)) * np.uint64(0x8EBC6AF1)) & MASK))
    h = ref_mix32(h)
    return np.float32((h & U32(0x00FFFFFF)) * np.float32(1.0 / 16777216.0))


def ref_initial_q(state, cl):
    n = U32(U32(cl) - U32(1))
    while True:
        state = ref_next(state)
        q = ref_bounded(state, n)
        state = ref_next(state)
        gate = ref_bounded(state, n)
        if gate < U32(n - q):
            return q, state


class TestLightRNG:
    def test_mix32_matches_scalar(self, rng_values=None):
        xs = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
        got = np.asarray(rng.light_rng_mix32(jnp.asarray(xs)))
        want = np.array([ref_mix32(x) for x in xs], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)

    def test_bounded_matches_scalar(self):
        rs = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x12345678], dtype=np.uint32)
        bounds = np.array([1, 7, 19, 256, 1000], dtype=np.uint32)
        got = np.asarray(rng.light_rng_bounded(jnp.asarray(rs), jnp.asarray(bounds)))
        want = np.array([ref_bounded(r, b) for r, b in zip(rs, bounds)], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)

    def test_next_matches_scalar(self):
        xs = np.array([1, 2, 42, 0xCAFEBABE, 0xFFFFFFFF], dtype=np.uint32)
        got = np.asarray(rng.light_rng_next(jnp.asarray(xs)))
        want = np.array([ref_next(x) for x in xs], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)

    def test_init_matches_scalar(self):
        got = np.asarray(rng.light_rng_init(
            jnp.uint32(42),
            jnp.arange(5, dtype=jnp.uint32),
            jnp.uint32(3),
            jnp.uint32(7),
        ))
        want = np.array([ref_init(42, r, 3, 7) for r in range(5)], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)

    def test_uniform01_matches_scalar(self):
        rows = np.arange(8, dtype=np.uint32)
        got = np.asarray(rng.light_rng_uniform01(
            jnp.uint32(123), jnp.asarray(rows), jnp.uint32(9)))
        want = np.array([ref_uniform01(123, r, 9) for r in rows], dtype=np.float32)
        np.testing.assert_array_equal(got, want)

    def test_uniform01_range(self):
        rows = jnp.arange(4096, dtype=jnp.uint32)
        u = np.asarray(rng.light_rng_uniform01(jnp.uint32(7), rows, jnp.uint32(0)))
        assert (u >= 0).all() and (u < 1).all()
        assert abs(u.mean() - 0.5) < 0.02

    def test_normal01_distribution(self):
        rows = jnp.arange(65536, dtype=jnp.uint32)
        z = np.asarray(rng.light_rng_normal01(jnp.uint32(3), rows, jnp.uint32(11)))
        assert abs(z.mean()) < 0.02
        assert abs(z.std() - 1.0) < 0.02

    def test_initial_q_matches_scalar(self):
        cl = 8
        states = np.array([ref_init(5, r, 0, 0) for r in range(16)], dtype=np.uint32)
        want = [ref_initial_q(s, cl) for s in states]
        want_q = np.array([w[0] for w in want], dtype=np.uint32)
        want_st = np.array([w[1] for w in want], dtype=np.uint32)
        got_q, got_st = rng.light_rng_initial_q(jnp.asarray(states), jnp.uint32(cl))
        np.testing.assert_array_equal(np.asarray(got_q), want_q)
        np.testing.assert_array_equal(np.asarray(got_st), want_st)

    def test_jit_and_vmap_compose(self):
        f = jax.jit(lambda s: rng.light_rng_mix32(s))
        x = jnp.arange(16, dtype=jnp.uint32)
        np.testing.assert_array_equal(f(x), rng.light_rng_mix32(x))
        g = jax.vmap(lambda r: rng.light_rng_uniform01(jnp.uint32(1), r, jnp.uint32(0)))
        assert g(jnp.arange(8, dtype=jnp.uint32)).shape == (8,)


class TestLFSR:
    @pytest.mark.parametrize('cls_name', ['lfsr88', 'lfsr113', 'lfsr128'])
    def test_determinism_and_advance(self, cls_name):
        config.set_lfsr_algorithm(cls_name)
        try:
            cls = rng.get_pallas_lfsr_rng_class()
            a, b = cls(42), cls(42)
            assert np.asarray(a.randint()) == np.asarray(b.randint())
            v1 = np.asarray(a.randint())
            v2 = np.asarray(a.randint())
            assert v1 != v2  # state advances
        finally:
            config.set_lfsr_algorithm('lfsr88')

    def test_rand_range_and_moments(self):
        # adjacent integer seeds correlate the first few outputs of a raw
        # Tausworthe state; warm the streams up before measuring moments.
        g = rng.PallasLFSR88RNG(jnp.full((4, 128), 7, dtype=jnp.uint32)
                                + jnp.arange(4 * 128, dtype=jnp.uint32).reshape(4, 128))
        for _ in range(16):
            g.rand()
        draws = np.concatenate([np.asarray(g.rand()).ravel() for _ in range(40)])
        assert (draws >= 0).all() and (draws < 1).all()
        assert abs(draws.mean() - 0.5) < 0.02

    def test_randn_moments(self):
        g = rng.PallasLFSR113RNG(jnp.arange(1024, dtype=jnp.uint32))
        for _ in range(16):
            g.rand()
        z = np.concatenate([np.asarray(g.randn()).ravel() for _ in range(40)])
        assert abs(z.mean()) < 0.03
        assert abs(z.std() - 1.0) < 0.03

    def test_random_integers_inclusive(self):
        g = rng.PallasLFSR128RNG(jnp.arange(512, dtype=jnp.uint32))
        vals = np.asarray(g.random_integers(2, 5))
        assert vals.min() >= 2 and vals.max() <= 5

    def test_pytree_roundtrip(self):
        g = rng.PallasLFSR88RNG(3)
        leaves, treedef = jax.tree_util.tree_flatten(g)
        g2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert np.asarray(g.randint()) == np.asarray(g2.randint())

    def test_usable_under_jit(self):
        def draw(seed):
            g = rng.PallasLFSR88RNG(seed)
            return g.rand()
        a = jax.jit(draw)(jnp.uint32(9))
        b = draw(jnp.uint32(9))
        np.testing.assert_allclose(a, b)

    def test_factory_respects_config(self):
        config.set_lfsr_algorithm('lfsr113')
        try:
            assert isinstance(rng.PallasLFSRRNG(1), rng.PallasLFSR113RNG)
        finally:
            config.set_lfsr_algorithm('lfsr88')

    def test_inside_pallas_kernel(self):
        """LFSR draws inside a Pallas kernel (interpreted on CPU)."""
        from jax.experimental import pallas as pl

        def kern(seed_ref, o_ref):
            g = rng.PallasLFSR88RNG(seed_ref[:])
            o_ref[:] = g.rand()

        seeds = jnp.arange(8 * 128, dtype=jnp.uint32).reshape(8, 128)
        out = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True,
        )(seeds)
        # must equal the plain-JAX draws (same math path)
        g = rng.PallasLFSR88RNG(seeds)
        np.testing.assert_allclose(np.asarray(out), np.asarray(g.rand()))
