# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Tests for event representations + encoder primitives
(mirrors reference ``brainevent/_event/*_test.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.events import (
    binary_1d_array_index_p_call,
    binary_2d_compact_only_p_call,
    binary_2d_array_index_p_call,
    binary_2d_pair_stream_encode_p_call,
    binary_2d_row_sparse_encode_p_call,
    binary_2d_csr_row_count_p_call,
    binary_2d_csr_encode_p_call,
    binary_2d_csc_encode_p_call,
)


def spikes_1d(rng, n=64, rate=0.25, dtype=bool):
    s = rng.random(n) < rate
    return s if dtype is bool else s.astype(dtype)


class TestBinaryArray:
    def test_matmul_dense(self, rng):
        s = rng.random(16) < 0.3
        w = rng.normal(size=(16, 8)).astype(np.float32)
        out = be.BinaryArray(jnp.asarray(s)) @ jnp.asarray(w)
        np.testing.assert_allclose(out, s.astype(np.float32) @ w, rtol=1e-5)

    def test_rmatmul_dense(self, rng):
        s = rng.random(8) < 0.3
        w = rng.normal(size=(16, 8)).astype(np.float32)
        out = jnp.asarray(w) @ be.BinaryArray(jnp.asarray(s))
        np.testing.assert_allclose(out, w @ s.astype(np.float32), rtol=1e-5)

    def test_matmul_2d_events(self, rng):
        s = rng.random((4, 16)) < 0.3
        w = rng.normal(size=(16, 8)).astype(np.float32)
        out = be.BinaryArray(jnp.asarray(s)) @ jnp.asarray(w)
        np.testing.assert_allclose(out, s.astype(np.float32) @ w, rtol=1e-4)

    def test_float_events_gate_not_scale(self, rng):
        # reference contract (brainevent/_dense/binary.py:141-142): float
        # events are ACTIVE at > 0 and contribute the bare weight — the
        # event value never scales it.
        s = (rng.random(16) < 0.3).astype(np.float32) * 2.0
        w = rng.normal(size=(16, 8)).astype(np.float32)
        out = be.BinaryArray(jnp.asarray(s)) @ jnp.asarray(w)
        np.testing.assert_allclose(out, (s > 0).astype(np.float32) @ w,
                                   rtol=1e-5)

    def test_grad_through_event_matmul(self, rng):
        s = (rng.random(16) < 0.5).astype(np.float32)
        w = rng.normal(size=(16, 8)).astype(np.float32)

        def loss(w):
            return (be.BinaryArray(jnp.asarray(s)) @ w).sum()

        g = jax.grad(loss)(jnp.asarray(w))
        expect = np.broadcast_to(s[:, None], (16, 8))
        np.testing.assert_allclose(g, expect, rtol=1e-5)

    def test_pytree(self):
        ba = be.BinaryArray(jnp.ones(4, dtype=bool))
        leaves, treedef = jax.tree_util.tree_flatten(ba)
        ba2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert isinstance(ba2, be.BinaryArray) and ba2.shape == (4,)

    def test_getitem_and_props(self):
        ba = be.BinaryArray(jnp.eye(3, dtype=bool))
        assert ba.ndim == 2 and ba.size == 9 and len(ba) == 3
        assert isinstance(ba[0], be.BinaryArray)

    def test_densemv_matches_dense(self, rng):
        s = rng.random(64) < 0.3
        w = rng.normal(size=(32, 64)).astype(np.float32)
        a = be.binary_densemv(jnp.asarray(w), jnp.asarray(s), transpose=False)
        np.testing.assert_allclose(a, w.astype(np.float64) @ s, rtol=1e-5,
                                   atol=1e-5)

    def test_densemm_matches_dense(self, rng):
        s = rng.random((64, 8)) < 0.2
        w = rng.normal(size=(32, 64)).astype(np.float32)
        a = be.binary_densemm(jnp.asarray(w), jnp.asarray(s), transpose=False)
        np.testing.assert_allclose(np.asarray(a), w.astype(np.float64) @ s,
                                   rtol=1e-5, atol=1e-5)

    def test_densemv_vmap_reroutes_to_mm(self, rng):
        w = rng.normal(size=(8, 16)).astype(np.float32)
        s = (rng.random((5, 16)) < 0.4).astype(np.float32)
        out = jax.vmap(
            lambda v: be.binary_densemv(jnp.asarray(w), v, transpose=False)
        )(jnp.asarray(s))
        np.testing.assert_allclose(out, s @ w.T, rtol=1e-4)


class TestBitpack:
    def test_roundtrip_bits(self, rng):
        x = rng.random(70) < 0.5
        packed = np.asarray(be.bitpack(jnp.asarray(x), 0))
        assert packed.shape == (3,)
        for i, bit in enumerate(x):
            w, b = divmod(i, 32)
            assert bool((packed[w] >> b) & 1) == bool(bit)

    def test_axis1(self, rng):
        x = rng.random((4, 40)) < 0.5
        packed = np.asarray(be.bitpack(jnp.asarray(x), 1))
        assert packed.shape == (4, 2)

    def test_bitpacked_matmul_matches(self, rng):
        s = rng.random(16) < 0.4
        w = rng.normal(size=(16, 8)).astype(np.float32)
        bp = be.BitPackedBinary(jnp.asarray(s))
        assert bp.shape == (16,)
        out = bp @ jnp.asarray(w)
        np.testing.assert_allclose(out, s.astype(np.float32) @ w, rtol=1e-5)

    def test_binaryarray_bitpack_method(self):
        ba = be.BinaryArray(jnp.ones(40, dtype=bool))
        bp = ba.bitpack()
        assert isinstance(bp, be.BitPackedBinary)
        assert bp.packed[0].shape == (2,)


class TestEncoders:
    def test_1d_array_index(self, rng):
        x = spikes_1d(rng, 64, 0.3)
        ids, cnt = binary_1d_array_index_p_call(jnp.asarray(x))
        want = np.nonzero(x)[0]
        assert int(cnt[0]) == len(want)
        np.testing.assert_array_equal(np.asarray(ids)[:len(want)], want)

    def test_2d_compact_only(self, rng):
        x = rng.random((32, 4)) < 0.1
        ids, cnt = binary_2d_compact_only_p_call(jnp.asarray(x))
        want = np.nonzero(x.any(axis=1))[0]
        assert int(cnt[0]) == len(want)
        np.testing.assert_array_equal(np.asarray(ids)[:len(want)], want)

    def test_2d_array_index(self, rng):
        x = rng.random((16, 40)) < 0.2
        packed, ids, cnt = binary_2d_array_index_p_call(jnp.asarray(x))
        assert packed.shape == (16, 2) and packed.dtype == jnp.uint32
        want = np.nonzero(x.any(axis=1))[0]
        assert int(cnt[0]) == len(want)
        np.testing.assert_array_equal(
            np.asarray(packed), np.asarray(be.bitpack(jnp.asarray(x), 1)))

    def test_pair_stream(self, rng):
        x = rng.random((8, 6)) < 0.25
        pairs, n = binary_2d_pair_stream_encode_p_call(jnp.asarray(x))
        rr, cc = np.nonzero(x)
        assert int(n[0]) == len(rr)
        got = np.asarray(pairs)[:len(rr)]
        np.testing.assert_array_equal(got[:, 0], rr)
        np.testing.assert_array_equal(got[:, 1], cc)

    def test_row_sparse(self, rng):
        x = rng.random((8, 10)) < 0.3
        (enc,) = binary_2d_row_sparse_encode_p_call(jnp.asarray(x))
        enc = np.asarray(enc)
        for r in range(8):
            want = np.nonzero(x[r])[0] + 1
            np.testing.assert_array_equal(enc[r, :len(want)], want)
            assert (enc[r, len(want):] == 0).all()

    def test_csr_encode(self, rng):
        x = rng.random((8, 10)) < 0.3
        indices, indptr = binary_2d_csr_encode_p_call(jnp.asarray(x))
        (counts,) = binary_2d_csr_row_count_p_call(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(counts), x.sum(axis=1))
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        for r in range(8):
            want = np.nonzero(x[r])[0]
            np.testing.assert_array_equal(
                indices[indptr[r]:indptr[r + 1]], want)

    def test_csc_encode(self, rng):
        x = rng.random((8, 10)) < 0.3
        indices, indptr = binary_2d_csc_encode_p_call(jnp.asarray(x))
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        for c in range(10):
            want = np.nonzero(x[:, c])[0]
            np.testing.assert_array_equal(
                indices[indptr[c]:indptr[c + 1]], want)

    def test_encoders_jit(self, rng):
        x = jnp.asarray(rng.random((8, 10)) < 0.3)
        f = jax.jit(lambda v: binary_2d_csr_encode_p_call(v))
        a = f(x)
        b = binary_2d_csr_encode_p_call(x)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


class TestCompactBinary:
    def test_from_array_1d(self, rng):
        x = spikes_1d(rng, 70, 0.2)
        cb = be.CompactBinary.from_array(jnp.asarray(x))
        want = np.nonzero(x)[0]
        assert int(cb.n_active[0]) == len(want)
        np.testing.assert_array_equal(np.asarray(cb.active_ids)[:len(want)], want)
        assert cb.packed.shape == (3,)
        np.testing.assert_array_equal(np.asarray(cb.to_dense()), x)

    def test_from_array_2d(self, rng):
        x = rng.random((16, 40)) < 0.15
        cb = be.CompactBinary.from_array(jnp.asarray(x))
        assert cb.batch_size == 40 and cb.n_orig == 16
        assert cb.packed.shape == (16, 2)

    def test_light_and_pytree(self, rng):
        x = spikes_1d(rng, 32, 0.3)
        cb = be.CompactBinary.from_array_light(jnp.asarray(x))
        assert cb.packed is None
        leaves, treedef = jax.tree_util.tree_flatten(cb)
        cb2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert isinstance(cb2, be.CompactBinary)

    def test_matmul_delegates(self, rng):
        x = spikes_1d(rng, 16, 0.4)
        w = rng.normal(size=(16, 4)).astype(np.float32)
        cb = be.CompactBinary.from_array(jnp.asarray(x))
        np.testing.assert_allclose(
            cb @ jnp.asarray(w), x.astype(np.float32) @ w, rtol=1e-5)


class TestDense:
    def test_event_matmul(self, rng):
        w = rng.normal(size=(8, 16)).astype(np.float32)
        s = rng.random(16) < 0.4
        d = be.Dense(jnp.asarray(w))
        out = d @ be.BinaryArray(jnp.asarray(s))
        np.testing.assert_allclose(out, w @ s.astype(np.float32), rtol=1e-5)

    def test_rmatmul_event(self, rng):
        w = rng.normal(size=(8, 16)).astype(np.float32)
        s = rng.random(8) < 0.4
        d = be.Dense(jnp.asarray(w))
        out = be.BinaryArray(jnp.asarray(s)) @ d
        np.testing.assert_allclose(out, s.astype(np.float32) @ w, rtol=1e-5)

    def test_elementwise_algebra(self, rng):
        w = rng.normal(size=(4, 4)).astype(np.float32)
        d = be.Dense(jnp.asarray(w)) * 2.0
        np.testing.assert_allclose(np.asarray(d.todense()), w * 2, rtol=1e-6)

    def test_transpose_diag_add(self, rng):
        w = rng.normal(size=(4, 4)).astype(np.float32)
        d = be.Dense(jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(d.T.todense()), w.T)
        d2 = d.diag_add(1.0)
        np.testing.assert_allclose(np.asarray(d2.todense()), w + np.eye(4),
                                   rtol=1e-6)

    def test_update_on_pre_post(self, rng):
        w = rng.normal(size=(4, 6)).astype(np.float32)
        pre = rng.random(4) < 0.5
        trace = rng.normal(size=6).astype(np.float32)
        d = be.Dense(jnp.asarray(w))
        out = d.update_on_pre(jnp.asarray(pre), jnp.asarray(trace))
        want = w + np.outer(pre.astype(np.float32), trace)
        np.testing.assert_allclose(np.asarray(out.todense()), want, rtol=1e-5)

        post = rng.random(6) < 0.5
        trace2 = rng.normal(size=4).astype(np.float32)
        out2 = d.update_on_post(jnp.asarray(trace2), jnp.asarray(post))
        want2 = w + np.outer(trace2, post.astype(np.float32))
        np.testing.assert_allclose(np.asarray(out2.todense()), want2, rtol=1e-5)

    def test_update_clip(self, rng):
        w = np.zeros((2, 2), np.float32)
        d = be.Dense(jnp.asarray(w))
        out = d.update_on_pre(jnp.asarray([True, True]),
                              jnp.asarray([5.0, -5.0], dtype=jnp.float32),
                              w_min=-1.0, w_max=1.0)
        np.testing.assert_allclose(np.asarray(out.todense()),
                                   [[1, -1], [1, -1]])

    def test_solve(self, rng):
        a = np.eye(3, dtype=np.float32) * 2
        d = be.Dense(jnp.asarray(a))
        x = d.solve(jnp.ones(3))
        np.testing.assert_allclose(x, 0.5, rtol=1e-5)

    def test_pytree(self):
        d = be.Dense(jnp.ones((2, 2)))
        leaves, treedef = jax.tree_util.tree_flatten(d)
        d2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert isinstance(d2, be.Dense) and d2.shape == (2, 2)


class TestDenseGrad:
    def test_transpose_rule_weights(self, rng):
        w = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))
        s = jnp.asarray((rng.random(16) < 0.4).astype(np.float32))

        def loss(w):
            return be.binary_densemv(w, s, transpose=False).sum()

        g = jax.grad(loss)(w)
        np.testing.assert_allclose(g, np.broadcast_to(np.asarray(s), (8, 16)),
                                   rtol=1e-5)

    def test_transpose_rule_spikes(self, rng):
        w = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))
        s = jnp.asarray((rng.random(16) < 0.4).astype(np.float32))

        def loss(s):
            return be.binary_densemv(w, s, transpose=False).sum()

        g = jax.grad(loss)(s)
        np.testing.assert_allclose(g, np.asarray(w).sum(0), rtol=1e-4)


class TestEncoderEdges:
    """Capacity / degenerate-input edges for the static-capacity encoders
    (reference validation at ``brainevent/_event/compact.py:853-905``)."""

    def test_row_sparse_row_size_output_shape(self, rng):
        x = rng.random((8, 20)) < 0.15
        # generous capacity: output is (n_src, row_size)
        (enc,) = binary_2d_row_sparse_encode_p_call(jnp.asarray(x),
                                                    row_size=10)
        assert enc.shape == (8, 10)
        enc = np.asarray(enc)
        for r in range(8):
            want = np.nonzero(x[r])[0] + 1
            np.testing.assert_array_equal(enc[r, :len(want)], want)
            assert (enc[r, len(want):] == 0).all()

    def test_row_sparse_overflow_raises(self, rng):
        x = np.zeros((4, 12), bool)
        x[2, :7] = True          # row NNZ 7 > row_size 4
        with pytest.raises(ValueError, match='too small'):
            binary_2d_row_sparse_encode_p_call(jnp.asarray(x), row_size=4)

    def test_row_sparse_row_size_bounds(self, rng):
        x = jnp.zeros((4, 12), bool)
        with pytest.raises(ValueError, match='positive'):
            binary_2d_row_sparse_encode_p_call(x, row_size=0)
        with pytest.raises(ValueError, match='<= n_batch'):
            binary_2d_row_sparse_encode_p_call(x, row_size=13)

    def test_row_sparse_tracer_skips_validation(self, rng):
        # tracer-time inputs skip the eager overflow check (reference
        # behavior) but still produce the static shape
        x = jnp.asarray(rng.random((4, 12)) < 0.1)
        f = jax.jit(lambda v: binary_2d_row_sparse_encode_p_call(
            v, row_size=6)[0])
        assert f(x).shape == (4, 6)

    def test_all_active(self, rng):
        x = np.ones((6, 8), bool)
        ids, cnt = binary_2d_compact_only_p_call(jnp.asarray(x))
        assert int(cnt[0]) == 6
        pairs, n = binary_2d_pair_stream_encode_p_call(jnp.asarray(x))
        assert int(n[0]) == 48
        (enc,) = binary_2d_row_sparse_encode_p_call(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(enc),
                                      np.tile(np.arange(1, 9), (6, 1)))

    def test_all_quiet(self, rng):
        x = np.zeros((6, 8), bool)
        ids, cnt = binary_2d_compact_only_p_call(jnp.asarray(x))
        assert int(cnt[0]) == 0
        indices, indptr = binary_2d_csr_encode_p_call(jnp.asarray(x))
        assert (np.asarray(indptr) == 0).all()
        ids1, cnt1 = binary_1d_array_index_p_call(jnp.zeros(16, bool))
        assert int(cnt1[0]) == 0 and (np.asarray(ids1) == 0).all()

    def test_single_spike_corner(self, rng):
        x = np.zeros((5, 7), bool)
        x[4, 6] = True
        pairs, n = binary_2d_pair_stream_encode_p_call(jnp.asarray(x))
        assert int(n[0]) == 1
        np.testing.assert_array_equal(np.asarray(pairs)[0], [4, 6])

    def test_float_events_nonzero_gating(self, rng):
        # encoders gate at != 0 (reference _event/compact.py:81): negative
        # values ARE events here, unlike the >0 product contract.
        x = np.asarray([[0.5, -1.0, 0.0, 2.0]], np.float32)
        (counts,) = binary_2d_csr_row_count_p_call(jnp.asarray(x))
        assert int(counts[0]) == 3

    def test_encoder_backend_parity(self, rng):
        x = jnp.asarray(rng.random((16, 24)) < 0.2)
        for prim, call in (
            (be.events.compact_ops.binary_2d_csr_row_count_p,
             binary_2d_csr_row_count_p_call),
            (be.events.compact_ops.binary_2d_compact_only_p,
             binary_2d_compact_only_p_call),
        ):
            outs = {}
            for backend in prim.available_backends('cpu'):
                outs[backend] = [np.asarray(o) for o in call(x, backend=backend)]
            base = outs.popitem()[1]
            for backend, got in outs.items():
                for a, b in zip(got, base):
                    np.testing.assert_array_equal(a, b, err_msg=backend)
