# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""JIT-connectivity tests: dense-materialization oracles, cross-op
consistency (every op of a family must sample the SAME matrix),
transpose/corder invariants, AD, and the R/C classes
(mirrors reference ``brainevent/_jit_*/**_test.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.jitc import (
    jits, jitsmv, jitsmm, binary_jitsmv, binary_jitsmm, jits_to_csr,
    jitsmv_dt2t, JITCScalarR, JITCScalarC,
    jitn, jitnmv, jitnmm, jitn_to_csr, JITCNormalR,
    jitu, jitumv, jitumm, jitu_to_csr, JITCUniformR,
)

SHAPE = (40, 60)
PROB = 0.15
SEED = 123


@pytest.fixture(scope='module')
def dense_s():
    return np.asarray(jits(1.5, PROB, SEED, shape=SHAPE, corder=True))


class TestConsistency:
    """All ops of a family must draw the same matrix (mv mode)."""

    def test_density(self, dense_s):
        d = (dense_s != 0).mean()
        assert 0.5 * PROB < d < 2.0 * PROB

    def test_mv_matches_dense(self, dense_s, rng):
        v = rng.normal(size=SHAPE[1]).astype(np.float32)
        out = jitsmv(1.5, PROB, jnp.asarray(v), SEED, shape=SHAPE,
                     transpose=False, corder=True)
        np.testing.assert_allclose(np.asarray(out), dense_s @ v,
                                   rtol=1e-4, atol=1e-4)

    def test_transpose_corder_flip_same_matrix(self, dense_s, rng):
        u_vec = rng.normal(size=SHAPE[0]).astype(np.float32)
        out = jitsmv(1.5, PROB, jnp.asarray(u_vec), SEED, shape=SHAPE,
                     transpose=True, corder=False)
        np.testing.assert_allclose(np.asarray(out), dense_s.T @ u_vec,
                                   rtol=1e-4, atol=1e-4)

    def test_corder_false_draws_different_matrix(self, dense_s):
        d2 = np.asarray(jits(1.5, PROB, SEED, shape=SHAPE, corder=False))
        assert not np.array_equal(dense_s, d2)

    def test_binary_mv_gates(self, dense_s, rng):
        spk = rng.random(SHAPE[1]) < 0.3
        out = binary_jitsmv(1.5, PROB, jnp.asarray(spk), SEED, shape=SHAPE,
                            transpose=False, corder=True)
        np.testing.assert_allclose(np.asarray(out),
                                   dense_s @ spk.astype(np.float32),
                                   rtol=1e-4, atol=1e-4)

    def test_to_csr_matches_dense(self, dense_s):
        csr = jits_to_csr(1.5, PROB, SEED, shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(csr.todense()), dense_s,
                                   rtol=1e-5)
        # canonical order: column-sorted within rows
        indptr = np.asarray(csr.indptr)
        indices = np.asarray(csr.indices)
        for r in range(SHAPE[0]):
            seg = indices[indptr[r]:indptr[r + 1]]
            assert (np.diff(seg) > 0).all()

    def test_mm_mode_differs_from_mv_mode(self, dense_s, rng):
        B = rng.normal(size=(SHAPE[1], 4)).astype(np.float32)
        out_mm = jitsmm(1.5, PROB, jnp.asarray(B), SEED, shape=SHAPE,
                        transpose=False, corder=True, matrix_mode='mm')
        # mm-mode samples a different matrix than mv-mode (stride 4 vs 32)
        assert not np.allclose(np.asarray(out_mm), dense_s @ B, atol=1e-3)
        # but mv-mode mm matches the mv dense matrix
        out_mv = jitsmm(1.5, PROB, jnp.asarray(B), SEED, shape=SHAPE,
                        transpose=False, corder=True, matrix_mode='mv')
        np.testing.assert_allclose(np.asarray(out_mv), dense_s @ B,
                                   rtol=1e-4, atol=1e-4)

    def test_dt2t(self, dense_s, rng):
        y = rng.normal(size=SHAPE[0]).astype(np.float32)
        out = jitsmv_dt2t(1.5, PROB, jnp.asarray(y), SEED, shape=SHAPE,
                          corder=True)
        csr = jits_to_csr(1.5, PROB, SEED, shape=SHAPE, corder=True)
        rows = np.repeat(np.arange(SHAPE[0]), np.diff(np.asarray(csr.indptr)))
        np.testing.assert_allclose(np.asarray(out),
                                   np.asarray(csr.data) * y[rows], rtol=1e-5)

    def test_zero_prob_short_circuit(self, rng):
        v = jnp.asarray(rng.normal(size=SHAPE[1]).astype(np.float32))
        out = jitsmv(1.5, 0.0, v, SEED, shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(out), 0.0)


class TestWeightLaws:
    def test_normal_moments(self):
        M = np.asarray(jitn(0.5, 0.2, 0.3, SEED, shape=(200, 200),
                            corder=True))
        nz = M[M != 0]
        assert abs(nz.mean() - 0.5) < 0.02
        assert abs(nz.std() - 0.2) < 0.02

    def test_uniform_range(self):
        M = np.asarray(jitu(1.0, 2.0, 0.3, SEED, shape=(100, 100),
                            corder=True))
        nz = M[M != 0]
        assert nz.min() >= 1.0 and nz.max() <= 2.0
        assert abs(nz.mean() - 1.5) < 0.03

    def test_normal_to_csr_consistent(self, rng):
        M = np.asarray(jitn(0.5, 0.2, PROB, SEED, shape=SHAPE, corder=True))
        csr = jitn_to_csr(0.5, 0.2, PROB, SEED, shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(csr.todense()), M, rtol=1e-5)

    def test_uniform_mv_consistent(self, rng):
        M = np.asarray(jitu(1.0, 2.0, PROB, SEED, shape=SHAPE, corder=True))
        v = rng.normal(size=SHAPE[1]).astype(np.float32)
        out = jitumv(1.0, 2.0, PROB, jnp.asarray(v), SEED, shape=SHAPE,
                     corder=True)
        np.testing.assert_allclose(np.asarray(out), M @ v, rtol=1e-4,
                                   atol=1e-4)


class TestAD:
    def test_grad_wrt_scalar_weight(self, dense_s, rng):
        v = jnp.asarray(rng.normal(size=SHAPE[1]).astype(np.float32))

        def loss(w):
            return jitsmv(w, PROB, v, SEED, shape=SHAPE, corder=True).sum()

        g = jax.grad(loss)(jnp.float32(1.5))
        mask = (dense_s != 0).astype(np.float32) / 1.5 * 1.5
        expect = ((dense_s != 0) @ np.asarray(v)).sum()
        np.testing.assert_allclose(float(g), expect, rtol=1e-3)

    def test_grad_wrt_vector(self, dense_s, rng):
        v = jnp.asarray(rng.normal(size=SHAPE[1]).astype(np.float32))

        def loss(v):
            return jitsmv(1.5, PROB, v, SEED, shape=SHAPE, corder=True).sum()

        g = jax.grad(loss)(v)
        np.testing.assert_allclose(np.asarray(g), dense_s.sum(0), rtol=1e-3,
                                   atol=1e-3)

    def test_grad_normal_params(self, rng):
        v = jnp.asarray(rng.normal(size=SHAPE[1]).astype(np.float32))
        M_mask = np.asarray(jitn(1.0, 0.0, PROB, SEED, shape=SHAPE,
                                 corder=True))  # pure mask
        M_z = np.asarray(jitn(0.0, 1.0, PROB, SEED, shape=SHAPE,
                              corder=True))     # pure z*mask

        def loss(wl, ws):
            return jitnmv(wl, ws, PROB, v, SEED, shape=SHAPE,
                          corder=True).sum()

        gl, gs = jax.grad(loss, argnums=(0, 1))(jnp.float32(0.5),
                                                jnp.float32(0.2))
        np.testing.assert_allclose(float(gl), (M_mask @ np.asarray(v)).sum(),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(gs), (M_z @ np.asarray(v)).sum(),
                                   rtol=1e-3)

    def test_vmap_reroutes_to_mm_mode(self, rng):
        # NOTE inherited contract: vmap of mv uses the mm-mode matrix
        V = jnp.asarray(rng.normal(size=(3, SHAPE[1])).astype(np.float32))
        out = jax.vmap(lambda v: jitsmv(1.5, PROB, v, SEED, shape=SHAPE,
                                        corder=True))(V)
        assert out.shape == (3, SHAPE[0])


class TestClasses:
    def test_R_roundtrip(self, dense_s, rng):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(m.todense()), dense_s)
        v = rng.normal(size=SHAPE[1]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(m @ jnp.asarray(v)),
                                   dense_s @ v, rtol=1e-4, atol=1e-4)
        u_vec = rng.normal(size=SHAPE[0]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(jnp.asarray(u_vec) @ m),
                                   u_vec @ dense_s, rtol=1e-4, atol=1e-4)

    def test_transpose_R_to_C(self, dense_s, rng):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        mt = m.T
        assert isinstance(mt, JITCScalarC) and mt.shape == (SHAPE[1], SHAPE[0])
        np.testing.assert_allclose(np.asarray(mt.todense()), dense_s.T)
        v = rng.normal(size=SHAPE[0]).astype(np.float32)
        np.testing.assert_allclose(np.asarray(mt @ jnp.asarray(v)),
                                   dense_s.T @ v, rtol=1e-4, atol=1e-4)
        back = mt.T
        assert isinstance(back, JITCScalarR)
        np.testing.assert_allclose(np.asarray(back.todense()), dense_s)

    def test_event_matmul(self, dense_s, rng):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        spk = rng.random(SHAPE[1]) < 0.3
        out = m @ be.BinaryArray(jnp.asarray(spk))
        np.testing.assert_allclose(np.asarray(out),
                                   dense_s @ spk.astype(np.float32),
                                   rtol=1e-4, atol=1e-4)

    def test_scalar_algebra(self):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE)
        m2 = (m * 2.0)
        assert float(m2.weight) == pytest.approx(3.0)
        m3 = -m
        assert float(m3.weight) == pytest.approx(-1.5)

    def test_normal_algebra_shifts_loc_only(self):
        m = JITCNormalR((0.5, 0.2, PROB, SEED), shape=SHAPE)
        m2 = m + 1.0
        assert float(m2.wloc) == pytest.approx(1.5)
        assert float(m2.wscale) == pytest.approx(0.2)
        m3 = m * 2.0
        assert float(m3.wscale) == pytest.approx(0.4)

    def test_uniform_negation_exact(self):
        m = JITCUniformR((1.0, 2.0, PROB, SEED), shape=(30, 30), corder=True)
        np.testing.assert_allclose(np.asarray((-m).todense()),
                                   -np.asarray(m.todense()), rtol=1e-6)

    def test_tocsr_tocsc(self, dense_s):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(m.tocsr().todense()), dense_s,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(m.tocsc().todense()), dense_s,
                                   rtol=1e-5)

    def test_C_tocsr(self, dense_s):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        c = m.T
        np.testing.assert_allclose(np.asarray(c.tocsr().todense()),
                                   dense_s.T, rtol=1e-5)

    def test_mode_views(self):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        d_mv = np.asarray(m.mv.todense())
        d_mm = np.asarray(m.mm.todense())
        assert not np.array_equal(d_mv, d_mm)  # different strides
        np.testing.assert_allclose(d_mv, np.asarray(m.todense()))

    def test_pytree_jit(self, dense_s, rng):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        v = jnp.asarray(rng.normal(size=SHAPE[1]).astype(np.float32))
        out = jax.jit(lambda mat, vv: mat @ vv)(m, v)
        np.testing.assert_allclose(np.asarray(out),
                                   dense_s @ np.asarray(v),
                                   rtol=1e-4, atol=1e-4)

    def test_dt2t_method(self, rng):
        m = JITCScalarR((1.5, PROB, SEED), shape=SHAPE, corder=True)
        y = rng.normal(size=SHAPE[0]).astype(np.float32)
        out = m.dt2t(jnp.asarray(y))
        csr = m.tocsr()
        rows = np.repeat(np.arange(SHAPE[0]), np.diff(np.asarray(csr.indptr)))
        np.testing.assert_allclose(np.asarray(out),
                                   np.asarray(csr.data) * y[rows], rtol=1e-5)


class TestMMOps:
    def test_jitsmm_mv_mode_oracle(self, dense_s, rng):
        B = rng.normal(size=(SHAPE[1], 5)).astype(np.float32)
        out = jitsmm(1.5, PROB, jnp.asarray(B), SEED, shape=SHAPE,
                     corder=True, matrix_mode='mv')
        np.testing.assert_allclose(np.asarray(out), dense_s @ B,
                                   rtol=1e-4, atol=1e-4)

    def test_binary_jitsmm(self, rng):
        from brainevent_tpu.jitc import binary_jitsmm, jits
        # mm-mode dense oracle
        M = np.asarray(jits(1.5, PROB, SEED, shape=SHAPE, corder=True,
                            matrix_mode='mm'))
        S = rng.random((SHAPE[1], 4)) < 0.3
        out = binary_jitsmm(1.5, PROB, jnp.asarray(S), SEED, shape=SHAPE,
                            corder=True, matrix_mode='mm')
        np.testing.assert_allclose(np.asarray(out),
                                   M @ S.astype(np.float32),
                                   rtol=1e-4, atol=1e-4)

    def test_jitnmm_transpose(self, rng):
        from brainevent_tpu.jitc import jitn, jitnmm
        M = np.asarray(jitn(0.5, 0.2, PROB, SEED, shape=SHAPE, corder=True,
                            matrix_mode='mm'))
        B = rng.normal(size=(SHAPE[0], 3)).astype(np.float32)
        # transpose=True with corder flip draws the same matrix transposed
        out = jitnmm(0.5, 0.2, PROB, jnp.asarray(B), SEED, shape=SHAPE,
                     transpose=True, corder=False, matrix_mode='mm')
        # corder=False + transpose=True walks out=shape[1], in=shape[0];
        # this is a DIFFERENT matrix from M (mm-mode contract) -- just
        # check shape/finite
        assert out.shape == (SHAPE[1], 3)
        assert np.isfinite(np.asarray(out)).all()

    def test_grad_through_mm(self, rng):
        from brainevent_tpu.jitc import jitsmm
        B = jnp.asarray(rng.normal(size=(SHAPE[1], 3)).astype(np.float32))

        def loss(w):
            return jitsmm(w, PROB, B, SEED, shape=SHAPE, corder=True).sum()

        g = jax.grad(loss)(jnp.float32(1.5))
        assert np.isfinite(float(g)) and float(g) != 0


class TestCompactFromPacked:
    def test_from_packed_roundtrip(self, rng):
        import brainevent_tpu as be
        x = rng.random(40) < 0.3
        cb = be.CompactBinary.from_array(jnp.asarray(x))
        cb2 = be.CompactBinary.from_packed(
            cb.packed, cb.active_ids, cb.n_active, cb.value)
        assert cb2.n_orig == 40
        np.testing.assert_array_equal(np.asarray(cb2.to_dense()), x)


class TestDt2tPrimitive:
    """The fused ``jit{s,n,u}mv_dt2t`` primitives (VERDICT r2 item 5):
    in-kernel weight regeneration, no CSR materialization, oracle = the
    to_csr-composed path (reference ``brainevent/_jit_normal/dt2t.py``)."""

    FAMS = [
        ('s', (1.5,)),
        ('n', (0.5, 0.2)),
        ('u', (1.0, 2.0)),
    ]

    @pytest.mark.parametrize('tag,params', FAMS)
    @pytest.mark.parametrize('transpose', [False, True])
    @pytest.mark.parametrize('corder', [True, False])
    def test_matches_to_csr_oracle(self, tag, params, transpose, corder, rng):
        to_csr = getattr(be, f'jit{tag}_to_csr')
        dt2t = getattr(be, f'jit{tag}mv_dt2t')
        csr = to_csr(*params, PROB, SEED, shape=SHAPE, corder=corder,
                     matrix_mode='mv')
        y_len = SHAPE[1] if transpose else SHAPE[0]
        y = jnp.asarray(rng.normal(size=y_len).astype(np.float32))
        out = dt2t(*params, PROB, y, SEED, shape=SHAPE,
                   transpose=transpose, corder=corder)
        nnz = int(csr.indptr[-1])
        assert out.shape == (nnz,)
        indices = np.asarray(csr.indices)
        if transpose:
            gathered = np.asarray(y)[indices]
        else:
            rows = np.repeat(np.arange(SHAPE[0]),
                             np.diff(np.asarray(csr.indptr)))
            gathered = np.asarray(y)[rows]
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(csr.data) * gathered,
            rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize('tag,params', FAMS)
    def test_p_call_is_jittable(self, tag, params, rng):
        """With a static nse, the primitive itself runs under jit
        (the reference's primitive contract: nnz passed in)."""
        from brainevent_tpu._misc import _initialize_conn_length
        fam = {'s': be.jitc.scalar, 'n': be.jitc.normal,
               'u': be.jitc.uniform}[tag]
        p_call = getattr(fam, f'jit{tag}mv_dt2t_p')._call_fn
        count_p = getattr(fam, f'jit{tag}_csr_count_p')._call_fn
        clen = _initialize_conn_length(PROB)
        (counts,) = count_p(*params, clen, SEED, shape=SHAPE, corder=True,
                            matrix_mode='mv')
        nse = int(np.sum(np.asarray(counts)))
        y = jnp.asarray(rng.normal(size=SHAPE[0]).astype(np.float32))

        jitted = jax.jit(lambda yy: p_call(
            *params, clen, yy, SEED, nse=nse, shape=SHAPE,
            transpose=False, corder=True))
        (out,) = jitted(y)
        ref = getattr(be, f'jit{tag}mv_dt2t')(
            *params, PROB, y, SEED, shape=SHAPE, corder=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-6)

    def test_registered_primitives(self):
        reg = be.get_registry()
        for tag in 'snu':
            assert f'jit{tag}mv_dt2t' in reg, (
                f'jit{tag}mv_dt2t missing from the registry '
                '(the last 3 reference primitive names, SURVEY 2.10)')

    def test_zero_prob_returns_empty(self):
        out = be.jitnmv_dt2t(0.5, 0.2, 0.0, jnp.ones(SHAPE[0]), SEED,
                             shape=SHAPE)
        assert out.shape == (0,)


class TestWalkAgainstDense:
    """The XLA walk engine behind every JITC product must sample the same
    matrix as the materializer: each product equals the materialized
    matrix times the operand (only f32 summation order may differ), and
    the materializer equals the separately collected CSR form. The
    transposed product of ``(corder)`` is ``M.T`` of the ``(not corder)``
    matrix (transpose and corder flip together)."""

    _DENSE = {jitsmv: be.jits, jitnmv: be.jitn, jitumv: be.jitu,
              jitsmm: be.jits, jitnmm: be.jitn, jitumm: be.jitu}

    @staticmethod
    def _matrix(dense_fn, params, shape, transpose=False, corder=True,
                matrix_mode='mv', prob=PROB):
        if transpose:
            return np.asarray(dense_fn(
                *params, prob, SEED, shape=shape, corder=not corder,
                matrix_mode=matrix_mode), np.float64).T
        return np.asarray(dense_fn(*params, prob, SEED, shape=shape,
                                   corder=corder, matrix_mode=matrix_mode),
                          np.float64)

    @pytest.mark.parametrize('fn,params', [
        (jitsmv, (1.5,)),
        (jitnmv, (0.5, 0.2)),
        (jitumv, (0.1, 0.9)),
    ])
    @pytest.mark.parametrize('corder', [True, False])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_mv_matches_todense(self, fn, params, corder, transpose, rng):
        shape = (57, 83)
        in_len = shape[0] if transpose else shape[1]
        v = rng.normal(size=in_len).astype(np.float32)
        got = fn(*params, PROB, jnp.asarray(v), SEED, shape=shape,
                 transpose=transpose, corder=corder)
        want = self._matrix(self._DENSE[fn], params, shape, transpose,
                            corder) @ v
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('corder', [True, False])
    def test_binary_mv_matches_todense(self, corder, rng):
        from brainevent_tpu.jitc import binary_jitnmv
        shape = (64, 50)
        spk = rng.random(shape[1]) < 0.3
        got = binary_jitnmv(0.5, 0.2, PROB, jnp.asarray(spk), SEED,
                            shape=shape, corder=corder)
        want = self._matrix(be.jitn, (0.5, 0.2), shape, corder=corder) @ spk
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    def test_non_divisible_rows_and_cols(self, rng):
        # cols not a multiple of the 32-lane stride or the chunk layout
        shape = (301, 261)
        v = rng.normal(size=shape[1]).astype(np.float32)
        got = jitnmv(0.5, 0.2, PROB, jnp.asarray(v), SEED, shape=shape)
        want = self._matrix(be.jitn, (0.5, 0.2), shape) @ v
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('fn,params,to_csr', [
        (be.jits, (1.5,), be.jits_to_csr),
        (be.jitn, (0.5, 0.2), be.jitn_to_csr),
        (be.jitu, (0.1, 0.9), be.jitu_to_csr),
    ])
    @pytest.mark.parametrize('corder', [True, False])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_todense_matches_csr(self, fn, params, to_csr, corder,
                                 transpose):
        # materialize is exact (a plain store of the same weight draws);
        # transpose=True materializes the walk over the swapped shape
        shape = (57, 83)
        walked = (shape[1], shape[0]) if transpose else shape
        got = fn(*params, PROB, SEED, shape=shape, transpose=transpose,
                 corder=corder)
        want = to_csr(*params, PROB, SEED, shape=walked,
                      corder=corder).todense()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_todense_non_divisible(self):
        got = be.jitn(0.5, 0.2, PROB, SEED, shape=(301, 261))
        want = be.jitn_to_csr(0.5, 0.2, PROB, SEED,
                              shape=(301, 261)).todense()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    @pytest.mark.parametrize('fn,params', [
        (jitsmm, (1.5,)),
        (jitnmm, (0.5, 0.2)),
        (jitumm, (0.1, 0.9)),
    ])
    @pytest.mark.parametrize('corder', [True, False])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_mm_mv_mode_matches_todense(self, fn, params, corder, transpose,
                                        rng):
        # stride-32 'mv' layout (the classes' @ route); n_batch=5
        shape = (57, 83)
        in_len = shape[0] if transpose else shape[1]
        B = rng.normal(size=(in_len, 5)).astype(np.float32)
        got = fn(*params, PROB, jnp.asarray(B), SEED, shape=shape,
                 transpose=transpose, corder=corder, matrix_mode='mv')
        want = self._matrix(self._DENSE[fn], params, shape, transpose,
                            corder) @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    def test_mm_wide_batch(self, rng):
        B = rng.normal(size=(SHAPE[1], 19)).astype(np.float32)
        got = jitnmm(0.5, 0.2, PROB, jnp.asarray(B), SEED, shape=SHAPE,
                     matrix_mode='mv')
        want = self._matrix(be.jitn, (0.5, 0.2), SHAPE) @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('corder', [True, False])
    def test_binary_mm_mv_mode_matches_todense(self, corder, rng):
        from brainevent_tpu.jitc import binary_jitnmm
        B = rng.random((SHAPE[1], 6)) < 0.3
        got = binary_jitnmm(0.5, 0.2, PROB, jnp.asarray(B), SEED,
                            shape=SHAPE, corder=corder, matrix_mode='mv')
        want = self._matrix(be.jitn, (0.5, 0.2), SHAPE, corder=corder) @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('fn,params', [
        (jitsmm, (1.5,)),
        (jitnmm, (0.5, 0.2)),
        (jitumm, (0.1, 0.9)),
    ])
    @pytest.mark.parametrize('corder', [True, False])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_mm_stride4_matches_todense(self, fn, params, corder,
                                        transpose, rng):
        # matrix_mode='mm' (stride-4 walk) against the mm-mode matrix
        shape = (57, 83)
        in_len = shape[0] if transpose else shape[1]
        B = rng.normal(size=(in_len, 5)).astype(np.float32)
        got = fn(*params, PROB, jnp.asarray(B), SEED, shape=shape,
                 transpose=transpose, corder=corder, matrix_mode='mm')
        want = self._matrix(self._DENSE[fn], params, shape, transpose,
                            corder, matrix_mode='mm') @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('corder', [True, False])
    @pytest.mark.parametrize('transpose', [False, True])
    def test_todense_mm_stride4_matches_csr(self, corder, transpose):
        shape = (57, 83)
        walked = (shape[1], shape[0]) if transpose else shape
        got = be.jitn(0.5, 0.2, PROB, SEED, shape=shape,
                      transpose=transpose, corder=corder, matrix_mode='mm')
        want = be.jitn_to_csr(0.5, 0.2, PROB, SEED, shape=walked,
                              corder=corder, matrix_mode='mm').todense()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_mm_stride4_non_divisible(self, rng):
        shape = (301, 261)
        B = rng.normal(size=(shape[1], 19)).astype(np.float32)
        got = jitnmm(0.5, 0.2, PROB, jnp.asarray(B), SEED, shape=shape,
                     matrix_mode='mm')
        want = self._matrix(be.jitn, (0.5, 0.2), shape,
                            matrix_mode='mm') @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize('corder', [True, False])
    def test_binary_mm_stride4_matches_todense(self, corder, rng):
        from brainevent_tpu.jitc import binary_jitnmm
        B = rng.random((SHAPE[1], 6)) < 0.3
        got = binary_jitnmm(0.5, 0.2, PROB, jnp.asarray(B), SEED,
                            shape=SHAPE, corder=corder, matrix_mode='mm')
        want = self._matrix(be.jitn, (0.5, 0.2), SHAPE, corder=corder,
                            matrix_mode='mm') @ B
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    def test_walk_plan_setup_is_the_walk_setup(self):
        # the plan primitives' hoisted setup is the engine's own stream
        # initialization, reshaped to (rows, n_chunks * stride)
        from brainevent_tpu._misc import (_initialize_conn_length,
                                          _normalize_chunk_size)
        from brainevent_tpu.jitc import engine
        shape = (57, 83)
        clen = _initialize_conn_length(PROB)
        chunk = _normalize_chunk_size(shape[1], None)
        state2, q2, cl = engine.walk_plan_setup(SEED, clen, shape[0],
                                                shape[1], 32, chunk)
        _, _, _, state, q, cl0 = engine.walk_setup(SEED, clen, shape[0],
                                                   shape[1], 32, chunk)
        n_chunks = -(-shape[1] // chunk)
        assert state2.shape == q2.shape == (shape[0], n_chunks * 32)
        np.testing.assert_array_equal(np.asarray(state2),
                                      np.asarray(state).reshape(state2.shape))
        np.testing.assert_array_equal(np.asarray(q2),
                                      np.asarray(q).reshape(q2.shape))
        assert int(cl) == int(cl0)

    def test_x64_matches_todense(self, rng):
        import contextlib

        @contextlib.contextmanager
        def x64_enabled():
            old = jax.config.jax_enable_x64
            jax.config.update('jax_enable_x64', True)
            try:
                yield
            finally:
                jax.config.update('jax_enable_x64', old)

        with x64_enabled():
            v = rng.normal(size=SHAPE[1])
            got = jitnmv(np.float64(0.5), np.float64(0.2), PROB,
                         jnp.asarray(v, jnp.float64), SEED, shape=SHAPE)
            dense = np.asarray(be.jitn(np.float64(0.5), np.float64(0.2),
                                       PROB, SEED, shape=SHAPE))
            assert np.asarray(got).dtype == np.float64
            np.testing.assert_allclose(np.asarray(got), dense @ v,
                                       rtol=1e-12)

    @pytest.mark.parametrize('transpose', [False, True])
    def test_grad_matches_dense_formulation(self, transpose, rng):
        # the JVP/transpose rules against jax.grad of materialize-then-dot
        in_len = SHAPE[0] if transpose else SHAPE[1]
        v = jnp.asarray(rng.normal(size=in_len), jnp.float32)

        def loss(args):
            loc, scale, vv = args
            return jnp.sum(jitnmv(loc, scale, PROB, vv, SEED, shape=SHAPE,
                                  transpose=transpose) ** 2)

        def loss_dense(args):
            loc, scale, vv = args
            if transpose:
                m = be.jitn(loc, scale, PROB, SEED, shape=SHAPE,
                            corder=False).T
            else:
                m = be.jitn(loc, scale, PROB, SEED, shape=SHAPE)
            with jax.default_matmul_precision('highest'):
                return jnp.sum((m @ vv) ** 2)

        args = (jnp.float32(0.5), jnp.float32(0.2), v)
        for g, r in zip(jax.grad(loss)(args), jax.grad(loss_dense)(args)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=2e-4, atol=2e-5)

    def test_vmap_over_operand(self, rng):
        # vmap of mv reroutes to mm MODE (different matrix by contract,
        # see TestAD.test_vmap_reroutes_to_mm_mode)
        V = rng.normal(size=(3, SHAPE[1])).astype(np.float32)
        got = jax.vmap(lambda vv: jitnmv(
            0.5, 0.2, PROB, vv, SEED, shape=SHAPE))(jnp.asarray(V))
        want = V @ self._matrix(be.jitn, (0.5, 0.2), SHAPE,
                                matrix_mode='mm').T
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)

    def test_jit_composes(self, rng):
        v = rng.normal(size=SHAPE[1]).astype(np.float32)
        f = jax.jit(lambda vv: jitnmv(0.5, 0.2, PROB, vv, SEED,
                                      shape=SHAPE))
        want = self._matrix(be.jitn, (0.5, 0.2), SHAPE) @ v
        np.testing.assert_allclose(np.asarray(f(jnp.asarray(v))), want,
                                   rtol=2e-5, atol=2e-5)

    def test_wide_matrix_many_chunks(self, rng):
        # wide logical cols -> chunk_size keyed on shape[1]
        shape = (48, 1030)
        v = rng.normal(size=shape[1]).astype(np.float32)
        for corder in (True, False):
            got = jitsmv(1.5, 0.05, jnp.asarray(v), SEED, shape=shape,
                         corder=corder)
            want = self._matrix(be.jits, (1.5,), shape, corder=corder,
                                prob=0.05) @ v
            np.testing.assert_allclose(np.asarray(got), want,
                                       rtol=2e-5, atol=2e-5)

    def test_prob_near_one_dense_limit(self, rng):
        # clen ~= 2/prob ~= 2 -> every skip is >= 1; near-dense sampling
        v = rng.normal(size=40).astype(np.float32)
        got = jitnmv(0.1, 0.3, 0.9, jnp.asarray(v), SEED, shape=(32, 40))
        want = self._matrix(be.jitn, (0.1, 0.3), (32, 40), prob=0.9) @ v
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=2e-5, atol=2e-5)
