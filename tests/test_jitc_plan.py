# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Walk-plan primitive tests (an extension, no reference counterpart).

``jit*mv_plan`` / ``jit*mm_plan`` compute the SAME product as
``jit*mv`` with the stationary-q stream setup passed in as operands. The
stream-equality contract is structural: the ``jax_raw`` backend ignores
the passed setup and recomputes it internally."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brainevent_tpu import BinaryArray
from brainevent_tpu.jitc import (
    JITCNormalR, JITCScalarR, JITCUniformR,
    jitnmv, jitnmv_plan, jitnmm_plan,
)
from brainevent_tpu.jitc import normal as _normal
from brainevent_tpu.jitc import scalar as _scalar
from brainevent_tpu.jitc import uniform as _uniform

SHAPE = (52, 37)
PROB = 0.15
SEED = 123

FAMILIES = {
    's': (_scalar._family, (1.5,)),
    'n': (_normal._family, (1.5, 0.3)),
    'u': (_uniform._family, (0.5, 2.0)),
}


def _params(vals):
    return tuple(jnp.full((1,), v, jnp.float32) for v in vals)


@pytest.mark.parametrize('tag', list(FAMILIES))
@pytest.mark.parametrize('transpose', [False, True])
@pytest.mark.parametrize('corder', [True, False])
def test_plan_matches_unplanned_mv(tag, transpose, corder, rng):
    """Plan product == per-call product (same sampled matrix)."""
    fam, vals = FAMILIES[tag]
    seed = jnp.asarray([SEED], jnp.uint32)
    clen, s2, q2, cl = fam.build_plan_setup(
        PROB, seed, SHAPE, transpose=transpose, corder=corder)
    in_len = SHAPE[0] if transpose else SHAPE[1]
    v = jnp.asarray(rng.normal(size=in_len), jnp.float32)
    want = fam.mv_fn(*vals, PROB, v, SEED, shape=SHAPE,
                     transpose=transpose, corder=corder)
    got = fam.plan_mv_fn(*_params(vals), clen, v, seed, s2, q2, cl,
                         shape=SHAPE, transpose=transpose, corder=corder)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('tag', list(FAMILIES))
@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_plan_dispatch_sweep(tag, mode, rng):
    """The plan product eagerly and under jit equals the unplanned one."""
    fam, vals = FAMILIES[tag]
    seed = jnp.asarray([SEED], jnp.uint32)
    clen, s2, q2, cl = fam.build_plan_setup(PROB, seed, SHAPE)
    v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
    want = fam.mv_fn(*vals, PROB, v, SEED, shape=SHAPE)

    def plan(vv):
        return fam.plan_mv_fn(*_params(vals), clen, vv, seed, s2, q2, cl,
                              shape=SHAPE)

    got = jax.jit(plan)(v) if mode == 'jit' else plan(v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_plan_mm_is_columnwise_mv(mode, rng):
    """Plan mm is mode-locked to the mv walk: each column sees the
    SAME mv-mode matrix."""
    fam, vals = FAMILIES['n']
    seed = jnp.asarray([SEED], jnp.uint32)
    clen, s2, q2, cl = fam.build_plan_setup(PROB, seed, SHAPE)
    B = jnp.asarray(rng.normal(size=(SHAPE[1], 5)), jnp.float32)
    def plan_mm(b):
        return fam.plan_mm_fn(*_params(vals), clen, b, seed, s2, q2, cl,
                              shape=SHAPE)

    got = jax.jit(plan_mm)(B) if mode == 'jit' else plan_mm(B)
    cols = jnp.stack([
        fam.plan_mv_fn(*_params(vals), clen, B[:, i], seed, s2, q2, cl,
                       shape=SHAPE)
        for i in range(B.shape[1])], axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(cols),
                               rtol=1e-4, atol=1e-4)


def test_plan_event_gating(rng):
    fam, vals = FAMILIES['n']
    seed = jnp.asarray([SEED], jnp.uint32)
    clen, s2, q2, cl = fam.build_plan_setup(PROB, seed, SHAPE)
    spk = rng.random(SHAPE[1]) < 0.3
    want = fam.bmv_fn(*vals, PROB, jnp.asarray(spk), SEED, shape=SHAPE)
    got = fam.plan_mv_fn(*_params(vals), clen, jnp.asarray(spk), seed,
                         s2, q2, cl, shape=SHAPE, event=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


class TestWalkPlanClass:
    """``build_walk_plan`` on the R/C classes."""

    @pytest.mark.parametrize('cls,vals', [
        (JITCScalarR, (1.5,)),
        (JITCNormalR, (1.5, 0.3)),
        (JITCUniformR, (0.5, 2.0)),
    ])
    def test_matmul_matches_matrix(self, cls, vals, rng):
        M = cls((*vals, PROB, SEED), shape=SHAPE)
        plan = M.build_walk_plan()
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        np.testing.assert_allclose(np.asarray(plan @ v),
                                   np.asarray(M @ v),
                                   rtol=1e-4, atol=1e-4)
        u = jnp.asarray(rng.normal(size=SHAPE[0]), jnp.float32)
        np.testing.assert_allclose(np.asarray(u @ plan),
                                   np.asarray(u @ M),
                                   rtol=1e-4, atol=1e-4)

    def test_c_class_plan(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        C = M.transpose()
        plan = C.build_walk_plan()
        u = jnp.asarray(rng.normal(size=SHAPE[0]), jnp.float32)
        np.testing.assert_allclose(np.asarray(plan @ u),
                                   np.asarray(C @ u),
                                   rtol=1e-4, atol=1e-4)

    def test_event_input(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        plan = M.build_walk_plan()
        spk = BinaryArray(jnp.asarray(rng.random(SHAPE[1]) < 0.3))
        np.testing.assert_allclose(np.asarray(plan @ spk),
                                   np.asarray(M @ spk),
                                   rtol=1e-4, atol=1e-4)

    def test_plan_shape_property(self):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        assert M.build_walk_plan().shape == SHAPE
        assert M.transpose().build_walk_plan().shape == (SHAPE[1], SHAPE[0])

    def test_plan_is_jit_pytree(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        plan = M.build_walk_plan()
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)

        @jax.jit
        def step(p, vv):
            return p @ vv

        np.testing.assert_allclose(np.asarray(step(plan, v)),
                                   np.asarray(M @ v),
                                   rtol=1e-4, atol=1e-4)

    def test_rmatmul_2d(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        plan = M.build_walk_plan()
        U = jnp.asarray(rng.normal(size=(3, SHAPE[0])), jnp.float32)
        want = jnp.stack([U[i] @ M for i in range(3)])
        np.testing.assert_allclose(np.asarray(U @ plan), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


class TestPlanAD:
    """AD through the plan primitives reuses the plan setup (the
    cotangent product flips (transpose, corder) together, preserving
    the walk geometry)."""

    def test_operand_grad_matches_unplanned(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        plan = M.build_walk_plan()
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        g_plan = jax.grad(lambda vv: jnp.sum(jnp.sin(plan @ vv)))(v)
        g_ref = jax.grad(lambda vv: jnp.sum(jnp.sin(M @ vv)))(v)
        np.testing.assert_allclose(np.asarray(g_plan), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-4)

    def test_param_grad_matches_unplanned(self, rng):
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)

        def via_plan(wloc):
            M = JITCNormalR((wloc, 0.3, PROB, SEED), shape=SHAPE)
            return jnp.sum((M.build_walk_plan() @ v) ** 2)

        def direct(wloc):
            M = JITCNormalR((wloc, 0.3, PROB, SEED), shape=SHAPE)
            return jnp.sum((M @ v) ** 2)

        g1 = jax.grad(via_plan)(1.5)
        g0 = jax.grad(direct)(1.5)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                                   rtol=1e-4)

    def test_jvp_operand(self, rng):
        fam, vals = FAMILIES['n']
        seed = jnp.asarray([SEED], jnp.uint32)
        clen, s2, q2, cl = fam.build_plan_setup(PROB, seed, SHAPE)
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        t = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)

        def f(vv):
            return fam.plan_mv_fn(*_params(vals), clen, vv, seed,
                                  s2, q2, cl, shape=SHAPE)

        _, tangent = jax.jvp(f, (v,), (t,))
        np.testing.assert_allclose(np.asarray(tangent), np.asarray(f(t)),
                                   rtol=1e-4, atol=1e-4)


def test_registry_has_plan_primitives():
    from brainevent_tpu._registry import get_all_primitive_names
    names = set(get_all_primitive_names())
    for tag in 'snu':
        assert f'jit{tag}mv_plan' in names
        assert f'jit{tag}mm_plan' in names


class TestEventCompactedRoute:
    """The event-compacted scatter route (jitc/event_route.py): active
    rows' plan streams walk a static round budget; overflow/residual
    falls back to the exact full product under lax.cond."""

    @pytest.mark.parametrize('rate', [0.0, 0.02, 0.3])
    def test_matches_unplanned(self, rate, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE, corder=True)
        plan = M.build_walk_plan()
        assert plan.scan_rounds is not None and plan.scan_rounds >= 1
        spk = BinaryArray(jnp.asarray(rng.random(SHAPE[0]) < rate))
        np.testing.assert_allclose(np.asarray(spk @ plan),
                                   np.asarray(spk @ M),
                                   rtol=1e-4, atol=1e-4)

    def test_residual_fallback_exact(self, rng):
        """scan_rounds=1 under a dense walk forces the residual path."""
        M = JITCNormalR((1.5, 0.3, 0.5, SEED), shape=SHAPE, corder=True)
        plan = M.build_walk_plan()
        plan.scan_rounds = 1
        spk = BinaryArray(jnp.asarray(rng.random(SHAPE[0]) < 0.4))
        np.testing.assert_allclose(np.asarray(spk @ plan),
                                   np.asarray(spk @ M),
                                   rtol=1e-4, atol=1e-4)

    def test_capacity_overflow_fallback_exact(self):
        """All rows active exceeds event_capacity -> exact fallback."""
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=(300, 200),
                        corder=True)
        plan = M.build_walk_plan()
        spk = BinaryArray(jnp.ones(300, bool))
        np.testing.assert_allclose(np.asarray(spk @ plan),
                                   np.asarray(spk @ M),
                                   rtol=1e-4, atol=1e-4)

    def test_scan_rounds_none_for_traced_prob(self):
        M = JITCNormalR((1.5, 0.3, jnp.float32(PROB), SEED), shape=SHAPE,
                        corder=True)
        assert M.build_walk_plan().scan_rounds is None

    @pytest.mark.parametrize('tag', list(FAMILIES))
    def test_explicit_scan_rounds_all_families(self, tag, rng):
        fam, vals = FAMILIES[tag]
        seed = jnp.asarray([SEED], jnp.uint32)
        clen, s2, q2, cl = fam.build_plan_setup(
            PROB, seed, SHAPE, transpose=True, corder=False)
        spk = jnp.asarray(rng.random(SHAPE[0]) < 0.1)
        want = fam.bmv_fn(*vals, PROB, spk, SEED, shape=SHAPE,
                          transpose=True, corder=False)
        got = fam.plan_mv_fn(*_params(vals), clen, spk, seed, s2, q2, cl,
                             shape=SHAPE, transpose=True, corder=False,
                             event=True, scan_rounds=6)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def test_default_scan_rounds_monotone(self):
        from brainevent_tpu.jitc.event_route import default_scan_rounds
        r_sparse = default_scan_rounds(0.001, 20000, 256000)
        r_dense = default_scan_rounds(0.3, 20000, 256000)
        assert 1 <= r_sparse <= r_dense <= 64


class TestAutoPlan:
    """Transparent walk-plan caching on the classes
    (``config.set_jitc_auto_plan``): ``M @ v`` builds the plan once on
    the first concrete 1-D product and reuses it after."""

    @pytest.fixture(autouse=True)
    def _restore(self):
        from brainevent_tpu import config
        before = config.get_jitc_auto_plan()
        yield
        config.set_jitc_auto_plan(before)

    def _direct(self, fn):
        """Evaluate *fn* with the auto-plan route off."""
        from brainevent_tpu import config
        config.set_jitc_auto_plan(False)
        out = fn()
        config.set_jitc_auto_plan(True)
        return out

    @pytest.mark.parametrize('cls,vals', [
        (JITCScalarR, (1.5,)),
        (JITCNormalR, (1.5, 0.3)),
        (JITCUniformR, (0.5, 2.0)),
    ])
    def test_all_orientations_match_direct(self, cls, vals, rng):
        M = cls((*vals, PROB, SEED), shape=SHAPE)
        C = M.transpose()
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        u = jnp.asarray(rng.normal(size=SHAPE[0]), jnp.float32)
        for planned, direct in [
            (lambda: M @ v, lambda: M @ v),
            (lambda: u @ M, lambda: u @ M),
            (lambda: C @ u, lambda: C @ u),
            (lambda: v @ C, lambda: v @ C),
        ]:
            np.testing.assert_allclose(
                np.asarray(planned()), np.asarray(self._direct(direct)),
                rtol=1e-4, atol=1e-4)

    def test_cache_built_once(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        assert M._plan_cache is None
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        _ = M @ v
        plan = M._plan_cache
        assert plan is not None
        _ = jnp.zeros(SHAPE[0], jnp.float32) @ M
        assert M._plan_cache is plan  # reused, not rebuilt

    def test_2d_operand_bypasses_plan(self, rng):
        # matrix @ B samples the mm-mode matrix: must NOT reuse the
        # mv-mode plan
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        B = jnp.asarray(rng.normal(size=(SHAPE[1], 3)), jnp.float32)
        got = M @ B
        assert M._plan_cache is None
        want = self._direct(lambda: M @ B)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def test_traced_matrix_falls_back(self, rng):
        # matrix passed as a jit argument -> tracer leaves -> direct
        # route (a traced plan build would inline the setup into the
        # jaxpr, the exact cost the plan avoids)
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)

        @jax.jit
        def step(m, vv):
            return m @ vv

        np.testing.assert_allclose(np.asarray(step(M, v)),
                                   np.asarray(self._direct(lambda: M @ v)),
                                   rtol=1e-4, atol=1e-4)

    def test_disabled_returns_no_plan(self, rng):
        from brainevent_tpu import config
        config.set_jitc_auto_plan(False)
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        v = jnp.asarray(rng.normal(size=SHAPE[1]), jnp.float32)
        _ = M @ v
        assert M._plan_cache is None

    def test_event_operand_routes_through_plan(self, rng):
        M = JITCNormalR((1.5, 0.3, PROB, SEED), shape=SHAPE)
        spk = BinaryArray(jnp.asarray(rng.random(SHAPE[1]) < 0.3))
        got = M @ spk
        assert M._plan_cache is not None
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(self._direct(lambda: M @ spk)),
                                   rtol=1e-4, atol=1e-4)
