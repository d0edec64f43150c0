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

"""The tiered event-route tail, sort-based compaction, the row-id cumsum
formulation, and the CSR/FCN class mat-mat products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be


class TestCompactIndicesSort:
    """Sort-based compaction must match the cumsum+scatter contract."""

    @pytest.mark.parametrize('n', [1, 7, 128, 1000, 4096])
    @pytest.mark.parametrize('rate', [0.0, 0.05, 1.0])
    def test_matches_nonzero(self, n, rate):
        from brainevent_tpu.events.compact_ops import _compact_indices
        rng = np.random.default_rng(n)
        mask = jnp.asarray(rng.random(n) < rate)
        ids = jnp.arange(n, dtype=jnp.int32)
        out, count = _compact_indices(mask, ids)
        ref = np.flatnonzero(np.asarray(mask))
        assert int(count[0]) == ref.size
        np.testing.assert_array_equal(np.asarray(out[:ref.size]), ref)
        np.testing.assert_array_equal(np.asarray(out[ref.size:]), 0)


class TestRowIdsCumsum:
    @pytest.mark.parametrize('m,pattern', [
        (1, 'uniform'), (7, 'uniform'), (40, 'empty_rows'),
        (16, 'leading_empty'), (16, 'trailing_empty'), (5, 'all_empty'),
    ])
    def test_matches_repeat(self, m, pattern):
        from brainevent_tpu.csr._common import row_ids_from_indptr
        rng = np.random.default_rng(m)
        counts = rng.integers(1, 6, m)
        if pattern == 'empty_rows':
            counts[::3] = 0
        elif pattern == 'leading_empty':
            counts[:4] = 0
        elif pattern == 'trailing_empty':
            counts[-4:] = 0
        elif pattern == 'all_empty':
            counts[:] = 0
        indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                             jnp.int32)
        nse = int(counts.sum())
        expect = np.repeat(np.arange(m), counts)
        got = row_ids_from_indptr(indptr, nse)
        np.testing.assert_array_equal(np.asarray(got), expect)
        assert got.dtype == indptr.dtype


class TestTieredEventTail:
    """The event route's lax.switch tiers must be exact at every live-row
    count (prefix slicing is exact only because compacted live rows
    lead)."""

    @pytest.mark.parametrize('rate', [0.0, 0.002, 0.02, 0.2])
    def test_event_product_matches_full(self, rate):
        from brainevent_tpu.jitc import JITCNormalR
        rng = np.random.default_rng(int(rate * 1000))
        n = 600
        m = JITCNormalR((0.5, 0.1, 0.05, 7), shape=(n, n), corder=True)
        plan = m.build_walk_plan()
        plan.event_cap = 128
        spk = be.BinaryArray(jnp.asarray(rng.random(n) < rate))
        fast = spk @ plan
        full = jnp.asarray(np.asarray(spk.value, np.float32)) @ m.todense()
        np.testing.assert_allclose(np.asarray(fast), np.asarray(full),
                                   rtol=2e-4, atol=2e-4)


class TestClassMatmat:
    """CSR/CSC 2-D class products in every direction against the dense
    matrix, and gradients through them."""

    def _mk(self, rng, m=80, k=96):
        mask = rng.random((m, k)) < 0.2
        rows, cols = np.nonzero(mask)
        counts = np.bincount(rows, minlength=m)
        indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                             jnp.int32)
        w = jnp.asarray(rng.normal(size=rows.size), jnp.float32)
        return be.CSR((w, jnp.asarray(cols, jnp.int32), indptr),
                      shape=(m, k))

    @pytest.mark.parametrize('direction', ['AB', 'xA', 'cscAB', 'cscxA'])
    def test_matches_dense(self, direction):
        rng = np.random.default_rng(3)
        A = self._mk(rng)
        D = np.asarray(A.todense(), np.float64)
        Bm = rng.normal(size=(A.shape[1], 5)).astype(np.float32)
        X = rng.normal(size=(5, A.shape[0])).astype(np.float32)
        C = A.tocsc()
        M = C if 'csc' in direction else A
        if direction.endswith('AB'):
            got, want = M @ jnp.asarray(Bm), D @ Bm
        else:
            got, want = jnp.asarray(X) @ M, X @ D
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4)

    def test_grad_wrt_operand(self):
        rng = np.random.default_rng(4)
        A = self._mk(rng)
        Bm = jnp.asarray(rng.normal(size=(A.shape[1], 4)), jnp.float32)
        ct = rng.normal(size=(A.shape[0], 4)).astype(np.float32)
        g = jax.grad(lambda b: jnp.vdot(A @ b, jnp.asarray(ct)))(Bm)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(A.todense(), np.float64).T @ ct,
            rtol=1e-4, atol=1e-4)

    def test_traced_data_under_jit(self):
        rng = np.random.default_rng(5)
        A = self._mk(rng)
        Bm = rng.normal(size=(A.shape[1], 4)).astype(np.float32)

        def f(d):
            return be.CSR((d, A.indices, A.indptr), shape=A.shape) @ \
                jnp.asarray(Bm)

        np.testing.assert_allclose(
            np.asarray(jax.jit(f)(A.data)),
            np.asarray(A.todense(), np.float64) @ Bm, rtol=1e-4, atol=1e-4)


class TestFcnClassMatmat:
    @pytest.mark.parametrize('cls_dir', ['pre_AB', 'pre_xA',
                                         'post_AB', 'post_xA'])
    def test_matches_dense(self, cls_dir):
        from brainevent_tpu.fcn.main import FixedNumPerPre, FixedNumPerPost
        rng = np.random.default_rng(6)
        n_pre, n_post, K = 60, 72, 5
        idx = jnp.asarray(rng.integers(0, n_post, (n_pre, K)), jnp.int32)
        d = jnp.asarray(rng.normal(size=(n_pre, K)), jnp.float32)
        if cls_dir.startswith('pre'):
            M = FixedNumPerPre((d, idx), shape=(n_pre, n_post))
        else:
            M = FixedNumPerPost((d, idx), shape=(n_post, n_pre))
        D = np.asarray(M.todense(), np.float64)
        Bm = rng.normal(size=(M.shape[1], 4)).astype(np.float32)
        X = rng.normal(size=(4, M.shape[0])).astype(np.float32)
        if cls_dir.endswith('AB'):
            got, want = M @ jnp.asarray(Bm), D @ Bm
        else:
            got, want = jnp.asarray(X) @ M, X @ D
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4)
