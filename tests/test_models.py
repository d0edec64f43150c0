# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Model + multi-chip sharding tests (the acceptance workloads end-to-end)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brainevent_tpu.models import (
    EINet, LIFRefParams, LIFRefState, lifref_init, lifref_step,
    surrogate_spike,
)
from brainevent_tpu.parallel import ShardedEINet, neuron_mesh


class TestLIF:
    def test_resting_stays_at_rest(self):
        p = LIFRefParams()
        st = LIFRefState(v=jnp.full((4,), p.v_rest),
                         t_last=jnp.full((4,), -1e7))
        st2, spk = lifref_step(st, jnp.zeros(4), 0.0, 0.1, p)
        assert not bool(spk.any())
        np.testing.assert_allclose(st2.v, p.v_rest, atol=1e-6)

    def test_strong_input_spikes_and_resets(self):
        p = LIFRefParams()
        st = LIFRefState(v=jnp.full((2,), -50.5), t_last=jnp.full((2,), -1e7))
        st2, spk = lifref_step(st, jnp.full(2, 1000.0), 1.0, 0.1, p)
        assert bool(spk.all())
        np.testing.assert_allclose(st2.v, p.v_reset)
        np.testing.assert_allclose(st2.t_last, 1.0)

    def test_refractory_blocks_integration(self):
        p = LIFRefParams()
        st = LIFRefState(v=jnp.full((1,), p.v_reset),
                         t_last=jnp.zeros(1))  # just spiked at t=0
        st2, spk = lifref_step(st, jnp.full(1, 1000.0), 1.0, 0.1, p)
        assert not bool(spk.any())
        np.testing.assert_allclose(st2.v, p.v_reset)

    def test_surrogate_gradient(self):
        g = jax.grad(lambda x: surrogate_spike(x).sum())(jnp.zeros(3))
        assert (np.asarray(g) > 0).all()
        y = surrogate_spike(jnp.asarray([-1.0, 0.0, 1.0]))
        np.testing.assert_allclose(y, [0.0, 1.0, 1.0])


class TestEINet:
    @pytest.mark.parametrize('coba', [True, False])
    def test_firing_rate_regime(self, coba):
        net = EINet(scale=0.25, coba=coba)  # 1000 neurons
        state = jax.jit(lambda: net.run(3000))()
        rate = float(net.firing_rate_hz(state, 3000))
        # reference nets sit near 50 Hz; accept a broad plausible band
        assert 5.0 < rate < 200.0, f'firing rate {rate} Hz out of regime'

    def test_step_is_jittable_and_pure(self):
        net = EINet(scale=0.1, coba=True)
        s0 = net.init_state()
        step = jax.jit(lambda s, t: net.step(s, t))
        s1 = step(s0, 0.0)
        s1b = step(s0, 0.0)
        np.testing.assert_allclose(np.asarray(s1.neurons.v),
                                   np.asarray(s1b.neurons.v))

    def test_state_is_pytree(self):
        net = EINet(scale=0.1)
        s = net.init_state()
        leaves, treedef = jax.tree_util.tree_flatten(s)
        s2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert s2.neurons.v.shape == s.neurons.v.shape


class TestSharded:
    def test_sharded_matches_regime(self):
        mesh = neuron_mesh(8)
        net = ShardedEINet(mesh=mesh, num=1024, n_conn=32)
        state = jax.jit(lambda s: net.run(2000, state=s))(net.init_state())
        rate = float(state.spike_count.mean()) / (2000 * 0.1e-3)
        assert 1.0 < rate < 500.0

    def test_sharded_step_keeps_sharding(self):
        mesh = neuron_mesh(8)
        net = ShardedEINet(mesh=mesh, num=512, n_conn=16)
        state = net.init_state()
        out = jax.jit(net.step_fn())(state, 0.0)
        assert 'neurons' in str(out.v.sharding)

    def test_graft_entry(self):
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            'graft_entry', '/root/repo/__graft_entry__.py')
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn, args = mod.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        mod.dryrun_multichip(8)


class TestShardedOps:
    def test_sharded_fcnmv_matches_single(self, rng):
        from brainevent_tpu.parallel import neuron_mesh, sharded_binary_fcnmv
        from brainevent_tpu.fcn import binary_fcnmv
        mesh = neuron_mesh(8)
        n_pre, n_post, n_conn = 256, 300, 8
        indices = jnp.asarray(rng.integers(0, n_post, (n_pre, n_conn)),
                              dtype=jnp.int32)
        w = jnp.asarray([0.5], jnp.float32)
        spk = jnp.asarray(rng.random(n_pre) < 0.1)
        want = binary_fcnmv(w, indices, spk, shape=(n_pre, n_post),
                            transpose=True)
        got = sharded_binary_fcnmv(w, indices, spk, mesh=mesh,
                                   shape=(n_pre, n_post))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)

    def test_sharded_fcnmv_hetero_psum_scatter(self, rng):
        from brainevent_tpu.parallel import neuron_mesh, sharded_binary_fcnmv
        from brainevent_tpu.fcn import binary_fcnmv
        mesh = neuron_mesh(8)
        n_pre, n_post, n_conn = 256, 256, 8
        indices = jnp.asarray(rng.integers(0, n_post, (n_pre, n_conn)),
                              dtype=jnp.int32)
        w = jnp.asarray(rng.normal(size=(n_pre, n_conn)), dtype=jnp.float32)
        spk = jnp.asarray(rng.random(n_pre) < 0.1)
        want = binary_fcnmv(w, indices, spk, shape=(n_pre, n_post),
                            transpose=True)
        got = sharded_binary_fcnmv(w, indices, spk, mesh=mesh,
                                   shape=(n_pre, n_post),
                                   reduce='psum_scatter')
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)

    def test_sharded_csrmv_matches_single(self, rng):
        from brainevent_tpu.parallel import neuron_mesh, sharded_binary_csrmv
        from brainevent_tpu.csr import binary_csrmv
        mesh = neuron_mesh(8)
        m, k, per_row = 256, 300, 4
        indices = jnp.asarray(rng.integers(0, k, m * per_row), dtype=jnp.int32)
        indptr = jnp.asarray(np.arange(m + 1) * per_row, dtype=jnp.int32)
        w = jnp.asarray(rng.normal(size=m * per_row), dtype=jnp.float32)
        spk = jnp.asarray(rng.random(m) < 0.1)
        want = binary_csrmv(w, indices, indptr, spk, shape=(m, k),
                            transpose=True)
        got = sharded_binary_csrmv(w, indices, indptr, spk, mesh=mesh,
                                   shape=(m, k))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)


class TestEINetPropagation:
    """``EINet._propagate``: one compaction, one 2-channel scatter, and an
    exact fallback when more neurons fire than the static capacity."""

    @staticmethod
    def _dense_counts(net, spk):
        spk = np.asarray(spk)
        conn = np.asarray(net.conn_all)
        exc = np.arange(net.num) < net.n_exc
        ce = np.bincount(conn[spk & exc].reshape(-1), minlength=net.num)
        ci = np.bincount(conn[spk & ~exc].reshape(-1), minlength=net.num)
        return net.w_e * ce, net.w_i * ci

    @pytest.mark.parametrize('scale', [0.05, 0.25])
    @pytest.mark.parametrize('rate', [0.0, 0.02, 0.2])
    def test_propagate_counts_match_dense(self, scale, rate, rng):
        # 0.2 is over the static capacity: the overflow branch runs
        net = EINet(scale=scale)
        spk = rng.random(net.num) < rate
        inc_e, inc_i = jax.jit(net._propagate)(jnp.asarray(spk))
        want_e, want_i = self._dense_counts(net, spk)
        np.testing.assert_allclose(np.asarray(inc_e), want_e, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(inc_i), want_i, rtol=1e-6)

    def test_propagate_all_spike_takes_fallback(self):
        net = EINet(scale=0.25)
        spk = np.ones(net.num, bool)          # far over the capacity
        inc_e, inc_i = jax.jit(net._propagate)(jnp.asarray(spk))
        want_e, want_i = self._dense_counts(net, spk)
        np.testing.assert_allclose(np.asarray(inc_e), want_e, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(inc_i), want_i, rtol=1e-6)

    def test_propagate_no_spike_is_zero(self):
        net = EINet(scale=0.05)
        inc_e, inc_i = net._propagate(jnp.zeros(net.num, bool))
        assert float(jnp.abs(inc_e).sum()) == 0.0
        assert float(jnp.abs(inc_i).sum()) == 0.0

    def test_tiny_net_capacity_covers_all(self, rng):
        # event_capacity(num) == num: the compacted path alone is exact
        from brainevent_tpu.fcn.binary import event_capacity
        net = EINet(scale=0.01, n_conn=8)     # 40 neurons
        assert event_capacity(net.num) >= net.num
        spk = rng.random(net.num) < 0.5
        inc_e, inc_i = net._propagate(jnp.asarray(spk))
        want_e, want_i = self._dense_counts(net, spk)
        np.testing.assert_allclose(np.asarray(inc_e), want_e, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(inc_i), want_i, rtol=1e-6)

    @pytest.mark.parametrize('divisor', [1, 8, 32, 256])
    def test_spikes_independent_of_capacity(self, divisor):
        # a tight capacity only changes which branch runs, never the result
        from brainevent_tpu import config
        net = EINet(scale=0.1)
        s0 = net.init_state()
        before = config.get_event_capacity_divisor()
        try:
            ref = jax.jit(lambda s: net.run(200, state=s))(s0)
            config.set_event_capacity_divisor(divisor)
            got = jax.jit(lambda s: net.run(200, state=s))(s0)
        finally:
            config.set_event_capacity_divisor(before)
        np.testing.assert_array_equal(np.asarray(got.spike_count),
                                      np.asarray(ref.spike_count))
        np.testing.assert_array_equal(np.asarray(got.neurons.v),
                                      np.asarray(ref.neurons.v))

    def test_burst_drive_exact_against_step_loop(self):
        # strong drive: most neurons fire together, the overflow branch
        # runs; the fused loop equals stepping one at a time
        net = EINet(scale=0.1)
        s0 = net.init_state()
        run = jax.jit(lambda s: net.run(20, inp=500.0, state=s))(s0)
        from brainevent_tpu.fcn.binary import event_capacity
        step = jax.jit(lambda s, t: net.step(s, t, 500.0))
        s, most = s0, 0
        for i in range(20):
            prev = int(s.spike_count.sum())
            s = step(s, jnp.float32(i * net.dt))
            most = max(most, int(s.spike_count.sum()) - prev)
        assert most > event_capacity(net.num)
        np.testing.assert_array_equal(np.asarray(run.spike_count),
                                      np.asarray(s.spike_count))
        np.testing.assert_allclose(np.asarray(run.g_e), np.asarray(s.g_e),
                                   rtol=1e-6)

    @pytest.mark.parametrize('coba', [True, False])
    def test_run_matches_step_loop(self, coba):
        net = EINet(scale=0.05, coba=coba)
        s0 = net.init_state()
        run = jax.jit(lambda s: net.run(50, state=s))(s0)
        step = jax.jit(lambda s, t: net.step(s, t))
        s = s0
        for i in range(50):
            s = step(s, jnp.float32(i * net.dt))
        np.testing.assert_array_equal(np.asarray(run.spike_count),
                                      np.asarray(s.spike_count))
        np.testing.assert_allclose(np.asarray(run.neurons.v),
                                   np.asarray(s.neurons.v), atol=1e-5)

    def test_state_dtypes(self):
        s = EINet(scale=0.05).init_state()
        assert s.neurons.v.dtype == jnp.float32
        assert s.g_e.dtype == s.g_i.dtype == jnp.float32
        assert s.spike_count.dtype == jnp.int32


class TestSurrogateTraining:
    def test_gradients_flow_and_loss_decreases(self, rng):
        from brainevent_tpu.models.training import (
            SurrogateSNN, train_step, snn_loss)
        model = SurrogateSNN(n_in=20, n_hidden=100, n_out=4, n_conn=16)
        params = model.init_params()
        inputs = jnp.asarray(rng.random((30, 20)).astype(np.float32))
        label = jnp.asarray(2)

        step = jax.jit(lambda p: train_step(model, p, inputs, label, lr=0.5))
        losses = []
        for _ in range(10):
            params, loss = step(params)
            losses.append(float(loss))
        assert losses[-1] < losses[0], f'loss did not decrease: {losses}'

    def test_grads_nonzero_through_event_path(self, rng):
        from brainevent_tpu.models.training import SurrogateSNN, snn_loss
        model = SurrogateSNN(n_in=10, n_hidden=64, n_out=3, n_conn=8)
        params = model.init_params()
        inputs = jnp.asarray(rng.random((20, 10)).astype(np.float32))
        grads = jax.grad(lambda p: snn_loss(model, p, inputs, jnp.asarray(1))
                         )(params)
        assert float(jnp.abs(grads.w_rec).sum()) > 0
        assert float(jnp.abs(grads.w_in).sum()) > 0


class TestBatchedSimulation:
    def test_vmap_over_initial_states(self, rng):
        """vmap over a batch of network states exercises the batching rules
        of the event primitives end-to-end."""
        net = EINet(scale=0.05, coba=True)
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        states = jax.vmap(net.init_state)(keys)
        run = jax.jit(jax.vmap(lambda s: net.run(100, state=s)))
        out = run(states)
        assert out.spike_count.shape == (4, net.num)
        counts = np.asarray(out.spike_count.sum(axis=1))
        assert (counts > 0).all()
        # different seeds -> different trajectories
        assert len(set(counts.tolist())) > 1


class TestSurrogateCustomVjp:
    def test_grads_match_dense_oracle(self, rng):
        """The scatter-free custom-VJP recurrent matvec must match
        autodiff through an explicit dense recurrent matrix."""
        from brainevent_tpu.models.training import SurrogateSNN, snn_loss
        from brainevent_tpu.models.neurons import surrogate_spike
        model = SurrogateSNN(n_in=12, n_hidden=60, n_out=3, n_conn=8, seed=2)
        params = model.init_params()
        x = jnp.asarray(rng.random((20, 12)).astype(np.float32))
        g = jax.grad(lambda p: snn_loss(model, p, x, jnp.asarray(1)))(params)
        idx = np.asarray(model.rec_indices)

        def dense_loss(wrec):
            rows = jnp.repeat(jnp.arange(60), 8)
            Wd = jnp.zeros((60, 60)).at[rows, idx.reshape(-1)].add(
                wrec.reshape(-1))
            decay = jnp.float32(jnp.exp(-model.dt / model.tau))

            def step(c, xt):
                v, s = c
                cur = xt @ params.w_in + Wd.T @ s
                v = v * decay + cur
                sn = surrogate_spike(v - model.v_th)
                return (v - sn * model.v_th, sn), sn

            (_, _), spikes = jax.lax.scan(
                step, (jnp.zeros(60), jnp.zeros(60)), x)
            return -jax.nn.log_softmax(spikes.mean(0) @ params.w_out)[1]

        gd = jax.grad(dense_loss)(params.w_rec)
        np.testing.assert_allclose(np.asarray(g.w_rec), np.asarray(gd),
                                   rtol=1e-4, atol=1e-5)

    def test_train_step_is_one_sgd_step(self, rng):
        from brainevent_tpu.models.training import (SurrogateSNN, snn_loss,
                                                    train_step)
        model = SurrogateSNN(n_in=12, n_hidden=60, n_out=3, n_conn=8, seed=2)
        p = model.init_params()
        x = jnp.asarray(rng.random((20, 12)).astype(np.float32))
        new, loss = jax.jit(lambda q: train_step(model, q, x,
                                                 jnp.asarray(1), lr=0.1))(p)
        g = jax.grad(lambda q: snn_loss(model, q, x, jnp.asarray(1)))(p)
        np.testing.assert_allclose(
            float(loss), float(snn_loss(model, p, x, jnp.asarray(1))),
            rtol=1e-6)
        for a, b, c in zip(new, p, g):
            np.testing.assert_allclose(np.asarray(a),
                                       np.asarray(b - 0.1 * c),
                                       rtol=1e-5, atol=1e-6)


class TestEllRecurrent:
    """The recurrent ELL product's custom VJP (one scatter forward, one
    shared gather backward) against the dense matrix and against plain
    autodiff of the same scatter."""

    def _args(self, rng, n=50, k=6):
        idx = jnp.asarray(rng.integers(0, n, (n, k)), jnp.int32)
        w = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
        spk = jnp.asarray((rng.random(n) < 0.4).astype(np.float32))
        return idx, w, spk

    def test_forward_matches_dense(self, rng):
        from brainevent_tpu.models.training import ell_recurrent
        idx, w, spk = self._args(rng)
        n = spk.shape[0]
        dense = np.zeros((n, n))
        np.add.at(dense, (np.repeat(np.arange(n), idx.shape[1]),
                          np.asarray(idx).reshape(-1)),
                  np.asarray(w, np.float64).reshape(-1))
        np.testing.assert_allclose(np.asarray(ell_recurrent(idx, w, spk)),
                                   np.asarray(spk) @ dense, rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize('n,k', [(50, 6), (300, 32), (257, 1),
                                     (64, 64)])
    def test_vjp_matches_plain_autodiff(self, rng, n, k):
        from brainevent_tpu.models.training import ell_recurrent
        idx, w, spk = self._args(rng, n, k)
        ct = jnp.asarray(rng.normal(size=n), jnp.float32)

        def plain(w_, s_):
            vals = (w_ * s_[:, None]).reshape(-1)
            return jnp.zeros(n).at[idx.reshape(-1)].add(vals)

        g = jax.grad(lambda a, b: jnp.vdot(ell_recurrent(idx, a, b), ct),
                     argnums=(0, 1))(w, spk)
        r = jax.grad(lambda a, b: jnp.vdot(plain(a, b), ct),
                     argnums=(0, 1))(w, spk)
        for x, y in zip(g, r):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-5, atol=1e-5)

    def test_jit_and_eager_agree(self, rng):
        from brainevent_tpu.models.training import ell_recurrent
        idx, w, spk = self._args(rng)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(ell_recurrent)(idx, w, spk)),
            np.asarray(ell_recurrent(idx, w, spk)))
