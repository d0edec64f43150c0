# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Tests for the operator-dispatch spine (ops/core.py, ops/util.py,
ops/scatter.py), mirroring the reference's infrastructure self-tests
(``brainevent/_op/*_test.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.ops.core import XLACustomKernel
from brainevent_tpu.ops.scatter import event_scatter_add, masked_gather
from brainevent_tpu.ops.util import abstract_arguments, dtype_suffix, spike_suffix

_COUNTER = [0]


def fresh_prim(**kw):
    _COUNTER[0] += 1
    return XLACustomKernel(f'test_prim_{_COUNTER[0]}', **kw)


def outs_like(x):
    return [jax.ShapeDtypeStruct(x.shape, x.dtype)]


class TestDispatch:
    def test_eager_and_jit(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2]), asdefault=True)
        x = jnp.arange(4.0)
        np.testing.assert_allclose(prim(x, outs=outs_like(x))[0], x * 2)
        np.testing.assert_allclose(
            jax.jit(lambda v: prim(v, outs=outs_like(v))[0])(x), x * 2
        )

    def test_backend_kwarg_selection(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2]), asdefault=True)
        prim.def_kernel('alt', 'cpu', lambda **p: (lambda x: [x * 3]))
        x = jnp.arange(4.0)
        np.testing.assert_allclose(prim(x, outs=outs_like(x), backend='alt')[0], x * 3)
        np.testing.assert_allclose(prim(x, outs=outs_like(x))[0], x * 2)

    def test_global_config_backend(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2]), asdefault=True)
        prim.def_kernel('alt', 'cpu', lambda **p: (lambda x: [x * 3]))
        be.config.set_backend('cpu', 'alt')
        try:
            x = jnp.arange(4.0)
            np.testing.assert_allclose(prim(x, outs=outs_like(x))[0], x * 3)
        finally:
            be.config.clear_backends()

    def test_missing_backend_raises(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x]), asdefault=True)
        with pytest.raises(be.KernelNotAvailableError, match='jax_raw'):
            prim(jnp.ones(2), outs=outs_like(jnp.ones(2)), backend='cuda_raw')

    def test_no_kernel_at_all(self):
        prim = fresh_prim()
        with pytest.raises(be.KernelNotAvailableError, match='No kernel'):
            prim(jnp.ones(2), outs=outs_like(jnp.ones(2)))

    def test_unhashable_param_rejected(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x]), asdefault=True)
        with pytest.raises(ValueError, match='not.*hashable|hashable'):
            prim(jnp.ones(2), outs=outs_like(jnp.ones(2)), shape=[1, 2])

    def test_params_reach_generator(self):
        prim = fresh_prim()

        def gen(*, scale, outs, platform, **p):
            return lambda x: [x * scale]

        prim.def_jax_kernel(gen, asdefault=True)
        x = jnp.arange(3.0)
        np.testing.assert_allclose(prim(x, outs=outs_like(x), scale=5.0)[0], x * 5)

    def test_multiple_outputs(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2, x + 1]), asdefault=True)
        x = jnp.arange(3.0)
        a, b = prim(x, outs=[jax.ShapeDtypeStruct((3,), jnp.float32)] * 2)
        np.testing.assert_allclose(a, x * 2)
        np.testing.assert_allclose(b, x + 1)

    def test_jax_kernel_serves_cpu_and_gpu(self):
        # one generator registered for both platforms; no other platform
        prim = fresh_prim()
        gen = lambda **p: (lambda x: [x * 2.0])
        prim.def_jax_kernel(gen, asdefault=True)
        assert prim.available_backends('cpu') == ['jax_raw']
        assert prim.available_backends('gpu') == ['jax_raw']
        assert prim.available_backends('cuda') == ['jax_raw']
        assert set(prim._kernels) == {'cpu', 'gpu'}
        assert (prim._kernels['cpu']['jax_raw'].generator
                is prim._kernels['gpu']['jax_raw'].generator is gen)
        x = jnp.ones((8, 128))
        np.testing.assert_allclose(prim(x, outs=outs_like(x))[0], 2.0)


class TestTransforms:
    def _make(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2]), asdefault=True)
        prim.def_jvp_rule(lambda t, x, **p: [t * 2])
        prim.def_transpose_rule(lambda ct, x, **p: [ct[0] * 2])
        prim.def_general_batching()
        return prim

    def test_jvp(self):
        prim = self._make()
        f = lambda x: prim(x, outs=outs_like(x))[0]
        y, ty = jax.jvp(f, (jnp.ones(4),), (jnp.ones(4),))
        np.testing.assert_allclose(ty, 2.0)

    def test_grad(self):
        prim = self._make()
        g = jax.grad(lambda x: prim(x, outs=outs_like(x))[0].sum())(jnp.ones(4))
        np.testing.assert_allclose(g, 2.0)

    def test_vmap_fallback(self):
        prim = self._make()
        f = lambda x: prim(x, outs=outs_like(x))[0]
        out = jax.vmap(f)(jnp.ones((5, 4)))
        assert out.shape == (5, 4)
        np.testing.assert_allclose(out, 2.0)

    def test_vmap_mixed_axes(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x, y: [x + y]), asdefault=True)
        prim.def_general_batching()
        f = lambda x, y: prim(x, y, outs=outs_like(x))[0]
        out = jax.vmap(f, in_axes=(0, None))(jnp.ones((5, 4)), jnp.ones(4))
        np.testing.assert_allclose(out, 2.0)


class TestRegistry:
    def test_auto_registration_and_tags(self):
        prim = fresh_prim()
        prim.def_tags('foo_tag', 'bar_tag')
        assert prim.name in be.get_all_primitive_names()
        assert prim.name in be.get_primitives_by_tags({'foo_tag'})
        assert prim.name not in be.get_primitives_by_tags({'nope'})


class TestScatter:
    @pytest.mark.parametrize('n_out', [251, 5000])
    def test_matches_numpy(self, n_out, rng):
        tgt = rng.integers(0, n_out, 777)
        val = rng.normal(size=777).astype(np.float32)
        ref = np.zeros(n_out, np.float32)
        np.add.at(ref, tgt, val)
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), n_out)
        np.testing.assert_allclose(got, ref, atol=1e-3)

    def test_mask(self, rng):
        tgt = rng.integers(0, 100, 50)
        val = rng.normal(size=50).astype(np.float32)
        mask = rng.random(50) > 0.5
        ref = np.zeros(100, np.float32)
        np.add.at(ref, tgt[mask], val[mask])
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), 100,
                                mask=jnp.asarray(mask))
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_large_fallback(self, rng):
        n = 200_000
        tgt = rng.integers(0, n, 1000)
        val = rng.normal(size=1000).astype(np.float32)
        ref = np.zeros(n, np.float32)
        np.add.at(ref, tgt, val)
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), n)
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_scalar_values_broadcast(self):
        got = event_scatter_add(jnp.array([1, 1, 3]), 2.0, 5)
        np.testing.assert_allclose(got, [0, 4, 0, 2, 0])

    def test_differentiable(self):
        tgt = jnp.array([0, 1, 1])

        def loss(v):
            return event_scatter_add(tgt, v, 3).sum() * 2.0

        g = jax.grad(loss)(jnp.ones(3))
        np.testing.assert_allclose(g, 2.0)

    def test_masked_gather(self):
        src = jnp.arange(10.0)
        idx = jnp.array([2, 7, 9])
        mask = jnp.array([True, False, True])
        np.testing.assert_allclose(masked_gather(src, idx, mask), [2.0, 0.0, 9.0])


class TestDenseStreamScatter:
    """Scatter-add of event streams with many hits per output — the EI
    network's regime: every output receives several events."""

    def _ref(self, tgt, val, n_out):
        ref = np.zeros(n_out, np.float64)
        np.add.at(ref, tgt, val.astype(np.float64))
        return ref.astype(np.float32)

    @pytest.mark.parametrize('n_out', [1000, 9001])
    def test_matches_numpy_dense_stream(self, n_out, rng):
        E = n_out * 3
        tgt = rng.integers(0, n_out, E)
        val = rng.normal(size=E).astype(np.float32)
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), n_out)
        np.testing.assert_allclose(got, self._ref(tgt, val, n_out),
                                   rtol=2e-5, atol=1e-4)

    def test_sparse_stream_matches_numpy(self, rng):
        tgt = rng.integers(0, 100_000, 100)
        val = rng.normal(size=100).astype(np.float32)
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), 100_000)
        np.testing.assert_allclose(got, self._ref(tgt, val, 100_000),
                                   rtol=2e-5, atol=1e-4)

    def test_skewed_stream_exact(self, rng):
        # all events on two far-apart outputs
        n_out = 2000
        E = n_out * 4
        tgt = np.where(rng.random(E) < 0.5, 3, n_out - 1).astype(np.int64)
        val = rng.normal(size=E).astype(np.float32)
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), n_out)
        np.testing.assert_allclose(got, self._ref(tgt, val, n_out),
                                   rtol=2e-5, atol=1e-3)

    def test_mask(self, rng):
        n_out = 1500
        E = n_out * 3
        tgt = rng.integers(0, n_out, E)
        val = rng.normal(size=E).astype(np.float32)
        mask = rng.random(E) > 0.5
        got = event_scatter_add(jnp.asarray(tgt), jnp.asarray(val), n_out,
                                mask=jnp.asarray(mask))
        np.testing.assert_allclose(
            got, self._ref(tgt[mask], val[mask], n_out),
            rtol=2e-5, atol=1e-4)

    def test_differentiable(self, rng):
        n_out = 512
        E = n_out * 4
        tgt = jnp.asarray(rng.integers(0, n_out, E))

        def loss(v):
            return event_scatter_add(tgt, v, n_out).sum() * 2.0

        g = jax.grad(loss)(jnp.ones(E))
        np.testing.assert_allclose(g, 2.0, rtol=1e-5)

    def test_jit_and_vmap(self, rng):
        n_out = 600
        E = n_out * 3
        tgt = jnp.asarray(rng.integers(0, n_out, E))
        vals = jnp.asarray(rng.normal(size=(4, E)).astype(np.float32))
        out = jax.jit(jax.vmap(
            lambda v: event_scatter_add(tgt, v, n_out)))(vals)
        for i in range(4):
            np.testing.assert_allclose(
                out[i], self._ref(np.asarray(tgt), np.asarray(vals[i]),
                                  n_out), rtol=2e-5, atol=1e-4)


class TestScatterCounts:
    """Integer hit counts in f32 are exact in any summation order — what
    makes the EI network's spikes identical on every device and shard
    layout."""

    @pytest.mark.parametrize('n_out', [4000, 40_000, 400_000])
    def test_counts_exact(self, n_out, rng):
        tgt = rng.integers(0, n_out // 50, 50_000)   # ~50 hits per output
        got = event_scatter_add(jnp.asarray(tgt), 1.0, n_out,
                                dtype=jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(got), np.bincount(tgt, minlength=n_out))

    @pytest.mark.parametrize('n_chan', [2, 3])
    def test_multi_channel(self, n_chan, rng):
        from brainevent_tpu.ops.scatter import event_scatter_add_multi
        n_out, E = 700, 900
        tgt = rng.integers(0, n_out, E)
        val = rng.normal(size=(n_chan, E)).astype(np.float32)
        got = np.asarray(event_scatter_add_multi(
            jnp.asarray(tgt), jnp.asarray(val), n_out))
        assert got.shape == (n_chan, n_out)
        for c in range(n_chan):
            ref = np.zeros(n_out)
            np.add.at(ref, tgt, val[c].astype(np.float64))
            np.testing.assert_allclose(got[c], ref, atol=1e-4)

    def test_multi_channel_drops_out_of_range(self, rng):
        from brainevent_tpu.ops.scatter import event_scatter_add_multi
        tgt = jnp.asarray([0, 5, 9, 10, 10])       # 10 == n_out: dropped
        val = jnp.ones((2, 5), jnp.float32)
        got = np.asarray(event_scatter_add_multi(tgt, val, 10))
        np.testing.assert_array_equal(got.sum(axis=1), [3.0, 3.0])

    def test_removed_strategy_options_are_gone(self):
        for name in ('set_mxu_scatter_limit', 'set_scatter_passes',
                     'set_windowed_scatter_min_out', 'set_pallas_interpret',
                     'set_auto_mxu_plan', 'set_mm_passes'):
            assert not hasattr(be.config, name), name


class TestUtil:
    def test_abstract_arguments_single(self):
        (o,) = abstract_arguments(jax.ShapeDtypeStruct((3,), jnp.float32))
        assert o.shape == (3,) and o.dtype == jnp.float32

    def test_dtype_suffix(self):
        assert dtype_suffix(jnp.float32) == '_f32'
        assert dtype_suffix(jnp.bfloat16) == '_bf16'
        assert spike_suffix(jnp.bool_) == '_bool'
        assert spike_suffix(jnp.float32) == '_f32'


class TestBenchmarkHarness:
    def test_benchmark_function(self):
        res = be.benchmark_function(
            lambda x: x * 2, jnp.ones(16), name='double',
            n_warmup=1, n_runs=2, verbose=False,
        )
        assert len(res.records) == 1
        rec = res.records[0]
        assert rec.name == 'double' and rec.mean_ms > 0

    def test_compare_by(self):
        from brainevent_tpu.ops.benchmark import BenchmarkRecord, BenchmarkResult
        res = BenchmarkResult([
            BenchmarkRecord('a', 2.0, 0, 2.0, 2.0, 1),
            BenchmarkRecord('b', 1.0, 0, 1.0, 1.0, 1),
        ])
        sp = res.compare_by('a')
        assert sp['b'] == pytest.approx(2.0)
        assert res.best().name == 'b'

    def test_exports(self, tmp_path):
        from brainevent_tpu.ops.benchmark import BenchmarkRecord, BenchmarkResult
        res = BenchmarkResult([BenchmarkRecord('a', 2.0, 0, 2.0, 2.0, 1)])
        res.to_json(str(tmp_path / 'r.json'))
        res.to_csv(str(tmp_path / 'r.csv'))
        res.to_pickle(str(tmp_path / 'r.pkl'))
        assert (tmp_path / 'r.json').exists()
        assert (tmp_path / 'r.csv').read_text().startswith('name,')

    def test_missing_benchmark_data_raises(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x]), asdefault=True)
        with pytest.raises(be.BenchmarkDataFnNotProvidedError):
            prim.benchmark(platform='cpu')


class TestGpuRoutes:
    """Every primitive resolves to an XLA kernel on the GPU, and nothing is
    registered for any other platform than the CPU and the GPU."""

    def test_every_primitive_defaults_to_jax_raw_on_gpu(self):
        for name, prim in be.get_registry().items():
            if prim._call_fn is None:     # this module's test primitives
                continue
            assert prim._resolve_backend('gpu', None) == 'jax_raw', name

    def test_registrations_only_cpu_and_gpu(self):
        for name, prim in be.get_registry().items():
            assert set(prim._kernels) <= {'cpu', 'gpu'}, name

    def test_lowering_platforms(self):
        from brainevent_tpu.ops import core as _core
        assert set(_core._LOWERING_PLATFORMS) == {'cpu', 'cuda', 'rocm'}

    def test_benchmark_runs_every_backend(self):
        prim = fresh_prim()
        prim.def_jax_kernel(lambda **p: (lambda x: [x * 2]), asdefault=True)
        prim.def_kernel('other', 'cpu', lambda **p: (lambda x: [x * 3]))
        assert prim.available_backends('cpu') == ['jax_raw', 'other']
        prim.def_call(lambda x, backend=None: prim(
            x, outs=outs_like(x), backend=backend))
        prim.def_benchmark_data(lambda *, platform: [
            be.BenchmarkConfig('c0', (jnp.ones(4),))])
        res = prim.benchmark(platform='cpu', n_warmup=0, n_runs=1,
                             verbose=False)
        assert [r.name.rsplit('[', 1)[1] for r in res.records] == [
            'jax_raw]', 'other]']
