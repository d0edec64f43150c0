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

"""Benchmark-data generators for every registered primitive.

The reference attaches a benchmark-data generator to each primitive so the
CLI can sweep the whole registry (``brainevent/_csr/binary.py:757-824``
pattern).  Generators for the flagship ops live next to their primitives;
this module fills in the remaining registry rows so that

- ``brainevent-tpu benchmark-performance`` covers every primitive (the
  mm/dt2t/plasticity/slice/encoder/JITC rows), and
- the registry-driven GPU-route audit (``tests/test_backend_sweeps.py``)
  can check every primitive's GPU kernel against a dense reference on the
  same inputs.

Each generator is small-first (the CPU test sweep runs every config) and
includes at least one reference-scale row.
"""

import numpy as np

from .ops.benchmark import BenchmarkConfig

__all__ = ['install_benchmark_data']

_SEED = 0


def _rng():
    return np.random.default_rng(_SEED)


def _csr(rng, m, k, density):
    import jax.numpy as jnp
    mask = rng.random((m, k)) < density
    counts = mask.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = np.concatenate([np.flatnonzero(r) for r in mask]).astype(
        np.int32) if counts.sum() else np.zeros(0, np.int32)
    data = rng.normal(size=indices.shape[0]).astype(np.float32)
    return (jnp.asarray(data), jnp.asarray(indices), jnp.asarray(indptr))


def _csr_uniform(rng, m, k, density):
    """Uniform-degree CSR for large benchmark shapes (no dense mask)."""
    import jax.numpy as jnp
    per_row = max(1, int(k * density))
    nse = m * per_row
    indices = rng.integers(0, k, nse).astype(np.int32)
    indptr = (np.arange(m + 1) * per_row).astype(np.int32)
    data = rng.normal(size=nse).astype(np.float32)
    return (jnp.asarray(data), jnp.asarray(indices), jnp.asarray(indptr))


def _csr_configs(op: str):
    """CSR mm/dt2t/indexed/slice/plasticity families."""
    import jax.numpy as jnp

    def gen(*, platform):
        rng = _rng()
        sizes = ((200, 300, 0.05), (1000, 1000, 0.02))
        out = []
        for m, k, dens in sizes:
            data, indices, indptr = _csr(rng, m, k, dens)
            nse = int(indices.shape[0])
            shape = (m, k)
            if op in ('binary_csrmm', 'csrmm'):
                for transpose in (False, True):
                    exp_in = m if transpose else k
                    B = (jnp.asarray(rng.random((exp_in, 16)) < 0.1)
                         if op.startswith('binary')
                         else jnp.asarray(
                             rng.random((exp_in, 16)).astype(np.float32)))
                    out.append(BenchmarkConfig(
                        f'm={m},k={k},dens={dens},'
                        f'{"T" if transpose else "NT"}',
                        (data, indices, indptr, B),
                        {'shape': shape, 'transpose': transpose},
                        loop_arg=3))
        for m, k, dens in sizes:
            data, indices, indptr = _csr(rng, m, k, dens)
            nse = int(indices.shape[0])
            shape = (m, k)
            if op in ('binary_csrmm', 'csrmm'):
                pass
            elif op in ('csrmv_dt2t', 'csrmm_dt2t'):
                for transpose in (False, True):
                    exp = shape[1] if transpose else shape[0]
                    y = (jnp.asarray(rng.random(exp).astype(np.float32))
                         if op == 'csrmv_dt2t' else
                         jnp.asarray(rng.random((exp, 16)).astype(
                             np.float32)))
                    out.append(BenchmarkConfig(
                        f'm={m},k={k},dens={dens},'
                        f'{"T" if transpose else "NT"}',
                        (y, data, indices, indptr),
                        {'shape': shape, 'transpose': transpose},
                        loop_arg=0))
            elif op == 'binary_csrmv_indexed':
                perm = jnp.asarray(rng.permutation(nse).astype(np.int32))
                v = jnp.asarray(rng.random(k) < 0.05)
                out.append(BenchmarkConfig(
                    f'm={m},k={k},dens={dens}',
                    (data, indices, indptr, perm, v),
                    {'shape': shape, 'transpose': False}, loop_arg=4))
            elif op == 'binary_csrmm_indexed':
                perm = jnp.asarray(rng.permutation(nse).astype(np.int32))
                B = jnp.asarray(rng.random((k, 16)) < 0.05)
                out.append(BenchmarkConfig(
                    f'm={m},k={k},dens={dens}',
                    (data, indices, indptr, perm, B),
                    {'shape': shape, 'transpose': False}, loop_arg=4))
            elif op == 'csr_slice_rows':
                rows = jnp.asarray(
                    np.sort(rng.choice(m, size=m // 4, replace=False))
                    .astype(np.int32))
                out.append(BenchmarkConfig(
                    f'm={m},k={k},dens={dens}',
                    (data, indices, indptr, rows),
                    {'shape': shape}, loop_arg=0))
            elif op == 'csr_slice_rows_grad':
                rows = jnp.asarray(
                    np.sort(rng.choice(m, size=m // 4, replace=False))
                    .astype(np.int32))
                ct = jnp.asarray(
                    rng.random((m // 4, k)).astype(np.float32))
                out.append(BenchmarkConfig(
                    f'm={m},k={k},dens={dens}',
                    (ct, indices, indptr, rows),
                    {'shape': shape, 'data_len': nse}, loop_arg=0))
            elif op == 'update_csr_on_binary_post':
                from .csr.main import CSR
                csr = CSR((data, indices, indptr), shape=shape)
                csr.build_weight_indices()
                widx = csr._buffers['_t_perm']
                pre_trace = jnp.asarray(
                    rng.random(m).astype(np.float32))
                post_spike = jnp.asarray(rng.random(k) < 0.05)
                out.append(BenchmarkConfig(
                    f'm={m},k={k},dens={dens}',
                    (data, indices, indptr, widx, pre_trace, post_spike),
                    {'shape': shape}, loop_arg=4))
        return out
    return gen


def _fcn_configs(op: str):
    import jax.numpy as jnp

    def gen(*, platform):
        rng = _rng()
        out = []
        for n_pre, n_post, K in ((256, 300, 16), (4000, 4000, 80)):
            indices = jnp.asarray(
                rng.integers(0, n_post, (n_pre, K)).astype(np.int32))
            data = jnp.asarray(
                rng.normal(size=(n_pre, K)).astype(np.float32))
            shape = (n_pre, n_post)
            if op in ('fcnmv', 'fcnmm'):
                for transpose in (False, True):
                    exp_in = n_pre if transpose else n_post
                    x = (jnp.asarray(rng.random(exp_in).astype(np.float32))
                         if op == 'fcnmv' else
                         jnp.asarray(rng.random((exp_in, 16)).astype(
                             np.float32)))
                    out.append(BenchmarkConfig(
                        f'pre={n_pre},post={n_post},K={K},'
                        f'{"T" if transpose else "NT"}',
                        (data, indices, x),
                        {'shape': shape, 'transpose': transpose},
                        loop_arg=2))
            elif op == 'binary_fcnmm':
                for transpose in (False, True):
                    exp_in = n_pre if transpose else n_post
                    S = jnp.asarray(rng.random((exp_in, 16)) < 0.05)
                    out.append(BenchmarkConfig(
                        f'pre={n_pre},post={n_post},K={K},'
                        f'{"T" if transpose else "NT"}',
                        (data, indices, S),
                        {'shape': shape, 'transpose': transpose},
                        loop_arg=2))
            elif op == 'fcn_plasticity_row':
                spike = jnp.asarray(rng.random(n_pre) < 0.05)
                trace = jnp.asarray(
                    rng.random(n_post).astype(np.float32))
                out.append(BenchmarkConfig(
                    f'pre={n_pre},post={n_post},K={K}',
                    (data, indices, spike, trace), {}, loop_arg=3))
        return out
    return gen


def _dense_plasticity_configs(op: str):
    import jax.numpy as jnp

    def gen(*, platform):
        rng = _rng()
        out = []
        for m, k in ((200, 300), (2000, 2000)):
            W = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32))
            if op == 'update_dense_on_binary_pre':
                spike = jnp.asarray(rng.random(m) < 0.05)
                trace = jnp.asarray(rng.random(k).astype(np.float32))
                args = (W, spike, trace)
                loop = 2
            else:
                trace = jnp.asarray(rng.random(m).astype(np.float32))
                spike = jnp.asarray(rng.random(k) < 0.05)
                args = (W, trace, spike)
                loop = 1
            out.append(BenchmarkConfig(f'm={m},k={k}', args, {},
                                       loop_arg=loop))
        return out
    return gen


def _event_encoder_configs(op: str):
    import jax.numpy as jnp

    def gen(*, platform):
        rng = _rng()
        out = []
        for size, rate in ((512, 0.05), (8192, 0.01)):
            if op == 'binary_1d_array_index':
                s = jnp.asarray(rng.random(size) < rate)
                out.append(BenchmarkConfig(f'n={size},rate={rate}', (s,),
                                           {}, loop_arg=0))
                continue
            S = jnp.asarray(rng.random((16, size)) < rate)
            if op == 'binary_2d_csr_fill':
                from .events.compact_ops import (
                    binary_2d_csr_row_count_p_call)
                (counts,) = binary_2d_csr_row_count_p_call(S)
                indptr = jnp.concatenate([
                    jnp.zeros(1, counts.dtype), jnp.cumsum(counts)])
                out.append(BenchmarkConfig(
                    f'b=16,n={size},rate={rate}', (S, indptr), {},
                    loop_arg=0))
            else:
                out.append(BenchmarkConfig(
                    f'b=16,n={size},rate={rate}', (S,), {}, loop_arg=0))
        return out
    return gen


def _jitc_configs(op: str, tag: str, kind: str):
    """kind in {'dense','mm','count','fill','dt2t'}; binary mm uses
    boolean operands."""
    import jax.numpy as jnp
    from ._misc import _initialize_conn_length

    npar = {'s': 1, 'n': 2, 'u': 2}[tag]
    params = {'s': (1.5,), 'n': (0.5, 0.2), 'u': (0.1, 0.9)}[tag]

    def gen(*, platform):
        rng = _rng()
        out = []
        grid = [((200, 300), 0.1), ((2000, 2000), 0.02)]
        if kind in ('mm', 'dt2t'):
            # reference-scale row
            grid.append(((5120, 5120), 0.01))
        for shape, prob in grid:
            clen = _initialize_conn_length(prob)
            seed = 7
            base = tuple(np.float32(p) for p in params)
            if kind == 'dense':
                out.append(BenchmarkConfig(
                    f'{shape},p={prob}', base + (clen, seed),
                    {'shape': shape}, loop_arg=npar))
            elif kind == 'count':
                out.append(BenchmarkConfig(
                    f'{shape},p={prob}', base + (clen, seed),
                    {'shape': shape}, loop_arg=npar))
            elif kind == 'mm':
                binary = op.startswith('binary')
                B = (jnp.asarray(rng.random((shape[1], 16)) < 0.1)
                     if binary else
                     jnp.asarray(rng.random((shape[1], 16)).astype(
                         np.float32)))
                out.append(BenchmarkConfig(
                    f'{shape},p={prob}', base + (clen, B, seed),
                    {'shape': shape}, loop_arg=npar + 1))
            elif kind == 'fill':
                from . import jitc as _jitc
                fam = {'s': _jitc.scalar, 'n': _jitc.normal,
                       'u': _jitc.uniform}[tag]
                count_p = getattr(fam, f'jit{tag}_csr_count_p')
                (counts,) = count_p._call_fn(*base, clen, seed,
                                             shape=shape)
                nse = int(np.sum(np.asarray(counts)))
                out.append(BenchmarkConfig(
                    f'{shape},p={prob}', base + (clen, seed),
                    {'shape': shape, 'nse': nse}, loop_arg=npar))
            elif kind == 'dt2t':
                from . import jitc as _jitc
                fam = {'s': _jitc.scalar, 'n': _jitc.normal,
                       'u': _jitc.uniform}[tag]
                count_p = getattr(fam, f'jit{tag}_csr_count_p')
                (counts,) = count_p._call_fn(*base, clen, seed,
                                             shape=shape)
                nse = int(np.sum(np.asarray(counts)))
                y = jnp.asarray(rng.random(shape[0]).astype(np.float32))
                out.append(BenchmarkConfig(
                    f'{shape},p={prob}', base + (clen, y, seed),
                    {'shape': shape, 'nse': nse}, loop_arg=npar + 1))
        return out
    return gen


def install_benchmark_data(registry) -> None:
    """Attach generators to every registered primitive that lacks one."""
    gens = {}
    for op in ('binary_csrmm', 'csrmm', 'csrmv_dt2t', 'csrmm_dt2t',
               'binary_csrmv_indexed', 'binary_csrmm_indexed',
               'csr_slice_rows', 'csr_slice_rows_grad',
               'update_csr_on_binary_post'):
        gens[op] = _csr_configs(op)
    for op in ('fcnmv', 'fcnmm', 'binary_fcnmm', 'fcn_plasticity_row'):
        gens[op] = _fcn_configs(op)
    for op in ('update_dense_on_binary_pre', 'update_dense_on_binary_post'):
        gens[op] = _dense_plasticity_configs(op)
    for op in ('binary_1d_array_index', 'binary_2d_array_index',
               'binary_2d_compact_only', 'binary_2d_csc_encode',
               'binary_2d_csr_fill', 'binary_2d_csr_row_count',
               'binary_2d_pair_stream_encode',
               'binary_2d_row_sparse_encode'):
        gens[op] = _event_encoder_configs(op)
    for tag in 'snu':
        gens[f'jit{tag}'] = _jitc_configs(f'jit{tag}', tag, 'dense')
        gens[f'jit{tag}mm'] = _jitc_configs(f'jit{tag}mm', tag, 'mm')
        gens[f'binary_jit{tag}mm'] = _jitc_configs(
            f'binary_jit{tag}mm', tag, 'mm')
        gens[f'jit{tag}_csr_count'] = _jitc_configs(
            f'jit{tag}_csr_count', tag, 'count')
        gens[f'jit{tag}_csr_fill'] = _jitc_configs(
            f'jit{tag}_csr_fill', tag, 'fill')
        gens[f'jit{tag}mv_dt2t'] = _jitc_configs(
            f'jit{tag}mv_dt2t', tag, 'dt2t')

    for name, gen in gens.items():
        prim = registry.get(name)
        if prim is not None and prim._benchmark_data_fn is None:
            prim.def_benchmark_data(gen)
