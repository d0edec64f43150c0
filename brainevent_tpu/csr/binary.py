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

"""Event-driven CSR SpMV/SpMM (reference ``brainevent/_csr/binary.py``).

``binary_csrmv(data, indices, indptr, v, shape=..., transpose=...)`` computes
``y = A @ v`` with ``v`` a binary event vector: bool entries gate their
weight, float entries gate at ``> 0`` (the reference's event contract). The
gradient w.r.t. ``v`` is the *float* ``csrmv`` (surrogate-linear), matching
reference AD rules (``brainevent/_csr/binary.py:656-754``).

API note: the reference threads a CUDA task-queue ``workspace`` through this
function (``brainevent/_csr/binary.py:128``); brainevent-tpu accepts the
keyword for drop-in compatibility but ignores it — the scatter direction is
XLA's scatter-add (see ``ops/scatter.py``), which needs no task queues.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._compat import ad
from .._misc import namescope, csr_to_coo_index
from ..ops.core import XLACustomKernel
from ..ops.util import general_batching_rule
from ..ops.benchmark import BenchmarkConfig
from ..ops.scatter import event_scatter_add
from ..units import maybe_unit, split_mantissa_unit
from ._common import csr_checks, event_gate, is_homo, row_ids_from_indptr
from .float import csrmv_p_call, csrmm_p_call

__all__ = [
    'binary_csrmv', 'binary_csrmv_p', 'binary_csrmv_p_call',
    'binary_csrmm', 'binary_csrmm_p', 'binary_csrmm_p_call',
    'binary_csrmv_indexed', 'binary_csrmv_indexed_p', 'binary_csrmv_indexed_p_call',
    'binary_csrmm_indexed', 'binary_csrmm_indexed_p', 'binary_csrmm_indexed_p_call',
]


# =============================================================================
# binary_csrmv
# =============================================================================

def _binary_csrmv_jax_kernel(*, shape, transpose, indexed=False, **params):
    m, k = shape
    nse = params['indices_info'].shape[0]
    out_dtype = params['outs'][0].dtype
    homo = params['weight_info'].shape[0] == 1

    def kernel(weights, indices, indptr, *rest):
        if indexed:
            perm, vector = rest
            w_all = (weights if homo else weights[perm])
        else:
            (vector,) = rest
            w_all = weights
        rows = row_ids_from_indptr(indptr, nse)
        w = w_all[0] if homo else w_all
        if transpose:
            events = event_gate(vector, out_dtype)[rows]
            return (event_scatter_add(indices, w * events, k, dtype=out_dtype),)
        events = event_gate(vector, out_dtype)[indices]
        return (event_scatter_add(rows, w * events, m, dtype=out_dtype),)

    return kernel


def _grad_backend(params):
    """Backends valid for this primitive may not exist on the float
    primitive; fall back to auto-select for gradient calls
    (reference ``brainevent/_csr/binary.py:624-653``)."""
    backend = params.get('backend')
    return backend if backend in (None, 'jax_raw') else None


def _binary_csrmv_jvp_weights(w_dot, weights, indices, indptr, vector, **params):
    return binary_csrmv_p_call(
        w_dot, indices, indptr, vector,
        shape=params['shape'], transpose=params['transpose'],
        backend=params.get('backend'))


def _binary_csrmv_jvp_vector(v_dot, weights, indices, indptr, vector, **params):
    return csrmv_p_call(
        weights, indices, indptr, v_dot,
        shape=params['shape'], transpose=params['transpose'],
        backend=_grad_backend(params))


def _binary_csrmv_transpose_rule(ct, weights, indices, indptr, vector, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(vector):
        v_bar = csrmv_p_call(
            weights, indices, indptr, ct,
            shape=shape, transpose=not transpose,
            backend=_grad_backend(params))[0]
        return weights, indices, indptr, v_bar
    rows, cols = csr_to_coo_index(indptr, indices)
    ev = event_gate(vector, ct.dtype)
    if transpose:
        w_bar = ev[rows] * ct[cols]
    else:
        w_bar = ct[rows] * ev[cols]
    if is_homo(weights):
        w_bar = jnp.sum(w_bar, keepdims=True)
    return w_bar, indices, indptr, vector


def _binary_csrmv_batching(args, axes, **params):
    if tuple(axes) == (None, None, None, 0) and args[3].ndim == 2:
        r = binary_csrmm_p_call(args[0], args[1], args[2], args[3].T,
                                shape=params['shape'],
                                transpose=params['transpose'],
                                backend=params.get('backend'))
        return r, [1]
    if tuple(axes) == (None, None, None, 1) and args[3].ndim == 2:
        r = binary_csrmm_p_call(args[0], args[1], args[2], args[3],
                                shape=params['shape'],
                                transpose=params['transpose'],
                                backend=params.get('backend'))
        return r, [1]
    return general_batching_rule(binary_csrmv_p, args, axes, **params)


binary_csrmv_p = XLACustomKernel(
    'binary_csrmv',
    doc='Event-driven CSR SpMV (reference brainevent/_csr/binary.py:128).',
)
binary_csrmv_p.def_jax_kernel(_binary_csrmv_jax_kernel, asdefault=True)
binary_csrmv_p.def_jvp_rule2(
    _binary_csrmv_jvp_weights, None, None, _binary_csrmv_jvp_vector)
binary_csrmv_p.def_transpose_rule(_binary_csrmv_transpose_rule)
binary_csrmv_p.def_batching_rule(_binary_csrmv_batching)
binary_csrmv_p.def_tags('csr', 'binary', 'mv')


def binary_csrmv_p_call(weights, indices, indptr, vector, *,
                        shape, transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    csr_checks(weights, indices, indptr, shape)
    m, k = shape
    exp_in = m if transpose else k
    assert vector.shape == (exp_in,), (
        f'vector shape {vector.shape} != ({exp_in},) for transpose={transpose}')
    out_len = k if transpose else m
    return binary_csrmv_p(
        weights, indices, indptr, vector,
        outs=[jax.ShapeDtypeStruct((out_len,), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        vector_info=jax.ShapeDtypeStruct(vector.shape, vector.dtype),
    )


binary_csrmv_p.def_call(binary_csrmv_p_call)


@namescope(name='binary_csrmv', static_argnames=('shape', 'transpose', 'backend'))
def _binary_csrmv_core(data, indices, indptr, v, *, shape,
                       transpose: bool = False, backend: Optional[str] = None):
    data, w_unit = split_mantissa_unit(data)
    v, v_unit = split_mantissa_unit(v)
    (out,) = binary_csrmv_p_call(data, indices, indptr, v, shape=shape,
                                 transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, v_unit)


def binary_csrmv(data, indices, indptr, v, *, shape, workspace=None,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven CSR SpMV ``y = A @ v`` / ``A.T @ v`` (unit-aware).

    ``workspace`` is accepted for reference API compatibility
    (``brainevent/_csr/binary.py:128``) and ignored — no CUDA task-queue
    workspaces are needed.
    """
    del workspace
    return _binary_csrmv_core(data, indices, indptr, v, shape=shape,
                              transpose=transpose, backend=backend)


def _binary_csrmv_benchmark_data(*, platform):
    import numpy as np
    configs = []
    rng = np.random.default_rng(0)
    for n, conn, rate in (
        (1000, 0.01, 0.01), (1000, 0.1, 0.01), (1000, 0.1, 0.1),
        (10000, 0.01, 0.01),
    ):
        nse = int(n * n * conn)
        indices = jnp.asarray(rng.integers(0, n, nse), dtype=jnp.int32)
        counts = np.full(n, nse // n)
        counts[: nse % n] += 1
        indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                             dtype=jnp.int32)
        w = jnp.asarray(rng.normal(size=nse), dtype=jnp.float32)
        v = jnp.asarray(rng.random(n) < rate)
        for transpose in (False, True):
            configs.append(BenchmarkConfig(
                f'n={n},conn={conn},rate={rate},{"T" if transpose else "NT"}',
                (w, indices, indptr, v),
                {'shape': (n, n), 'transpose': transpose}))
    return configs


binary_csrmv_p.def_benchmark_data(_binary_csrmv_benchmark_data)


# =============================================================================
# binary_csrmm
# =============================================================================

def _binary_csrmm_jax_kernel(*, shape, transpose, indexed=False, **params):
    m, k = shape
    nse = params['indices_info'].shape[0]
    out_dtype = params['outs'][0].dtype
    homo = params['weight_info'].shape[0] == 1

    def kernel(weights, indices, indptr, *rest):
        if indexed:
            perm, B = rest
            w_all = (weights if homo else weights[perm])
        else:
            (B,) = rest
            w_all = weights
        rows = row_ids_from_indptr(indptr, nse)
        w_col = w_all[0] if homo else w_all[:, None]
        events = event_gate(B, out_dtype)
        if transpose:
            contrib = w_col * events[rows]
            out = jnp.zeros((k, B.shape[1]), dtype=out_dtype)
            return (out.at[indices].add(contrib, mode='drop'),)
        contrib = w_col * events[indices]
        out = jnp.zeros((m, B.shape[1]), dtype=out_dtype)
        return (out.at[rows].add(contrib, mode='drop'),)

    return kernel


def _binary_csrmm_jvp_weights(w_dot, weights, indices, indptr, B, **params):
    return binary_csrmm_p_call(
        w_dot, indices, indptr, B,
        shape=params['shape'], transpose=params['transpose'],
        backend=params.get('backend'))


def _binary_csrmm_jvp_B(B_dot, weights, indices, indptr, B, **params):
    return csrmm_p_call(
        weights, indices, indptr, B_dot,
        shape=params['shape'], transpose=params['transpose'],
        backend=_grad_backend(params))


def _binary_csrmm_transpose_rule(ct, weights, indices, indptr, B, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(B):
        B_bar = csrmm_p_call(
            weights, indices, indptr, ct,
            shape=shape, transpose=not transpose,
            backend=_grad_backend(params))[0]
        return weights, indices, indptr, B_bar
    rows, cols = csr_to_coo_index(indptr, indices)
    ev = event_gate(B, ct.dtype)
    if transpose:
        w_bar = jnp.sum(ev[rows] * ct[cols], axis=1)
    else:
        w_bar = jnp.sum(ct[rows] * ev[cols], axis=1)
    if is_homo(weights):
        w_bar = jnp.sum(w_bar, keepdims=True)
    return w_bar, indices, indptr, B


binary_csrmm_p = XLACustomKernel(
    'binary_csrmm',
    doc='Event-driven CSR SpMM (reference brainevent/_csr/binary.py:264).',
)
binary_csrmm_p.def_jax_kernel(_binary_csrmm_jax_kernel, asdefault=True)
binary_csrmm_p.def_jvp_rule2(
    _binary_csrmm_jvp_weights, None, None, _binary_csrmm_jvp_B)
binary_csrmm_p.def_transpose_rule(_binary_csrmm_transpose_rule)
binary_csrmm_p.def_general_batching()
binary_csrmm_p.def_tags('csr', 'binary', 'mm')


def binary_csrmm_p_call(weights, indices, indptr, B, *,
                        shape, transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    csr_checks(weights, indices, indptr, shape)
    m, k = shape
    assert B.ndim == 2
    exp_in = m if transpose else k
    assert B.shape[0] == exp_in
    out_rows = k if transpose else m
    return binary_csrmm_p(
        weights, indices, indptr, B,
        outs=[jax.ShapeDtypeStruct((out_rows, B.shape[1]), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        matrix_info=jax.ShapeDtypeStruct(B.shape, B.dtype),
    )


binary_csrmm_p.def_call(binary_csrmm_p_call)


@namescope(name='binary_csrmm', static_argnames=('shape', 'transpose', 'backend'))
def _binary_csrmm_core(data, indices, indptr, B, *, shape,
                       transpose: bool = False, backend: Optional[str] = None):
    data, w_unit = split_mantissa_unit(data)
    B, b_unit = split_mantissa_unit(B)
    (out,) = binary_csrmm_p_call(data, indices, indptr, B, shape=shape,
                                 transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, b_unit)


def binary_csrmm(data, indices, indptr, B, *, shape, workspace=None,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven CSR SpMM (unit-aware); ``workspace`` is ignored."""
    del workspace
    return _binary_csrmm_core(data, indices, indptr, B, shape=shape,
                              transpose=transpose, backend=backend)


# =============================================================================
# Indexed (perm-fused) variants: weights gathered through ``perm`` in-kernel.
# Used for the unfavorable-direction product over a lazy CSC mirror whose
# data stays in CSR order (reference brainevent/_csr/binary_indexed.py:16-28).
# =============================================================================

binary_csrmv_indexed_p = XLACustomKernel(
    'binary_csrmv_indexed',
    doc='Event CSR SpMV with in-kernel weight permutation '
        '(reference brainevent/_csr/binary_indexed.py:70).',
)
binary_csrmv_indexed_p.def_jax_kernel(
    lambda **params: _binary_csrmv_jax_kernel(indexed=True, **params),
    asdefault=True)
binary_csrmv_indexed_p.def_general_batching()
binary_csrmv_indexed_p.def_tags('csr', 'binary', 'mv', 'indexed')


def binary_csrmv_indexed_p_call(weights, indices, indptr, perm, vector, *,
                                shape, transpose: bool = False,
                                backend: Optional[str] = None):
    """Low-level indexed SpMV call; ``weights[perm]`` are the effective
    per-slot weights of the (indices, indptr) structure."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    m, k = shape
    exp_in = m if transpose else k
    assert vector.shape == (exp_in,)
    out_len = k if transpose else m
    return binary_csrmv_indexed_p(
        weights, indices, indptr, perm, vector,
        outs=[jax.ShapeDtypeStruct((out_len,), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        vector_info=jax.ShapeDtypeStruct(vector.shape, vector.dtype),
    )


binary_csrmv_indexed_p.def_call(binary_csrmv_indexed_p_call)


@namescope(name='binary_csrmv_indexed',
           static_argnames=('shape', 'transpose', 'backend'))
def _binary_csrmv_indexed_core(data, indices, indptr, perm, v, *, shape,
                               transpose: bool = False,
                               backend: Optional[str] = None):
    data, w_unit = split_mantissa_unit(data)
    v, v_unit = split_mantissa_unit(v)
    (out,) = binary_csrmv_indexed_p_call(
        data, indices, indptr, perm, v, shape=shape,
        transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, v_unit)


def binary_csrmv_indexed(data, indices, indptr, perm, v, *, shape,
                         workspace=None, transpose: bool = False,
                         backend: Optional[str] = None):
    """Event CSR SpMV over a permuted-weight structure (unit-aware)."""
    del workspace
    return _binary_csrmv_indexed_core(data, indices, indptr, perm, v,
                                      shape=shape, transpose=transpose,
                                      backend=backend)


binary_csrmm_indexed_p = XLACustomKernel(
    'binary_csrmm_indexed',
    doc='Event CSR SpMM with in-kernel weight permutation '
        '(reference brainevent/_csr/binary_indexed.py:615).',
)
binary_csrmm_indexed_p.def_jax_kernel(
    lambda **params: _binary_csrmm_jax_kernel(indexed=True, **params),
    asdefault=True)
binary_csrmm_indexed_p.def_general_batching()
binary_csrmm_indexed_p.def_tags('csr', 'binary', 'mm', 'indexed')


def binary_csrmm_indexed_p_call(weights, indices, indptr, perm, B, *,
                                shape, transpose: bool = False,
                                backend: Optional[str] = None):
    """Low-level indexed SpMM call."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    m, k = shape
    exp_in = m if transpose else k
    assert B.ndim == 2 and B.shape[0] == exp_in
    out_rows = k if transpose else m
    return binary_csrmm_indexed_p(
        weights, indices, indptr, perm, B,
        outs=[jax.ShapeDtypeStruct((out_rows, B.shape[1]), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        matrix_info=jax.ShapeDtypeStruct(B.shape, B.dtype),
    )


binary_csrmm_indexed_p.def_call(binary_csrmm_indexed_p_call)


@namescope(name='binary_csrmm_indexed',
           static_argnames=('shape', 'transpose', 'backend'))
def _binary_csrmm_indexed_core(data, indices, indptr, perm, B, *, shape,
                               transpose: bool = False,
                               backend: Optional[str] = None):
    data, w_unit = split_mantissa_unit(data)
    B, b_unit = split_mantissa_unit(B)
    (out,) = binary_csrmm_indexed_p_call(
        data, indices, indptr, perm, B, shape=shape,
        transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, b_unit)


def binary_csrmm_indexed(data, indices, indptr, perm, B, *, shape,
                         workspace=None, transpose: bool = False,
                         backend: Optional[str] = None):
    """Event CSR SpMM over a permuted-weight structure (unit-aware)."""
    del workspace
    return _binary_csrmm_indexed_core(data, indices, indptr, perm, B,
                                      shape=shape, transpose=transpose,
                                      backend=backend)
