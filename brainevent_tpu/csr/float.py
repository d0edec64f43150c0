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

"""Float CSR SpMV/SpMM (reference ``brainevent/_csr/float.py``).

``csrmv``: ``y = A @ v`` (or ``A.T @ v``) with ``A`` in CSR; ``csrmm`` is the
matrix version. These are the workhorses behind the AD rules of the binary
(event) products.

Formulation: both directions are a take over the nse axis followed by
:func:`brainevent_tpu.ops.scatter.event_scatter_add` — XLA's scatter-add,
which lowers to atomics on the GPU like the reference's CUDA hybrid
kernels.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._compat import ad
from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..ops.util import general_batching_rule
from ..ops.benchmark import BenchmarkConfig
from ..ops.scatter import event_scatter_add
from ..units import maybe_unit, split_mantissa_unit
from ._common import csr_checks, is_homo, row_ids_from_indptr

__all__ = [
    'csrmv', 'csrmv_p', 'csrmv_p_call',
    'csrmm', 'csrmm_p', 'csrmm_p_call',
]


# =============================================================================
# csrmv
# =============================================================================

def _csrmv_jax_kernel(*, shape, transpose, **params):
    m, k = shape
    nse = params['indices_info'].shape[0]
    out_dtype = params['outs'][0].dtype
    homo = params['weight_info'].shape[0] == 1

    def kernel(weights, indices, indptr, vector):
        rows = row_ids_from_indptr(indptr, nse)
        w = weights[0] if homo else weights
        v = vector.astype(out_dtype)
        if transpose:
            # y[k]: scatter over column indices
            contrib = w * v[rows]
            return (event_scatter_add(indices, contrib, k, dtype=out_dtype),)
        contrib = w * v[indices]
        return (event_scatter_add(rows, contrib, m, dtype=out_dtype),)

    return kernel


def _csrmv_jvp_weights(w_dot, weights, indices, indptr, vector, **params):
    return csrmv_p_call(w_dot, indices, indptr, vector,
                        shape=params['shape'], transpose=params['transpose'],
                        backend=params.get('backend'))


def _csrmv_jvp_vector(v_dot, weights, indices, indptr, vector, **params):
    return csrmv_p_call(weights, indices, indptr, v_dot,
                        shape=params['shape'], transpose=params['transpose'],
                        backend=params.get('backend'))


def _csrmv_transpose_rule(ct, weights, indices, indptr, vector, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(vector):
        v_bar = csrmv_p_call(
            weights, indices, indptr, ct,
            shape=shape, transpose=not transpose,
            backend=params.get('backend'))[0]
        return weights, indices, indptr, v_bar
    # d/dw: per-nse product of ct and v at the two endpoints.
    nse = indices.shape[0]
    w_aval = getattr(weights, 'aval', weights)   # UndefinedPrimal here
    if nse >= 500_000 and getattr(w_aval, 'size', 0) != 1:
        # the weight gradient is two per-nonzero gathers every call; warn
        # ONCE at trace time so a training loop on this path is never
        # silent about it
        import warnings
        warnings.warn(
            f'jax.grad w.r.t. CSR weights at nse={nse} gathers both '
            f'endpoints of every nonzero per call. Recurrent training '
            f'loops can use the fixed-degree ELL layout with its shared-'
            f'gather backward instead (models/training.ell_recurrent). '
            f'Silence with warnings.filterwarnings.',
            stacklevel=3)
    rows = row_ids_from_indptr(indptr, nse)
    if transpose:
        w_bar = vector[rows] * ct[indices]
    else:
        w_bar = ct[rows] * vector[indices]
    if is_homo(weights):
        w_bar = jnp.sum(w_bar, keepdims=True)
    return w_bar, indices, indptr, vector


def _csrmv_batching(args, axes, **params):
    if tuple(axes) == (None, None, None, 0) and args[3].ndim == 2:
        r = csrmm_p_call(args[0], args[1], args[2], args[3].T,
                         shape=params['shape'], transpose=params['transpose'],
                         backend=params.get('backend'))
        return r, [1]
    if tuple(axes) == (None, None, None, 1) and args[3].ndim == 2:
        r = csrmm_p_call(args[0], args[1], args[2], args[3],
                         shape=params['shape'], transpose=params['transpose'],
                         backend=params.get('backend'))
        return r, [1]
    return general_batching_rule(csrmv_p, args, axes, **params)


csrmv_p = XLACustomKernel(
    'csrmv',
    doc='Float CSR SpMV (reference brainevent/_csr/float.py:49).',
)
csrmv_p.def_jax_kernel(_csrmv_jax_kernel, asdefault=True)
csrmv_p.def_jvp_rule2(_csrmv_jvp_weights, None, None, _csrmv_jvp_vector)
csrmv_p.def_transpose_rule(_csrmv_transpose_rule)
csrmv_p.def_batching_rule(_csrmv_batching)
csrmv_p.def_tags('csr', 'float', 'mv')


def csrmv_p_call(weights, indices, indptr, vector, *,
                 shape, transpose: bool = False,
                 backend: Optional[str] = None):
    """Low-level primitive call. Returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    csr_checks(weights, indices, indptr, shape)
    m, k = shape
    out_len = k if transpose else m
    exp_in = m if transpose else k
    assert vector.shape == (exp_in,), (
        f'vector shape {vector.shape} != ({exp_in},) for transpose={transpose}')
    out_dtype = weights.dtype
    return csrmv_p(
        weights, indices, indptr, vector,
        outs=[jax.ShapeDtypeStruct((out_len,), out_dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        vector_info=jax.ShapeDtypeStruct(vector.shape, vector.dtype),
    )


csrmv_p.def_call(csrmv_p_call)


@namescope(name='csrmv', static_argnames=('shape', 'transpose', 'backend'))
def csrmv(data, indices, indptr, v, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float CSR matrix-vector product ``A @ v`` / ``A.T @ v`` (unit-aware)."""
    data, w_unit = split_mantissa_unit(data)
    v, v_unit = split_mantissa_unit(v)
    (out,) = csrmv_p_call(data, indices, indptr, v, shape=shape,
                          transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, v_unit)


def _csrmv_benchmark_data(*, platform):
    import numpy as np
    configs = []
    for n, conn in ((1000, 0.01), (1000, 0.1), (10000, 0.01)):
        nse = int(n * n * conn)
        rng = np.random.default_rng(0)
        indices = jnp.asarray(rng.integers(0, n, nse), dtype=jnp.int32)
        counts = np.full(n, nse // n)
        counts[: nse % n] += 1
        indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                             dtype=jnp.int32)
        w = jnp.asarray(rng.normal(size=nse), dtype=jnp.float32)
        v = jnp.asarray(rng.normal(size=n), dtype=jnp.float32)
        for transpose in (False, True):
            configs.append(BenchmarkConfig(
                f'n={n},conn={conn},{"T" if transpose else "NT"}',
                (w, indices, indptr, v),
                {'shape': (n, n), 'transpose': transpose}))
    return configs


csrmv_p.def_benchmark_data(_csrmv_benchmark_data)


# =============================================================================
# csrmm
# =============================================================================

def _csrmm_jax_kernel(*, shape, transpose, **params):
    m, k = shape
    nse = params['indices_info'].shape[0]
    out_dtype = params['outs'][0].dtype
    homo = params['weight_info'].shape[0] == 1

    def kernel(weights, indices, indptr, B):
        rows = row_ids_from_indptr(indptr, nse)
        w = weights[0] if homo else weights
        Bc = B.astype(out_dtype)
        w_col = w if homo else w[:, None]
        if transpose:
            # out[k, n] += w_j * B[row_j]
            contrib = w_col * Bc[rows]
            out = jnp.zeros((k, B.shape[1]), dtype=out_dtype)
            return (out.at[indices].add(contrib, mode='drop'),)
        contrib = w_col * Bc[indices]
        out = jnp.zeros((m, B.shape[1]), dtype=out_dtype)
        return (out.at[rows].add(contrib, mode='drop'),)

    return kernel


def _csrmm_jvp_weights(w_dot, weights, indices, indptr, B, **params):
    return csrmm_p_call(w_dot, indices, indptr, B,
                        shape=params['shape'], transpose=params['transpose'],
                        backend=params.get('backend'))


def _csrmm_jvp_B(B_dot, weights, indices, indptr, B, **params):
    return csrmm_p_call(weights, indices, indptr, B_dot,
                        shape=params['shape'], transpose=params['transpose'],
                        backend=params.get('backend'))


def _csrmm_transpose_rule(ct, weights, indices, indptr, B, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(B):
        B_bar = csrmm_p_call(
            weights, indices, indptr, ct,
            shape=shape, transpose=not transpose,
            backend=params.get('backend'))[0]
        return weights, indices, indptr, B_bar
    nse = indices.shape[0]
    rows = row_ids_from_indptr(indptr, nse)
    if transpose:
        w_bar = jnp.sum(B[rows] * ct[indices], axis=1)
    else:
        w_bar = jnp.sum(ct[rows] * B[indices], axis=1)
    if is_homo(weights):
        w_bar = jnp.sum(w_bar, keepdims=True)
    return w_bar, indices, indptr, B


csrmm_p = XLACustomKernel(
    'csrmm',
    doc='Float CSR SpMM (reference brainevent/_csr/float.py:559).',
)
csrmm_p.def_jax_kernel(_csrmm_jax_kernel, asdefault=True)
csrmm_p.def_jvp_rule2(_csrmm_jvp_weights, None, None, _csrmm_jvp_B)
csrmm_p.def_transpose_rule(_csrmm_transpose_rule)
csrmm_p.def_general_batching()
csrmm_p.def_tags('csr', 'float', 'mm')


def csrmm_p_call(weights, indices, indptr, B, *,
                 shape, transpose: bool = False,
                 backend: Optional[str] = None):
    """Low-level primitive call. Returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    csr_checks(weights, indices, indptr, shape)
    m, k = shape
    assert B.ndim == 2
    exp_in = m if transpose else k
    assert B.shape[0] == exp_in, (
        f'B.shape[0]={B.shape[0]} != {exp_in} for transpose={transpose}')
    out_rows = k if transpose else m
    return csrmm_p(
        weights, indices, indptr, B,
        outs=[jax.ShapeDtypeStruct((out_rows, B.shape[1]), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        matrix_info=jax.ShapeDtypeStruct(B.shape, B.dtype),
    )


csrmm_p.def_call(csrmm_p_call)


@namescope(name='csrmm', static_argnames=('shape', 'transpose', 'backend'))
def csrmm(data, indices, indptr, B, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float CSR matrix-matrix product ``A @ B`` / ``A.T @ B`` (unit-aware)."""
    data, w_unit = split_mantissa_unit(data)
    B, b_unit = split_mantissa_unit(B)
    (out,) = csrmm_p_call(data, indices, indptr, B, shape=shape,
                          transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, b_unit)
