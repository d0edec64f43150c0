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

"""Structure-indexed broadcast ("dense-trace to trace") ops
(reference ``brainevent/_csr/dt2t.py``).

For each structural non-zero ``j`` at ``(row, col)``:
``out[j] = w[j] * y[row]`` (non-transposed) or ``w[j] * y[col]``
(transposed). Used for per-synapse traces in plasticity models: a pure
gather + multiply over the nse axis, one fused pass.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._compat import ad
from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..units import maybe_unit, split_mantissa_unit
from ._common import row_ids_from_indptr

__all__ = [
    'csrmv_dt2t', 'cscmv_dt2t', 'csrmv_dt2t_p', 'csrmv_dt2t_p_call',
    'csrmm_dt2t', 'cscmm_dt2t', 'csrmm_dt2t_p', 'csrmm_dt2t_p_call',
]


def _dt2t_mv_jax_kernel(*, shape, transpose, **params):
    nse = params['indices_info'].shape[0]

    def kernel(y, w, indices, indptr):
        if transpose:
            src = y[indices]
        else:
            rows = row_ids_from_indptr(indptr, nse)
            src = y[rows]
        w_full = w[0] if w.shape[0] == 1 else w
        return (w_full * src.astype(params['outs'][0].dtype),)

    return kernel


def _dt2t_mv_jvp_y(y_dot, y, w, indices, indptr, **params):
    return csrmv_dt2t_p_call(y_dot, w, indices, indptr,
                             shape=params['shape'],
                             transpose=params['transpose'],
                             backend=params.get('backend'))


def _dt2t_mv_jvp_w(w_dot, y, w, indices, indptr, **params):
    return csrmv_dt2t_p_call(y, w_dot, indices, indptr,
                             shape=params['shape'],
                             transpose=params['transpose'],
                             backend=params.get('backend'))


def _dt2t_mv_transpose_rule(ct, y, w, indices, indptr, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    nse = indices.shape[0]
    rows = row_ids_from_indptr(indptr, nse)
    w_full = w[0] if (not ad.is_undefined_primal(w) and w.shape[0] == 1) else w
    if ad.is_undefined_primal(y):
        from ..ops.scatter import event_scatter_add
        contrib = w_full * ct
        tgt = indices if transpose else rows
        n = shape[1] if transpose else shape[0]
        return event_scatter_add(tgt, contrib, n, dtype=ct.dtype), w, indices, indptr
    src = y[indices] if transpose else y[rows]
    w_bar = ct * src
    w_len = w.aval.shape[0] if ad.is_undefined_primal(w) else w.shape[0]
    if w_len == 1:
        w_bar = jnp.sum(w_bar, keepdims=True)
    return y, w_bar, indices, indptr


csrmv_dt2t_p = XLACustomKernel(
    'csrmv_dt2t',
    doc='Per-nse broadcast out[j] = w[j] * y[row(j)] '
        '(reference brainevent/_csr/dt2t.py:42).',
)
csrmv_dt2t_p.def_jax_kernel(_dt2t_mv_jax_kernel, asdefault=True)
csrmv_dt2t_p.def_jvp_rule2(_dt2t_mv_jvp_y, _dt2t_mv_jvp_w, None, None)
csrmv_dt2t_p.def_transpose_rule(_dt2t_mv_transpose_rule)
csrmv_dt2t_p.def_general_batching()
csrmv_dt2t_p.def_tags('csr', 'dt2t')


def csrmv_dt2t_p_call(y, w, indices, indptr, *, shape,
                      transpose: bool = False,
                      backend: Optional[str] = None):
    """Low-level dt2t call; returns a one-element list of shape ``(nse,)``."""
    w = jnp.atleast_1d(jnp.asarray(w))
    exp = shape[1] if transpose else shape[0]
    assert y.shape == (exp,), f'y shape {y.shape} != ({exp},)'
    out_dtype = jnp.result_type(y.dtype, w.dtype)
    return csrmv_dt2t_p(
        y, w, indices, indptr,
        outs=[jax.ShapeDtypeStruct(indices.shape, out_dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


csrmv_dt2t_p.def_call(csrmv_dt2t_p_call)


@namescope(name='csrmv_dt2t', static_argnames=('shape', 'transpose', 'backend'))
def csrmv_dt2t(y, w, indices, indptr, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """``out[j] = w[j] * y[row(j)]`` (or ``y[col(j)]`` transposed); unit-aware."""
    y, y_unit = split_mantissa_unit(y)
    w, w_unit = split_mantissa_unit(w)
    (out,) = csrmv_dt2t_p_call(y, w, indices, indptr, shape=shape,
                               transpose=transpose, backend=backend)
    return maybe_unit(out, y_unit, w_unit)


def cscmv_dt2t(y, w, indices, indptr, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """CSC variant: CSC storage of ``A`` is the CSR storage of ``A.T``, so
    this is :func:`csrmv_dt2t` with flipped shape and direction."""
    m, k = shape
    return csrmv_dt2t(y, w, indices, indptr, shape=(k, m),
                      transpose=not transpose, backend=backend)


# =============================================================================
# mm variant: y is (n_units, n_batch); out[j, :] = w[j] * y[row(j), :]
# =============================================================================

def _dt2t_mm_jax_kernel(*, shape, transpose, **params):
    nse = params['indices_info'].shape[0]

    def kernel(y, w, indices, indptr):
        if transpose:
            src = y[indices]
        else:
            rows = row_ids_from_indptr(indptr, nse)
            src = y[rows]
        w_col = w[0] if w.shape[0] == 1 else w[:, None]
        return (w_col * src.astype(params['outs'][0].dtype),)

    return kernel


csrmm_dt2t_p = XLACustomKernel(
    'csrmm_dt2t',
    doc='Per-nse broadcast over batched traces: out[j, :] = w[j] * Y[row(j), :] '
        '(reference brainevent/_csr/dt2t.py:546).',
)
csrmm_dt2t_p.def_jax_kernel(_dt2t_mm_jax_kernel, asdefault=True)
csrmm_dt2t_p.def_general_batching()
csrmm_dt2t_p.def_tags('csr', 'dt2t', 'mm')


def csrmm_dt2t_p_call(y, w, indices, indptr, *, shape,
                      transpose: bool = False,
                      backend: Optional[str] = None):
    """Low-level batched dt2t; returns ``[(nse, n_batch)]``."""
    w = jnp.atleast_1d(jnp.asarray(w))
    exp = shape[1] if transpose else shape[0]
    assert y.ndim == 2 and y.shape[0] == exp
    out_dtype = jnp.result_type(y.dtype, w.dtype)
    return csrmm_dt2t_p(
        y, w, indices, indptr,
        outs=[jax.ShapeDtypeStruct((indices.shape[0], y.shape[1]), out_dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


csrmm_dt2t_p.def_call(csrmm_dt2t_p_call)


@namescope(name='csrmm_dt2t', static_argnames=('shape', 'transpose', 'backend'))
def csrmm_dt2t(y, w, indices, indptr, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """Batched dt2t ``out[j, :] = w[j] * Y[row(j), :]`` (unit-aware)."""
    y, y_unit = split_mantissa_unit(y)
    w, w_unit = split_mantissa_unit(w)
    (out,) = csrmm_dt2t_p_call(y, w, indices, indptr, shape=shape,
                               transpose=transpose, backend=backend)
    return maybe_unit(out, y_unit, w_unit)


def cscmm_dt2t(y, w, indices, indptr, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """CSC variant of :func:`csrmm_dt2t` (flipped shape + direction)."""
    m, k = shape
    return csrmm_dt2t(y, w, indices, indptr, shape=(k, m),
                      transpose=not transpose, backend=backend)
