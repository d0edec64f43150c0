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

"""CSR row slicing (reference ``brainevent/_csr/slice.py``).

``csr_slice_rows`` extracts selected rows of a CSR matrix as a **dense**
``(len(rows), n_cols)`` matrix — static output shape, jit friendly. A
custom gradient primitive (``csr_slice_rows_grad_p``) maps dense cotangents
back onto the selected rows' nse slots.
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
    'csr_slice_rows', 'csr_slice_rows_p', 'csr_slice_rows_p_call',
    'csr_slice_rows_grad', 'csr_slice_rows_grad_p', 'csr_slice_rows_grad_p_call',
]


def _slice_rows_jax_kernel(*, shape, **params):
    n_cols = shape[1]
    nse = params['indices_info'].shape[0]
    homo = params['data_len'] == 1
    num_selected = params['num_selected']

    def kernel(data, indices, indptr, row_indices):
        rows = row_ids_from_indptr(indptr, nse)
        d = jnp.broadcast_to(data, (nse,)) if homo else data
        # Scatter only into the SELECTED rows' dense buffer: map each nse
        # slot to its position within row_indices (or drop), so memory is
        # O(num_selected x n_cols) — never the full dense matrix.
        n_rows = shape[0]
        sel_pos = jnp.full(n_rows, -1, dtype=jnp.int32).at[row_indices].set(
            jnp.arange(num_selected, dtype=jnp.int32), mode='drop')
        pos = sel_pos[rows]
        flat = pos * n_cols + indices.astype(jnp.int32)
        flat = jnp.where(pos >= 0, flat, num_selected * n_cols)
        dense = jnp.zeros(num_selected * n_cols, dtype=data.dtype
                          ).at[flat].add(jnp.where(pos >= 0, d, 0),
                                         mode='drop')
        return (dense.reshape(num_selected, n_cols),)

    return kernel


csr_slice_rows_p = XLACustomKernel(
    'csr_slice_rows',
    doc='Extract selected CSR rows as a dense submatrix '
        '(reference brainevent/_csr/slice.py:39).',
)
csr_slice_rows_p.def_jax_kernel(_slice_rows_jax_kernel, asdefault=True)
csr_slice_rows_p.def_general_batching()
csr_slice_rows_p.def_tags('csr', 'slice')


def csr_slice_rows_p_call(data, indices, indptr, row_indices, *,
                          shape, backend: Optional[str] = None):
    """Low-level slice call; returns ``[(num_selected, n_cols) dense]``.

    ``row_indices`` must not contain duplicates (the selected-rows scatter
    assigns each logical row one output slot); duplicate selections raise at
    trace time when the indices are concrete.
    """
    data = jnp.atleast_1d(jnp.asarray(data))
    row_indices = jnp.atleast_1d(jnp.asarray(row_indices))
    import numpy as _np
    if not isinstance(row_indices, jax.core.Tracer):
        arr = _np.asarray(row_indices)
        if len(_np.unique(arr)) != len(arr):
            raise ValueError(
                'csr_slice_rows requires unique row indices; got duplicates.')
    num_selected = row_indices.shape[0]
    return csr_slice_rows_p(
        data, indices, indptr, row_indices,
        outs=[jax.ShapeDtypeStruct((num_selected, shape[1]), data.dtype)],
        shape=tuple(shape), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        data_len=int(data.shape[0]),
        num_selected=int(num_selected),
    )


csr_slice_rows_p.def_call(csr_slice_rows_p_call)


def _slice_rows_jvp_data(d_dot, data, indices, indptr, row_indices, **params):
    return csr_slice_rows_p_call(d_dot, indices, indptr, row_indices,
                                 shape=params['shape'],
                                 backend=params.get('backend'))


def _slice_rows_transpose_rule(ct, data, indices, indptr, row_indices, **params):
    assert ad.is_undefined_primal(data)
    ct = ct[0]
    d_bar = csr_slice_rows_grad_p_call(
        ct, indices, indptr, row_indices,
        shape=params['shape'], data_len=params['data_len'],
        backend=params.get('backend'))[0]
    if params['data_len'] == 1:
        d_bar = jnp.sum(d_bar, keepdims=True)
    return d_bar, indices, indptr, row_indices


csr_slice_rows_p.def_jvp_rule2(_slice_rows_jvp_data, None, None, None)
csr_slice_rows_p.def_transpose_rule(_slice_rows_transpose_rule)


@namescope(name='csr_slice_rows', static_argnames=('shape', 'backend'))
def csr_slice_rows(data, indices, indptr, row_indices, *, shape,
                   backend: Optional[str] = None):
    """Dense submatrix of the selected CSR rows (unit-aware)."""
    data, unit = split_mantissa_unit(data)
    (out,) = csr_slice_rows_p_call(data, indices, indptr, row_indices,
                                   shape=shape, backend=backend)
    return maybe_unit(out, unit)


# =============================================================================
# gradient primitive: dense cotangent -> per-nse cotangent of selected rows
# =============================================================================

def _slice_rows_grad_jax_kernel(*, shape, data_len, **params):
    nse = params['indices_info'].shape[0]

    def kernel(ct, indices, indptr, row_indices):
        rows = row_ids_from_indptr(indptr, nse)
        # sel_pos[r] = position of logical row r within row_indices (or -1)
        n_rows = shape[0]
        sel_pos = jnp.full(n_rows, -1, dtype=jnp.int32).at[row_indices].set(
            jnp.arange(row_indices.shape[0], dtype=jnp.int32), mode='drop')
        pos = sel_pos[rows]
        valid = pos >= 0
        vals = ct[jnp.clip(pos, 0), indices]
        return (jnp.where(valid, vals, 0).astype(ct.dtype),)

    return kernel


csr_slice_rows_grad_p = XLACustomKernel(
    'csr_slice_rows_grad',
    doc='Gradient of csr_slice_rows: dense cotangent back to nse slots '
        '(reference brainevent/_csr/slice.py:300).',
)
csr_slice_rows_grad_p.def_jax_kernel(_slice_rows_grad_jax_kernel, asdefault=True)
csr_slice_rows_grad_p.def_general_batching()
csr_slice_rows_grad_p.def_tags('csr', 'slice', 'grad')


def csr_slice_rows_grad_p_call(ct, indices, indptr, row_indices, *,
                               shape, data_len: int = 0,
                               backend: Optional[str] = None):
    """Low-level slice-grad call; returns ``[(nse,) cotangent]``."""
    row_indices = jnp.atleast_1d(jnp.asarray(row_indices))
    return csr_slice_rows_grad_p(
        ct, indices, indptr, row_indices,
        outs=[jax.ShapeDtypeStruct(indices.shape, ct.dtype)],
        shape=tuple(shape), data_len=int(data_len), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


csr_slice_rows_grad_p.def_call(csr_slice_rows_grad_p_call)


def csr_slice_rows_grad(ct, indices, indptr, row_indices, *, shape,
                        backend: Optional[str] = None):
    """Map a dense slice cotangent back to per-nse values (unit-aware)."""
    ct, unit = split_mantissa_unit(ct)
    (out,) = csr_slice_rows_grad_p_call(ct, indices, indptr, row_indices,
                                        shape=shape, backend=backend)
    return maybe_unit(out, unit)
