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

"""CSR/CSC sparse matrices with event-driven matmul dispatch
(reference ``brainevent/_csr/main.py``).

Both classes are pytrees whose ``@`` operator routes to the float or
event-driven primitives depending on the operand type. A CSR matrix lazily
caches its CSC mirror structure (``build_weight_indices``) for
unfavorable-direction products and post-driven plasticity.

Deviation from the reference: no binary task workspaces are attached to
matrices (the CUDA hybrid-kernel machinery of
``brainevent/_csr/main.py:60-175``); the scatter direction is XLA's scatter-add
(:mod:`brainevent_tpu.ops.scatter`).
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._data import DataRepresentation
from .._error import MathError, UnsupportedOperationError
from .._misc import csr_to_coo_index, csr_to_csc_index
from ..events.base import EventRepresentation, extract_raw_value
from ..events.compact_binary import CompactBinary
from ..units import get_mantissa, split_mantissa_unit, maybe_unit
from .binary import (
    binary_csrmv, binary_csrmm,
)
from .float import csrmv, csrmm
from .dt2t import csrmv_dt2t, csrmm_dt2t
from .plasticity import update_csr_on_binary_pre, update_csr_on_binary_post
from .slice import csr_slice_rows
from .diag_add import csr_diag_position, csr_diag_add
from .spsolve import csr_solve

__all__ = ['CompressedSparseData', 'CSR', 'CSC']


def _is_event(x) -> bool:
    return isinstance(x, (EventRepresentation, CompactBinary))


class CompressedSparseData(DataRepresentation):
    """Shared machinery of :class:`CSR` and :class:`CSC`
    (reference ``brainevent/_csr/main.py:182``).

    Stores ``(data, indices, indptr)`` plus an optional cached transpose
    mirror ``(t_indptr, t_indices, t_perm)`` built by
    :meth:`build_weight_indices`.
    """

    def __init__(self, args, *, shape: Tuple[int, int]):
        data, indices, indptr = args
        super().__init__(shape)
        data = jnp.atleast_1d(data) if not isinstance(
            data, np.ndarray) else np.atleast_1d(data)
        self.register_buffer('data', data)
        self.register_buffer('indices', jnp.asarray(indices))
        self.register_buffer('indptr', jnp.asarray(indptr))
        self.register_buffer('_t_indptr', None)
        self.register_buffer('_t_indices', None)
        self.register_buffer('_t_perm', None)

    # -- structure ---------------------------------------------------------

    @property
    def nse(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self):
        return get_mantissa(self.data).dtype

    def tree_flatten(self):
        children = (self.data, self.indices, self.indptr,
                    self._t_indptr, self._t_indices, self._t_perm)
        return children, (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = cls.__new__(cls)
        obj.shape = aux_data[0]
        obj._buffers = dict(zip(
            ('data', 'indices', 'indptr', '_t_indptr', '_t_indices', '_t_perm'),
            children))
        return obj

    def _new(self, data, indices=None, indptr=None):
        obj = type(self)(
            (data,
             self.indices if indices is None else indices,
             self.indptr if indptr is None else indptr),
            shape=self.shape)
        obj._buffers['_t_indptr'] = self._t_indptr
        obj._buffers['_t_indices'] = self._t_indices
        obj._buffers['_t_perm'] = self._t_perm
        return obj

    def with_data(self, data):
        """Same structure, new values."""
        assert get_mantissa(data).shape in ((1,), (self.nse,)), (
            f'data shape {get_mantissa(data).shape} incompatible with nse '
            f'{self.nse}')
        return self._new(data)

    # -- elementwise algebra -------------------------------------------------

    def apply(self, fn):
        return self._new(fn(self.data))

    def apply2(self, other, fn, *, reverse: bool = False):
        if isinstance(other, CompressedSparseData):
            if other.shape != self.shape or other.nse != self.nse:
                raise MathError(
                    'Elementwise ops between sparse matrices require '
                    'identical structure.')
            other = other.data
        if hasattr(other, 'ndim') and getattr(other, 'ndim', 0) > 0 \
                and not isinstance(other, (int, float)):
            other_m = get_mantissa(other)
            if other_m.ndim > 1 or other_m.shape not in ((1,), (self.nse,)):
                raise UnsupportedOperationError(
                    'Elementwise ops on sparse matrices accept scalars, '
                    '(1,)/(nse,) arrays, or same-structure matrices.')
        if reverse:
            return self._new(fn(other, self.data))
        return self._new(fn(self.data, other))

    # -- transpose mirror ------------------------------------------------------

    def build_weight_indices(self):
        """Build and cache the transpose mirror structure
        ``(t_indptr, t_indices, perm)`` with ``data[perm]`` giving the
        mirror's values (reference ``brainevent/_csr/main.py:1359``).
        Returns self (chainable)."""
        if self._t_perm is None:
            t_indptr, t_indices, perm = csr_to_csc_index(
                self.indptr, self.indices, shape=self._csr_shape())
            self._buffers['_t_indptr'] = t_indptr
            self._buffers['_t_indices'] = t_indices
            self._buffers['_t_perm'] = perm
        return self

    @property
    def weight_indices(self):
        """Permutation mapping mirror slots to data slots (or ``None``)."""
        return self._t_perm

    def _csr_shape(self) -> Tuple[int, int]:
        """Logical shape of the row-compressed view stored in (indices,
        indptr): ``shape`` for CSR, reversed for CSC."""
        raise NotImplementedError

    # -- solving -----------------------------------------------------------------

    def diag_add(self, other):
        """Add a scalar/vector onto the stored diagonal."""
        data, unit = split_mantissa_unit(self.data)
        other, _ = split_mantissa_unit(other)
        if data.shape[0] == 1:
            data = jnp.broadcast_to(data, (self.nse,))
        m, k = self._csr_shape()
        positions = csr_diag_position(self.indptr, self.indices, shape=(m, k))
        return self._new(maybe_unit(csr_diag_add(data, positions, other), unit))


@jax.tree_util.register_pytree_node_class
class CSR(CompressedSparseData):
    """Compressed Sparse Row matrix (reference ``brainevent/_csr/main.py:977``).

    Examples
    --------
    >>> import jax.numpy as jnp
    >>> import brainevent_tpu as be
    >>> A = be.CSR.fromdense(jnp.array([[1., 0.], [0., 2.]]))
    >>> A @ jnp.ones(2)
    Array([1., 2.], dtype=float32)
    >>> spk = be.BinaryArray(jnp.array([True, False]))
    >>> spk @ A  # event-driven product
    Array([1., 0.], dtype=float32)
    """

    def _csr_shape(self):
        return self.shape

    # -- construction / conversion ------------------------------------------

    @classmethod
    def fromdense(cls, mat, *, nse=None, index_dtype=jnp.int32) -> 'CSR':
        """Build from a dense matrix (host/trace-time structure extraction)."""
        mat_m, unit = split_mantissa_unit(mat)
        with jax.ensure_compile_time_eval():
            mat_np = np.asarray(mat_m)
            if mat_np.ndim != 2:
                raise MathError(f'fromdense needs a 2D matrix, got {mat_np.ndim}D.')
            rows, cols = np.nonzero(mat_np)
            if nse is not None and len(rows) != nse:
                rows, cols = rows[:nse], cols[:nse]
            data = jnp.asarray(mat_np[rows, cols])
            indices = jnp.asarray(cols, dtype=index_dtype)
            counts = np.bincount(rows, minlength=mat_np.shape[0])
            indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                                 dtype=index_dtype)
        return cls((maybe_unit(data, unit), indices, indptr),
                   shape=tuple(mat_np.shape))

    def todense(self):
        data, unit = split_mantissa_unit(self.data)
        rows, cols = csr_to_coo_index(self.indptr, self.indices)
        d = jnp.broadcast_to(data, (self.nse,)) if data.shape[0] == 1 else data
        dense = jnp.zeros(self.shape, dtype=d.dtype).at[rows, cols].add(d)
        return maybe_unit(dense, unit)

    def tocsr(self) -> 'CSR':
        return self

    def tocsc(self) -> 'CSC':
        """Convert to CSC (same logical matrix, column-compressed storage)."""
        self.build_weight_indices()
        data, unit = split_mantissa_unit(self.data)
        d = data if data.shape[0] == 1 else data[self._t_perm]
        return CSC((maybe_unit(d, unit), self._t_indices, self._t_indptr),
                   shape=self.shape)

    def tocoo(self):
        """Return a ``jax.experimental.sparse.BCOO`` of the same matrix."""
        from jax.experimental import sparse as jsparse
        rows, cols = csr_to_coo_index(self.indptr, self.indices)
        data, unit = split_mantissa_unit(self.data)
        d = jnp.broadcast_to(data, (self.nse,)) if data.shape[0] == 1 else data
        coo = jsparse.BCOO((d, jnp.stack([rows, cols], axis=1)),
                           shape=self.shape)
        return coo if unit is None else (coo, unit)

    def transpose(self, axes=None) -> 'CSC':
        """Zero-copy transpose: the same buffers viewed as CSC of ``A.T``."""
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        obj = CSC((self.data, self.indices, self.indptr),
                  shape=(self.shape[1], self.shape[0]))
        obj._buffers['_t_indptr'] = self._t_indptr
        obj._buffers['_t_indices'] = self._t_indices
        obj._buffers['_t_perm'] = self._t_perm
        return obj

    # -- plasticity --------------------------------------------------------------

    def update_on_pre(self, pre_spike, post_trace, w_min=None, w_max=None) -> 'CSR':
        pre_spike = extract_raw_value(pre_spike)
        new_data = update_csr_on_binary_pre(
            self.data, self.indices, self.indptr, pre_spike, post_trace,
            w_min, w_max, shape=self.shape)
        return self._new(new_data)

    def update_on_post(self, pre_trace, post_spike, w_min=None, w_max=None) -> 'CSR':
        post_spike = extract_raw_value(post_spike)
        new_data = update_csr_on_binary_post(
            self.data, self.indices, self.indptr, self.weight_indices,
            pre_trace, post_spike, w_min, w_max, shape=self.shape)
        return self._new(new_data)

    # -- slicing / solving ----------------------------------------------------------

    def slice_rows(self, index):
        """Dense submatrix of the selected rows."""
        from .._misc import normalize_row_index
        index = normalize_row_index(index, self.shape[0])
        return csr_slice_rows(self.data, self.indices, self.indptr, index,
                              shape=self.shape)

    def __getitem__(self, index):
        return self.slice_rows(index)

    def solve(self, b, tol=1e-6, reorder=1):
        """Solve ``A x = b``."""
        data, unit = split_mantissa_unit(self.data)
        b_m, b_unit = split_mantissa_unit(b)
        d = jnp.broadcast_to(data, (self.nse,)) if data.shape[0] == 1 else data
        out = csr_solve(d, self.indices, self.indptr, b_m, tol=tol, reorder=reorder)
        if unit is None:
            return maybe_unit(out, b_unit)
        return maybe_unit(out, b_unit, 1 / unit) if b_unit is not None else out

    # -- dt2t ------------------------------------------------------------------------

    def dt2t(self, y, transpose: bool = False):
        """Per-synapse broadcast ``out[j] = data[j] * y[row(j)]``."""
        return csrmv_dt2t(y, self.data, self.indices, self.indptr,
                          shape=self.shape, transpose=transpose)

    def dt2t_transposed(self, y):
        return self.dt2t(y, transpose=True)

    def dt2t_batch(self, Y, transpose: bool = False):
        """Batched dt2t over ``(n_units, n_batch)`` traces."""
        return csrmm_dt2t(Y, self.data, self.indices, self.indptr,
                          shape=self.shape, transpose=transpose)

    # -- products -------------------------------------------------------------------

    def __matmul__(self, other):
        # A @ x
        if _is_event(other):
            ev = extract_raw_value(other.value if isinstance(other, CompactBinary)
                                   else other)
            if ev.ndim == 1:
                return binary_csrmv(self.data, self.indices, self.indptr, ev,
                                    shape=self.shape, transpose=False)
            return binary_csrmm(self.data, self.indices, self.indptr, ev,
                                shape=self.shape, transpose=False)
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return csrmv(self.data, self.indices, self.indptr, other,
                         shape=self.shape, transpose=False)
        return csrmm(self.data, self.indices, self.indptr, other,
                     shape=self.shape, transpose=False)

    def __rmatmul__(self, other):
        # x @ A  ==  (A.T @ x.T).T ; 1-D: A.T @ x  (the scatter direction)
        if _is_event(other):
            ev = extract_raw_value(other.value if isinstance(other, CompactBinary)
                                   else other)
            if ev.ndim == 1:
                return binary_csrmv(self.data, self.indices, self.indptr, ev,
                                    shape=self.shape, transpose=True)
            return binary_csrmm(self.data, self.indices, self.indptr, ev.T,
                                shape=self.shape, transpose=True).T
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return csrmv(self.data, self.indices, self.indptr, other,
                         shape=self.shape, transpose=True)
        return csrmm(self.data, self.indices, self.indptr, other.T,
                     shape=self.shape, transpose=True).T

    def __repr__(self):
        return f'CSR(shape={self.shape}, nse={self.nse}, dtype={self.dtype})'


@jax.tree_util.register_pytree_node_class
class CSC(CompressedSparseData):
    """Compressed Sparse Column matrix
    (reference ``brainevent/_csr/main.py:1890``).

    Stored as the CSR arrays of ``A.T``: ``indptr`` runs over columns of the
    logical ``(m, k)`` matrix, ``indices`` holds row ids.
    """

    def _csr_shape(self):
        return (self.shape[1], self.shape[0])

    @classmethod
    def fromdense(cls, mat, *, nse=None, index_dtype=jnp.int32) -> 'CSC':
        mat_m, unit = split_mantissa_unit(mat)
        with jax.ensure_compile_time_eval():
            csr_t = CSR.fromdense(jnp.asarray(np.asarray(mat_m)).T, nse=nse,
                                  index_dtype=index_dtype)
        return cls((maybe_unit(csr_t.data, unit), csr_t.indices, csr_t.indptr),
                   shape=tuple(np.asarray(mat_m).shape))

    def todense(self):
        t = CSR((self.data, self.indices, self.indptr),
                shape=self._csr_shape()).todense()
        return t.T

    def tocsc(self) -> 'CSC':
        return self

    def tocsr(self) -> 'CSR':
        self.build_weight_indices()
        data, unit = split_mantissa_unit(self.data)
        d = data if data.shape[0] == 1 else data[self._t_perm]
        return CSR((maybe_unit(d, unit), self._t_indices, self._t_indptr),
                   shape=self.shape)

    def tocoo(self):
        return self.tocsr().tocoo()

    def transpose(self, axes=None) -> 'CSR':
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        obj = CSR((self.data, self.indices, self.indptr),
                  shape=(self.shape[1], self.shape[0]))
        obj._buffers['_t_indptr'] = self._t_indptr
        obj._buffers['_t_indices'] = self._t_indices
        obj._buffers['_t_perm'] = self._t_perm
        return obj

    # -- plasticity (CSC orientation) ---------------------------------------

    def update_on_pre(self, pre_spike, post_trace, w_min=None, w_max=None) -> 'CSC':
        from .plasticity import update_csc_on_binary_pre
        pre_spike = extract_raw_value(pre_spike)
        new_data = update_csc_on_binary_pre(
            self.data, self.indices, self.indptr, pre_spike, post_trace,
            w_min, w_max, shape=self.shape)
        return self._new(new_data)

    def update_on_post(self, pre_trace, post_spike, w_min=None, w_max=None) -> 'CSC':
        from .plasticity import update_csc_on_binary_post
        post_spike = extract_raw_value(post_spike)
        new_data = update_csc_on_binary_post(
            self.data, self.indices, self.indptr, pre_trace, post_spike,
            w_min, w_max, shape=self.shape)
        return self._new(new_data)

    def slice_rows(self, index):
        """Dense submatrix of selected (logical) rows: slice columns of the
        stored transpose."""
        return self.tocsr().slice_rows(index)

    def solve(self, b, tol=1e-6, reorder=1):
        return self.tocsr().solve(b, tol=tol, reorder=reorder)

    def dt2t(self, y, transpose: bool = False):
        """Per-synapse broadcast over the CSC structure:
        ``out[s] = data[s] * y[col(s)]`` (non-transposed)."""
        from .dt2t import cscmv_dt2t
        return cscmv_dt2t(y, self.data, self.indices, self.indptr,
                          shape=self.shape, transpose=transpose)

    def dt2t_transposed(self, y):
        return self.dt2t(y, transpose=True)

    # -- products: A is (m, k); stored arrays are CSR of A.T (k, m) -----------

    def __matmul__(self, other):
        m, k = self.shape
        if _is_event(other):
            ev = extract_raw_value(other.value if isinstance(other, CompactBinary)
                                   else other)
            if ev.ndim == 1:
                return binary_csrmv(self.data, self.indices, self.indptr, ev,
                                    shape=(k, m), transpose=True)
            return binary_csrmm(self.data, self.indices, self.indptr, ev,
                                shape=(k, m), transpose=True)
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return csrmv(self.data, self.indices, self.indptr, other,
                         shape=(k, m), transpose=True)
        return csrmm(self.data, self.indices, self.indptr, other,
                     shape=(k, m), transpose=True)

    def __rmatmul__(self, other):
        m, k = self.shape
        if _is_event(other):
            ev = extract_raw_value(other.value if isinstance(other, CompactBinary)
                                   else other)
            if ev.ndim == 1:
                return binary_csrmv(self.data, self.indices, self.indptr, ev,
                                    shape=(k, m), transpose=False)
            return binary_csrmm(self.data, self.indices, self.indptr, ev.T,
                                shape=(k, m), transpose=False).T
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return csrmv(self.data, self.indices, self.indptr, other,
                         shape=(k, m), transpose=False)
        return csrmm(self.data, self.indices, self.indptr, other.T,
                     shape=(k, m), transpose=False).T

    def __repr__(self):
        return f'CSC(shape={self.shape}, nse={self.nse}, dtype={self.dtype})'
