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

"""Fixed-number-connectivity (ELL) data structures
(reference ``brainevent/_fcn/main.py``).

:class:`FixedNumPerPre` stores, per presynaptic row, a fixed number of
postsynaptic targets — the natural format for biological "fixed out-degree"
random connectivity and the storage behind event-driven EI networks.
:class:`FixedNumPerPost` is the post-grouped mirror (fixed in-degree). Both
describe a logical ``(n_pre, n_post)`` matrix; ``transpose()`` flips between
them zero-copy.

ELL is naturally accelerator-friendly: the ``(rows, n_conn)`` rectangles are
static-shape gathers/scatters with no indptr indirection.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._data import DataRepresentation
from .._error import MathError
from ..events.base import EventRepresentation, extract_raw_value
from ..events.compact_binary import CompactBinary
from ..units import get_mantissa, split_mantissa_unit, maybe_unit
from .binary import binary_fcnmv, binary_fcnmm
from .float import fcnmv, fcnmm, fcnmv_dt2t
from .plasticity import (
    update_fixed_post_conn_on_binary_pre,
    update_fixed_pre_conn_on_binary_post,
)

__all__ = ['FixedNumConn', 'FixedNumPerPre', 'FixedNumPerPost']


def _is_event(x) -> bool:
    return isinstance(x, (EventRepresentation, CompactBinary))


def _event_value(x):
    return extract_raw_value(x.value if isinstance(x, CompactBinary) else x)


class FixedNumConn(DataRepresentation):
    """Base class of fixed-number connectivity matrices
    (reference ``brainevent/_fcn/main.py:199``).

    Stores ``indices`` of shape ``(n_rows_ell, n_conn)`` and ``data`` of
    shape ``(1,)`` (homogeneous) or ``indices.shape``. The subclass decides
    whether ELL rows are presynaptic (:class:`FixedNumPerPre`) or
    postsynaptic (:class:`FixedNumPerPost`) units of the logical
    ``(n_pre, n_post)`` matrix.
    """

    def __init__(self, args, *, shape: Tuple[int, int]):
        data, indices = args
        super().__init__(shape)
        indices = jnp.asarray(indices)
        if indices.ndim != 2:
            raise MathError(f'indices must be (rows, n_conn), got {indices.ndim}D.')
        data_m = get_mantissa(data)
        if not (np.shape(data_m) in ((1,), tuple(indices.shape)) or
                np.ndim(data_m) == 0):
            raise MathError(
                f'data must be scalar, (1,), or {tuple(indices.shape)}, got '
                f'{np.shape(data_m)}.')
        if np.ndim(data_m) == 0:
            data = jnp.asarray(data)[None] if not hasattr(data, 'reshape') \
                else data.reshape(1)
        self.register_buffer('data', data)
        self.register_buffer('indices', indices)
        if self._ell_rows() != indices.shape[0]:
            raise MathError(
                f'indices rows ({indices.shape[0]}) must equal '
                f'{self._ell_rows()} for {type(self).__name__} with shape '
                f'{shape}.')

    # -- orientation hooks (reference _fcn/main.py:253-260) -----------------

    def _ell_rows(self) -> int:
        """Number of ELL rows (n_pre for PerPre, n_post for PerPost)."""
        raise NotImplementedError

    def _ell_shape(self) -> Tuple[int, int]:
        """Logical shape of the row-oriented ELL view."""
        raise NotImplementedError

    @property
    def n_conn(self) -> int:
        return self.indices.shape[1]

    @property
    def nse(self) -> int:
        return self.indices.size

    @property
    def dtype(self):
        return get_mantissa(self.data).dtype

    # -- pytree ----------------------------------------------------------------

    def tree_flatten(self):
        return (self.data, self.indices), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = cls.__new__(cls)
        obj.shape = aux_data[0]
        obj._buffers = {'data': children[0], 'indices': children[1]}
        return obj

    def with_data(self, data):
        return type(self)((data, self.indices), shape=self.shape)

    def apply(self, fn):
        return self.with_data(fn(self.data))

    def apply2(self, other, fn, *, reverse: bool = False):
        if isinstance(other, FixedNumConn):
            other = other.data
        if reverse:
            return self.with_data(fn(other, self.data))
        return self.with_data(fn(self.data, other))

    # -- conversions (shared) ------------------------------------------------------

    def _ell_dense(self):
        """Dense matrix of the row-oriented ELL view."""
        data, unit = split_mantissa_unit(self.data)
        rows_n, n_conn = self.indices.shape
        cols = self._ell_shape()[1]
        d = (jnp.broadcast_to(data, self.indices.shape)
             if data.shape == (1,) else data)
        rows = jnp.repeat(jnp.arange(rows_n), n_conn,
                          total_repeat_length=rows_n * n_conn)
        dense = jnp.zeros((rows_n, cols), dtype=d.dtype).at[
            rows, self.indices.reshape(-1)].add(d.reshape(-1))
        return maybe_unit(dense, unit)

    def tocoo(self):
        """Return a ``jax.experimental.sparse.BCOO`` of the logical matrix."""
        return self.tocsr().tocoo()

    def tocsr(self):
        """Convert to :class:`~brainevent_tpu.CSR` (host/trace-time)."""
        from ..csr.main import CSR
        return CSR.fromdense(self.todense())

    def tocsc(self):
        """Convert to :class:`~brainevent_tpu.CSC` (host/trace-time)."""
        from ..csr.main import CSC
        return CSC.fromdense(self.todense())

    def __repr__(self):
        return (f'{type(self).__name__}(shape={self.shape}, '
                f'n_conn={self.n_conn}, dtype={self.dtype})')


@jax.tree_util.register_pytree_node_class
class FixedNumPerPre(FixedNumConn):
    """Fixed out-degree connectivity: ``indices[i, :]`` are the postsynaptic
    targets of presynaptic neuron ``i``
    (reference ``brainevent/_fcn/main.py:781``).

    Logical matrix ``A`` is ``(n_pre, n_post)`` with
    ``A[i, indices[i,k]] += data[i,k]``.
    """

    def _ell_rows(self):
        return self.shape[0]

    def _ell_shape(self):
        return self.shape

    @classmethod
    def fromdense(cls, mat, *, num_conn=None, backend=None) -> 'FixedNumPerPre':
        """Build from a dense matrix whose rows all have the same nnz."""
        del backend
        mat_m, unit = split_mantissa_unit(mat)
        with jax.ensure_compile_time_eval():
            mat_np = np.asarray(mat_m)
            counts = (mat_np != 0).sum(axis=1)
            k = int(counts[0]) if num_conn is None else int(num_conn)
            if not (counts == k).all():
                raise MathError(
                    'FixedNumPerPre.fromdense requires every row to have '
                    f'exactly {k} non-zeros; got counts in '
                    f'[{counts.min()}, {counts.max()}].')
            indices = np.zeros((mat_np.shape[0], k), np.int32)
            data = np.zeros((mat_np.shape[0], k), mat_np.dtype)
            for i in range(mat_np.shape[0]):
                cols = np.nonzero(mat_np[i])[0][:k]
                indices[i] = cols
                data[i] = mat_np[i, cols]
        return cls((maybe_unit(jnp.asarray(data), unit), jnp.asarray(indices)),
                   shape=tuple(mat_np.shape))

    def todense(self):
        return self._ell_dense()

    def transpose(self, axes=None) -> 'FixedNumPerPost':
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        return FixedNumPerPost((self.data, self.indices),
                               shape=(self.shape[1], self.shape[0]))

    def slice_rows(self, index) -> 'FixedNumPerPre':
        obj = FixedNumPerPre.__new__(FixedNumPerPre)
        data = self.data if get_mantissa(self.data).shape == (1,) \
            else self.data[index]
        idx = self.indices[index]
        obj.shape = (idx.shape[0], self.shape[1])
        obj._buffers = {'data': data, 'indices': idx}
        return obj

    # -- plasticity -----------------------------------------------------------

    def update_on_pre(self, pre_spike, post_trace, w_min=None, w_max=None):
        pre_spike = _event_value(pre_spike) if _is_event(pre_spike) else pre_spike
        return self.with_data(update_fixed_post_conn_on_binary_pre(
            self.data, self.indices, pre_spike, post_trace, w_min, w_max))

    def update_on_post(self, pre_trace, post_spike, w_min=None, w_max=None):
        # post-driven update on pre-grouped storage: per (i, k):
        # w += pre_trace[i] * gate(post_spike[indices[i, k]])
        post_spike = _event_value(post_spike) if _is_event(post_spike) else post_spike
        data, unit = split_mantissa_unit(self.data)
        trace, _ = split_mantissa_unit(pre_trace)
        gate = (post_spike.astype(data.dtype) if post_spike.dtype == jnp.bool_
                else (post_spike > 0).astype(data.dtype))
        d = jnp.broadcast_to(data, self.indices.shape) if data.shape == (1,) \
            else data
        out = d + trace[:, None].astype(d.dtype) * gate[self.indices]
        if w_min is not None or w_max is not None:
            w_min_m, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
            w_max_m, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
            out = jnp.clip(out, w_min_m, w_max_m)
        return self.with_data(maybe_unit(out, unit))

    # -- dt2t -------------------------------------------------------------------

    def dt2t(self, y, transpose: bool = False):
        return fcnmv_dt2t(y, self.data, self.indices, shape=self.shape,
                          transpose=transpose)

    def dt2t_transposed(self, y):
        return self.dt2t(y, transpose=True)

    # -- products ------------------------------------------------------------------
    # A @ v: gather (favorable); s @ A: event scatter (compact kernel).

    def __matmul__(self, other):
        if _is_event(other):
            ev = _event_value(other)
            op = binary_fcnmv if ev.ndim == 1 else binary_fcnmm
            return op(self.data, self.indices, ev, shape=self.shape,
                      transpose=False)
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return fcnmv(self.data, self.indices, other, shape=self.shape,
                         transpose=False)
        return fcnmm(self.data, self.indices, other, shape=self.shape,
                     transpose=False)

    def __rmatmul__(self, other):
        if _is_event(other):
            ev = _event_value(other)
            if ev.ndim == 1:
                return binary_fcnmv(self.data, self.indices, ev,
                                    shape=self.shape, transpose=True)
            return binary_fcnmm(self.data, self.indices, ev.T,
                                shape=self.shape, transpose=True).T
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return fcnmv(self.data, self.indices, other, shape=self.shape,
                         transpose=True)
        return fcnmm(self.data, self.indices, other.T, shape=self.shape,
                     transpose=True).T


@jax.tree_util.register_pytree_node_class
class FixedNumPerPost(FixedNumConn):
    """Fixed in-degree connectivity: ``indices[j, :]`` are the presynaptic
    sources of postsynaptic neuron ``j``
    (reference ``brainevent/_fcn/main.py:1042``).

    Logical matrix ``A`` is ``(n_pre, n_post)`` with
    ``A[indices[j,k], j] += data[j,k]``. The stored ELL is the row view of
    ``A.T``.
    """

    def _ell_rows(self):
        return self.shape[1]

    def _ell_shape(self):
        return (self.shape[1], self.shape[0])

    @classmethod
    def fromdense(cls, mat, *, num_conn=None, backend=None) -> 'FixedNumPerPost':
        """Build from a dense matrix whose columns all have the same nnz."""
        t = FixedNumPerPre.fromdense(mat.T, num_conn=num_conn, backend=backend)
        return cls((t.data, t.indices), shape=(t.shape[1], t.shape[0]))

    def todense(self):
        return self._ell_dense().T

    def transpose(self, axes=None) -> 'FixedNumPerPre':
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        return FixedNumPerPre((self.data, self.indices),
                              shape=(self.shape[1], self.shape[0]))

    def slice_rows(self, index):
        """Dense submatrix of the selected logical rows (pre neurons)."""
        return self.tocsr().slice_rows(index)

    def update_on_pre(self, pre_spike, post_trace, w_min=None, w_max=None):
        # pre-driven update on post-grouped storage: per (j, k):
        # w[j,k] += gate(pre_spike[indices[j,k]]) * post_trace[j]
        pre_spike = _event_value(pre_spike) if _is_event(pre_spike) else pre_spike
        data, unit = split_mantissa_unit(self.data)
        trace, _ = split_mantissa_unit(post_trace)
        gate = (pre_spike.astype(data.dtype) if pre_spike.dtype == jnp.bool_
                else (pre_spike > 0).astype(data.dtype))
        d = jnp.broadcast_to(data, self.indices.shape) if data.shape == (1,) \
            else data
        out = d + gate[self.indices] * trace[:, None].astype(d.dtype)
        if w_min is not None or w_max is not None:
            w_min_m, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
            w_max_m, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
            out = jnp.clip(out, w_min_m, w_max_m)
        return self.with_data(maybe_unit(out, unit))

    def update_on_post(self, pre_trace, post_spike, w_min=None, w_max=None):
        post_spike = _event_value(post_spike) if _is_event(post_spike) else post_spike
        return self.with_data(update_fixed_pre_conn_on_binary_post(
            self.data, self.indices, pre_trace, post_spike, w_min, w_max))

    def dt2t(self, y, transpose: bool = False):
        # row view is A.T: non-transposed logical dt2t indexes post rows
        return fcnmv_dt2t(y, self.data, self.indices,
                          shape=self._ell_shape(), transpose=not transpose)

    def dt2t_transposed(self, y):
        return self.dt2t(y, transpose=True)

    # -- products: stored ELL is A.T ---------------------------------------------

    def __matmul__(self, other):
        # A @ v = (ELL).T @ v: scatter direction of the stored view
        if _is_event(other):
            ev = _event_value(other)
            if ev.ndim == 1:
                return binary_fcnmv(self.data, self.indices, ev,
                                    shape=self._ell_shape(), transpose=True)
            return binary_fcnmm(self.data, self.indices, ev,
                                shape=self._ell_shape(), transpose=True)
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return fcnmv(self.data, self.indices, other,
                         shape=self._ell_shape(), transpose=True)
        return fcnmm(self.data, self.indices, other,
                     shape=self._ell_shape(), transpose=True)

    def __rmatmul__(self, other):
        # s @ A = ELL @ s: gather direction of the stored view
        if _is_event(other):
            ev = _event_value(other)
            if ev.ndim == 1:
                return binary_fcnmv(self.data, self.indices, ev,
                                    shape=self._ell_shape(), transpose=False)
            return binary_fcnmm(self.data, self.indices, ev.T,
                                shape=self._ell_shape(), transpose=False).T
        other = extract_raw_value(other)
        if getattr(other, 'ndim', 0) == 1:
            return fcnmv(self.data, self.indices, other,
                         shape=self._ell_shape(), transpose=False)
        return fcnmm(self.data, self.indices, other.T,
                     shape=self._ell_shape(), transpose=False).T
