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

"""Just-in-time connectivity matrix classes (R/C orientations + mode views).

Factory producing the class pair of one family
(reference ``brainevent/_jit_*/main.py``): ``R`` is the row-oriented
generative matrix; ``C`` represents its transpose with the same parameters
(zero-copy flip). Products keep the *same* sampled matrix across directions
by flipping ``(transpose, corder)`` together — the documented contract of
the reference (``_jit_scalar/main.py:985+``).

The ``.mv`` / ``.mm`` views expose the two lane layouts: mv-mode (stride 32)
and mm-mode (stride 4) draw DIFFERENT matrices (``brainevent/_typing.py:79``).
"""

from typing import Tuple

import jax
import jax.numpy as jnp

from .._data import JITCMatrix
from .._error import MathError
from ..events.base import EventRepresentation, extract_raw_value
from ..units import get_mantissa

__all__ = ['make_classes', 'JITCModeView', 'JITCWalkPlan']


class JITCWalkPlan:
    """Precomputed walk-stream setup bound to one JITC matrix.

    The stationary-``q`` stream initialization is rejection-sampled over
    every stream. It is a pure function of ``(seed, clen, shape)``, so a
    fixed matrix computes it once here and passes it to the plan
    primitives. The reference re-draws per call inside each thread
    (``brainevent/_jit_normal/float.py:729``); the plan layer is an
    extension with no reference counterpart.

    ``plan @ v`` / ``v @ plan`` compute the same product as the bound
    matrix (same sampled matrix — validated by the backend sweep: the
    ``jax_raw`` backend ignores the setup and recomputes it). A 2-D
    operand applies the SAME mv-mode (stride-32) matrix to every column
    — unlike ``matrix @ B``, which samples the mm-mode (stride-4)
    matrix (``brainevent/_typing.py:79``).

    AD flows through the plan primitives: operand/parameter gradients
    reuse this plan's setup, because the cotangent product flips
    ``(transpose, corder)`` together, which preserves the walk geometry.
    """

    def __init__(self, family, matrix, shape, transpose, corder,
                 clen, setup, scan_rounds=None, row_cap=None):
        self._family = family
        self.matrix = matrix
        self._shape = tuple(shape)
        self._transpose = bool(transpose)
        self._corder = bool(corder)
        self.clen = clen
        self.setup = tuple(setup)
        # static round bound for the event-compacted scatter route
        # (None when the connection prob is traced — the full walk then
        # serves event products too)
        self.scan_rounds = scan_rounds
        # static active-row capacity override for the event route
        # (None -> the global event_capacity default)
        self.event_cap = None
        # static per-row candidate capacity (compaction stage)
        self.row_cap = row_cap

    @property
    def shape(self):
        """Logical (rows, cols) of the bound matrix."""
        if self._transpose:
            return (self._shape[1], self._shape[0])
        return self._shape

    def _product(self, operand, event: bool, *, flip: bool):
        m = self.matrix
        transpose = self._transpose != flip
        corder = self._corder if not flip else (not self._corder)
        fam = self._family
        fn = fam.plan_mv_fn if operand.ndim == 1 else fam.plan_mm_fn
        return fn(*m.data, self.clen, operand, m.seed, *self.setup,
                  shape=self._shape, transpose=transpose, corder=corder,
                  event=event,
                  scan_rounds=(self.scan_rounds if event else None),
                  event_cap=(self.event_cap if event else None),
                  row_cap=(self.row_cap if event else None))

    def __matmul__(self, other):
        event = isinstance(other, EventRepresentation)
        return self._product(extract_raw_value(other), event, flip=False)

    def __rmatmul__(self, other):
        event = isinstance(other, EventRepresentation)
        raw = extract_raw_value(other)
        if raw.ndim == 1:
            return self._product(raw, event, flip=True)
        return self._product(raw.T, event, flip=True).T

    def tree_flatten(self):
        return ((self.matrix, self.clen, self.setup),
                (self._family, self._shape, self._transpose, self._corder,
                 self.scan_rounds, self.event_cap, self.row_cap))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (family, shape, transpose, corder, scan_rounds, event_cap,
         row_cap) = aux
        matrix, clen, setup = children
        out = cls(family, matrix, shape, transpose, corder, clen, setup,
                  scan_rounds=scan_rounds, row_cap=row_cap)
        out.event_cap = event_cap
        return out

    def __repr__(self):
        return (f'JITCWalkPlan({self.matrix!r}, '
                f'walk_shape={self._shape}, transpose={self._transpose}, '
                f'corder={self._corder})')


jax.tree_util.register_pytree_node_class(JITCWalkPlan)


class JITCModeView:
    """Mode-locked view (``'mv'``/``'mm'``) of a JITC matrix: conversions
    materialize the matrix that the selected product mode actually samples
    (reference ``_JITCScalarModeView``, ``_jit_scalar/main.py:40``)."""

    def __init__(self, matrix, mode: str):
        self._m = matrix
        self._mode = mode

    def todense(self):
        return self._m._todense(matrix_mode=self._mode)

    def tocsr(self):
        return self._m._tocsr(matrix_mode=self._mode)

    def tocsc(self):
        return self._m._tocsr(matrix_mode=self._mode).tocsc()

    def tocoo(self):
        return self._m._tocsr(matrix_mode=self._mode).tocoo()

    def __repr__(self):
        return f'{type(self._m).__name__}.{self._mode}'


def make_classes(family, class_base_name: str, param_names: Tuple[str, ...],
                 lift_add=None):
    """Create the ``(R, C)`` class pair of *family*.

    Parameters
    ----------
    family : SimpleNamespace
        Output of :func:`brainevent_tpu.jitc.family.make_family`.
    class_base_name : str
        e.g. ``'JITCScalar'`` -> classes ``JITCScalarR`` / ``JITCScalarC``.
    param_names : tuple of str
        Weight parameter attribute names (e.g. ``('wloc', 'wscale')``).
    lift_add : Callable, optional
        ``lift_add(params, scalar) -> params`` for scalar addition; default
        shifts every parameter (exact for scalar/uniform; normal overrides
        to shift only the location).
    """
    npar = len(param_names)
    if lift_add is None:
        def lift_add(params, s):
            return tuple(p + s for p in params)

    class Base(JITCMatrix):
        """Shared R/C machinery."""

        # lazily-built walk plan (auto-plan route); derived data, never
        # flattened into the pytree — class default covers instances
        # reconstructed through ``tree_unflatten`` (``cls.__new__``)
        _plan_cache = None

        def __init__(self, data, *, shape, corder: bool = False):
            # data = (param_0, ..., param_{n-1}, prob, seed)
            if len(data) != npar + 2:
                raise MathError(
                    f'{type(self).__name__} expects data = '
                    f'({", ".join(param_names)}, prob, seed), got '
                    f'{len(data)} entries.')
            super().__init__(shape)
            for name, value in zip(param_names, data[:npar]):
                self.register_buffer(name, value)
            self.prob = float(data[npar]) if not hasattr(
                data[npar], 'aval') else data[npar]
            self.register_buffer('seed', jnp.atleast_1d(
                jnp.asarray(data[npar + 1], dtype=jnp.uint32)))
            self.corder = bool(corder)
            self._plan_cache = None

        # -- data protocol ------------------------------------------------

        @property
        def data(self):
            return tuple(self._buffers[n] for n in param_names)

        @property
        def dtype(self):
            return get_mantissa(self._buffers[param_names[0]]).dtype

        def with_data(self, data):
            if not isinstance(data, tuple):
                data = (data,)
            assert len(data) == npar
            return type(self)((*data, self.prob, self.seed),
                              shape=self.shape, corder=self.corder)

        def tree_flatten(self):
            children = tuple(self._buffers[n] for n in param_names) + (
                self._buffers['seed'],)
            return children, (self.shape, self.prob, self.corder)

        @classmethod
        def tree_unflatten(cls, aux, children):
            obj = cls.__new__(cls)
            obj.shape, obj.prob, obj.corder = aux
            obj._buffers = dict(zip(param_names, children[:npar]))
            obj._buffers['seed'] = children[npar]
            return obj

        # -- algebra on parameters -------------------------------------------

        def _lift_mul(self, s):
            return self.with_data(tuple(p * s for p in self.data))

        def __mul__(self, other):
            return self._lift_mul(other)

        def __rmul__(self, other):
            return self._lift_mul(other)

        def __truediv__(self, other):
            return self._lift_mul(1.0 / other)

        def __neg__(self):
            return self._lift_mul(-1.0)

        def __add__(self, other):
            return self.with_data(lift_add(self.data, other))

        def __radd__(self, other):
            return self.with_data(lift_add(self.data, other))

        def __sub__(self, other):
            return self.with_data(lift_add(self.data, -other))

        def apply(self, fn):
            return self.with_data(tuple(fn(p) for p in self.data))

        # -- generation orientation hooks ------------------------------------

        def _gen(self):
            """(gen_shape, gen_transpose): walk layout of this orientation."""
            raise NotImplementedError

        def _todense(self, matrix_mode='mv'):
            gen_shape, gen_transpose = self._gen()
            dense = family.dense_fn(
                *self.data, self.prob, self.seed, shape=gen_shape,
                transpose=gen_transpose, corder=self.corder,
                matrix_mode=matrix_mode)
            return dense

        def _tocsr(self, matrix_mode='mv'):
            gen_shape, gen_transpose = self._gen()
            csr = family.to_csr(*self.data, self.prob, self.seed,
                                shape=gen_shape, corder=self.corder,
                                matrix_mode=matrix_mode)
            if gen_transpose:
                # the walk materializes M.T; this object is M
                return csr.transpose().tocsr()
            return csr

        # -- mode views --------------------------------------------------------

        @property
        def mv(self) -> JITCModeView:
            """mv-mode (stride-32) view."""
            return JITCModeView(self, 'mv')

        @property
        def mm(self) -> JITCModeView:
            """mm-mode (stride-4) view."""
            return JITCModeView(self, 'mm')

        def _auto_plan(self):
            """Cached walk plan when buffers are concrete and the route
            is enabled; None under tracing (a traced build would inline
            the setup into the jaxpr — exactly the cost the plan
            avoids)."""
            from ..config import get_jitc_auto_plan
            if not get_jitc_auto_plan():
                return None
            if self._plan_cache is not None:
                return self._plan_cache
            leaves = list(self.data) + [self.seed, self.prob]
            if any(isinstance(l, jax.core.Tracer) for l in leaves):
                return None
            self._plan_cache = self.build_walk_plan()
            return self._plan_cache

        def build_walk_plan(self) -> JITCWalkPlan:
            """Hoist the walk-stream setup out of repeated products.

            Returns a :class:`JITCWalkPlan` supporting ``plan @ v`` /
            ``v @ plan`` with the SAME sampled mv-mode matrix as this
            object's products; the stationary-``q`` stream init runs
            once here and is passed to the plan primitives. 2-D operands
            apply the mv-mode
            matrix column-wise (``self @ B`` samples the mm-mode matrix
            instead — use the matrix directly for that contract).
            """
            gen_shape, gen_transpose = self._gen()
            corder = (not self.corder) if gen_transpose else self.corder
            clen, state2, q2, cl = family.build_plan_setup(
                self.prob, self.seed, gen_shape,
                transpose=gen_transpose, corder=corder)
            scan_rounds = row_cap = None
            if isinstance(self.prob, (int, float)):
                from ..fcn.binary import event_capacity
                from .event_route import (default_row_cap,
                                          default_scan_rounds)
                from .._misc import _normalize_chunk_size
                chunk = _normalize_chunk_size(gen_shape[1], None)
                n_streams = (event_capacity(state2.shape[0])
                             * state2.shape[1])
                scan_rounds = default_scan_rounds(
                    float(self.prob), chunk, n_streams)
                out_len = gen_shape[1] if gen_transpose else gen_shape[0]
                in_len = gen_shape[0] if gen_transpose else gen_shape[1]
                n_cols_walk = in_len if corder else out_len
                row_cap = default_row_cap(
                    float(self.prob), n_cols_walk,
                    scan_rounds * state2.shape[1])
            return JITCWalkPlan(family, self, gen_shape, gen_transpose,
                                corder, clen, (state2, q2, cl),
                                scan_rounds=scan_rounds, row_cap=row_cap)

        def dt2t(self, y, transpose: bool = False):
            gen_shape, gen_transpose = self._gen()
            return family.dt2t_fn(*self.data, self.prob, y, self.seed,
                                  shape=gen_shape,
                                  transpose=transpose != gen_transpose,
                                  corder=self.corder)

        def dt2t_transposed(self, y):
            return self.dt2t(y, transpose=True)

        def __repr__(self):
            pairs = ', '.join(f'{n}={self._buffers[n]}' for n in param_names)
            return (f'{type(self).__name__}(shape={self.shape}, {pairs}, '
                    f'prob={self.prob}, corder={self.corder})')

    class R(Base):
        """Row-oriented generative matrix (reference ``JITC*R``)."""

        def _gen(self):
            return self.shape, False

        def todense(self):
            return self._todense('mv')

        def tocsr(self):
            return self._tocsr('mv')

        def tocsc(self):
            return self._tocsr('mv').tocsc()

        def tocoo(self):
            return self._tocsr('mv').tocoo()

        def transpose(self, axes=None):
            if axes is not None:
                raise MathError('transpose with axes is not supported.')
            return C((*self.data, self.prob, self.seed),
                     shape=(self.shape[1], self.shape[0]),
                     corder=self.corder)

        def __matmul__(self, other):
            if extract_raw_value(other).ndim == 1:
                # 1-D products auto-route through the cached walk plan
                # (same sampled matrix; the setup is paid once) — 2-D
                # keeps the direct route: it samples the mm-mode matrix
                plan = self._auto_plan()
                if plan is not None:
                    return plan @ other
            if isinstance(other, EventRepresentation):
                ev = extract_raw_value(other)
                op = family.bmv_fn if ev.ndim == 1 else family.bmm_fn
                return op(*self.data, self.prob, ev, self.seed,
                          shape=self.shape, transpose=False,
                          corder=self.corder)
            other = extract_raw_value(other)
            op = family.mv_fn if other.ndim == 1 else family.mm_fn
            return op(*self.data, self.prob, other, self.seed,
                      shape=self.shape, transpose=False, corder=self.corder)

        def __rmatmul__(self, other):
            # other @ M == (M.T @ other.T).T; same matrix: flip both flags
            if extract_raw_value(other).ndim == 1:
                plan = self._auto_plan()
                if plan is not None:
                    return other @ plan
            if isinstance(other, EventRepresentation):
                ev = extract_raw_value(other)
                if ev.ndim == 1:
                    return family.bmv_fn(*self.data, self.prob, ev, self.seed,
                                         shape=self.shape, transpose=True,
                                         corder=not self.corder)
                return family.bmm_fn(*self.data, self.prob, ev.T, self.seed,
                                     shape=self.shape, transpose=True,
                                     corder=not self.corder).T
            other = extract_raw_value(other)
            if other.ndim == 1:
                return family.mv_fn(*self.data, self.prob, other, self.seed,
                                    shape=self.shape, transpose=True,
                                    corder=not self.corder)
            return family.mm_fn(*self.data, self.prob, other.T, self.seed,
                                shape=self.shape, transpose=True,
                                corder=not self.corder).T

    class C(Base):
        """Column-oriented view: the transpose of the R matrix with the same
        parameters (reference ``JITC*C``)."""

        def _gen(self):
            # underlying R matrix has the reversed shape; this object is its
            # transpose
            return (self.shape[1], self.shape[0]), True

        def todense(self):
            return family.dense_fn(
                *self.data, self.prob, self.seed,
                shape=(self.shape[1], self.shape[0]), transpose=False,
                corder=self.corder).T

        def tocsr(self):
            return self._csr_of_transpose().transpose().tocsr()

        def _csr_of_transpose(self):
            return family.to_csr(*self.data, self.prob, self.seed,
                                 shape=(self.shape[1], self.shape[0]),
                                 corder=self.corder, matrix_mode='mv')

        def tocsc(self):
            # CSC of M == CSR arrays of M.T relabeled
            from ..csr.main import CSC
            csr_t = self._csr_of_transpose()
            return CSC((csr_t.data, csr_t.indices, csr_t.indptr),
                       shape=self.shape)

        def tocoo(self):
            return self.tocsc().tocoo()

        def transpose(self, axes=None):
            if axes is not None:
                raise MathError('transpose with axes is not supported.')
            return R((*self.data, self.prob, self.seed),
                     shape=(self.shape[1], self.shape[0]),
                     corder=self.corder)

        def __matmul__(self, other):
            # M @ v with M = R(shape reversed).T
            rshape = (self.shape[1], self.shape[0])
            if extract_raw_value(other).ndim == 1:
                plan = self._auto_plan()
                if plan is not None:
                    return plan @ other
            if isinstance(other, EventRepresentation):
                ev = extract_raw_value(other)
                if ev.ndim == 1:
                    return family.bmv_fn(*self.data, self.prob, ev, self.seed,
                                         shape=rshape, transpose=True,
                                         corder=not self.corder)
                return family.bmm_fn(*self.data, self.prob, ev, self.seed,
                                     shape=rshape, transpose=True,
                                     corder=not self.corder)
            other = extract_raw_value(other)
            if other.ndim == 1:
                return family.mv_fn(*self.data, self.prob, other, self.seed,
                                    shape=rshape, transpose=True,
                                    corder=not self.corder)
            return family.mm_fn(*self.data, self.prob, other, self.seed,
                                shape=rshape, transpose=True,
                                corder=not self.corder)

        def __rmatmul__(self, other):
            rshape = (self.shape[1], self.shape[0])
            if extract_raw_value(other).ndim == 1:
                plan = self._auto_plan()
                if plan is not None:
                    return other @ plan
            if isinstance(other, EventRepresentation):
                ev = extract_raw_value(other)
                if ev.ndim == 1:
                    return family.bmv_fn(*self.data, self.prob, ev, self.seed,
                                         shape=rshape, transpose=False,
                                         corder=self.corder)
                return family.bmm_fn(*self.data, self.prob, ev.T, self.seed,
                                     shape=rshape, transpose=False,
                                     corder=self.corder).T
            other = extract_raw_value(other)
            if other.ndim == 1:
                return family.mv_fn(*self.data, self.prob, other, self.seed,
                                    shape=rshape, transpose=False,
                                    corder=self.corder)
            return family.mm_fn(*self.data, self.prob, other.T, self.seed,
                                shape=rshape, transpose=False,
                                corder=self.corder).T

    R.__name__ = R.__qualname__ = f'{class_base_name}R'
    C.__name__ = C.__qualname__ = f'{class_base_name}C'
    Base.__name__ = Base.__qualname__ = f'{class_base_name}Matrix'
    jax.tree_util.register_pytree_node_class(R)
    jax.tree_util.register_pytree_node_class(C)
    return Base, R, C
