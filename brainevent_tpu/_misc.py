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

"""Shared helpers: sparse-format index conversions, fixed-connectivity
structure transforms, shape/dtype validation, chunking constants for the
implicit-connectivity sampler, and the ``namescope`` jit-cache decorator.

Capability parity with reference ``brainevent/_misc.py``.
"""

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ._error import MathError

__all__ = [
    'COOInfo',
    'cdiv',
    'csr_to_coo_index',
    'coo_to_csc_index',
    'coo2csr',
    'csr_to_csc_index',
    'csc_to_csr_index',
    'check_fixed_conn_num_shape',
    'fixed_conn_num_csr_indptr',
    'fixed_conn_num_csc_structure',
    'fixed_conn_num_to_csc',
    'normalize_row_index',
    'NameScope',
    'namescope',
]

# Lane layout of the implicit-connectivity sampler. mv and mm modes use
# different strides, so they draw DIFFERENT matrices — a documented contract
# inherited from the reference (``brainevent/_misc.py:37-38``,
# ``brainevent/_typing.py:79-82``).
_MV_STRIDE = 32
_MM_STRIDE = 4


class COOInfo(NamedTuple):
    """COO metadata (reference ``brainevent/_misc.py:396``)."""
    shape: Tuple[int, ...]
    rows_sorted: bool = False
    cols_sorted: bool = False


def cdiv(m: int, n: int) -> int:
    """Ceiling division."""
    return -(-m // n)


def _normalize_chunk_size(n_cols: int, chunk_size: Optional[int], target_chunks: int = 4) -> int:
    """Chunk width of the light-RNG connectivity walk.

    The chunk id participates in stream keying, so *every* operator of a
    ``jitc`` family must chunk identically or they would draw different
    matrices (same contract as reference ``brainevent/_misc.py:74``).
    """
    if chunk_size is None:
        target_chunks = int(target_chunks)
        if target_chunks <= 0:
            raise ValueError('target_chunks must be positive')
        chunk_size = max(1, (int(n_cols) + target_chunks - 1) // target_chunks)
    chunk_size = int(chunk_size)
    if chunk_size <= 0:
        raise ValueError('chunk_size must be positive')
    return chunk_size


def _normalize_matrix_mode(mode: str) -> str:
    mode = str(mode).lower()
    if mode not in ('mv', 'mm'):
        raise ValueError(f"matrix_mode must be 'mv' or 'mm', got {mode!r}")
    return mode


def _is_static_zero(value) -> bool:
    """True when *value* is a concrete zero known at trace time."""
    if isinstance(value, (int, float)):
        return value == 0
    if isinstance(value, np.ndarray):
        return bool(np.all(value == 0))
    if isinstance(value, jax.Array) and not isinstance(value, jax.core.Tracer):
        return bool(jnp.all(value == 0))
    return False


def _initialize_conn_length(conn_prob: float):
    """Convert connection probability to the integer connection-length
    parameter ``clen ≈ 2/prob`` used by the sampler (reference
    ``brainevent/_data.py:1212``)."""
    with jax.ensure_compile_time_eval():
        clen = jnp.ceil(2.0 / float(conn_prob)).astype(jnp.int32)
        return jnp.atleast_1d(jnp.maximum(clen, 2))


# ----------------------------------------------------------------------------
# Sparse index-structure conversions (host/trace-time; plain XLA or NumPy).
# ----------------------------------------------------------------------------

def _mod_for(*arrays):
    return np if all(isinstance(a, np.ndarray) for a in arrays) else jnp


def csr_to_coo_index(indptr, indices):
    """CSR ``(indptr, indices)`` -> COO ``(row_ids, col_ids)``."""
    with jax.ensure_compile_time_eval():
        mod = _mod_for(indptr, indices)
        rows = mod.repeat(
            mod.arange(indptr.shape[0] - 1, dtype=indices.dtype),
            mod.diff(indptr),
            **({} if mod is np else dict(total_repeat_length=indices.shape[0])),
        )
        return rows, indices


def coo_to_csc_index(pre_ids, post_ids, *, shape: Tuple[int, int]):
    """COO ``(rows, cols)`` -> CSC ``(indptr, row_indices, perm)``.

    ``perm`` maps CSC slots back to the original COO/CSR data positions:
    ``data_csc = data[perm]``.
    """
    with jax.ensure_compile_time_eval():
        mod = _mod_for(pre_ids, post_ids)
        n_cols = shape[1]
        perm = mod.argsort(post_ids, kind='stable') if mod is np else mod.argsort(post_ids, stable=True)
        csc_rows = pre_ids[perm]
        counts = mod.bincount(post_ids, **(dict(minlength=n_cols) if mod is np else dict(length=n_cols)))
        indptr = mod.concatenate([
            mod.zeros(1, dtype=pre_ids.dtype),
            mod.cumsum(counts).astype(pre_ids.dtype),
        ])
        return indptr, csc_rows.astype(pre_ids.dtype), perm.astype(pre_ids.dtype)


def coo2csr(pre_ids, post_ids, data=None, *, shape: Tuple[int, int]):
    """COO -> CSR. Returns ``(data_sorted_or_None, indices, indptr)``."""
    with jax.ensure_compile_time_eval():
        mod = _mod_for(pre_ids, post_ids)
        n_rows = shape[0]
        perm = mod.argsort(pre_ids, kind='stable') if mod is np else mod.argsort(pre_ids, stable=True)
        indices = post_ids[perm]
        counts = mod.bincount(pre_ids, **(dict(minlength=n_rows) if mod is np else dict(length=n_rows)))
        indptr = mod.concatenate([
            mod.zeros(1, dtype=post_ids.dtype),
            mod.cumsum(counts).astype(post_ids.dtype),
        ])
        sorted_data = None if data is None else data[perm]
        return sorted_data, indices.astype(post_ids.dtype), indptr


def csr_to_csc_index(
    csr_indptr,
    csr_indices,
    *,
    shape: Tuple[int, int],
    include_perm: bool = True,
    method: str = 'coo',
    column_block_size: int = 4096,
):
    """CSR -> CSC structure: ``(csc_indptr, csc_row_indices, perm)``.

    ``data[perm]`` reorders CSR data into CSC order. The reference offers a
    CUDA column-block method (``brainevent/_misc.py:1516``,
    ``csr_to_csc.cu``); here the conversion is a trace-time structural
    transform, so every method maps to the COO route.
    """
    del method, column_block_size  # one algorithm serves every method
    rows, cols = csr_to_coo_index(csr_indptr, csr_indices)
    indptr, csc_rows, perm = coo_to_csc_index(rows, cols, shape=shape)
    return indptr, csc_rows, (perm if include_perm else None)


def csc_to_csr_index(csc_indptr, csc_indices, *, shape: Tuple[int, int], include_perm: bool = True):
    """CSC -> CSR structure (the transposed-interpretation of
    :func:`csr_to_csc_index`)."""
    n_rows, n_cols = shape
    return csr_to_csc_index(
        csc_indptr, csc_indices, shape=(n_cols, n_rows), include_perm=include_perm
    )


# ----------------------------------------------------------------------------
# Fixed-connectivity (ELL) structure helpers
# (reference brainevent/_misc.py:697,1135,1255,1303).
# ----------------------------------------------------------------------------

def check_fixed_conn_num_shape(
    indices_shape: Tuple[int, int],
    operand_len: int,
    shape: Tuple[int, int],
    transpose: bool,
):
    """Validate operand shapes of a fixed-number-connectivity product.

    ``indices`` is ``(n_pre, n_conn)`` listing, per row of the logical
    ``(n_pre, n_post)`` matrix, the ``n_conn`` connected columns. For
    ``y = A @ v`` (``transpose=False``) the operand has length ``n_post`` and
    the result ``n_pre``; transposed, the reverse. Returns the result length.
    """
    n_pre, n_post = shape
    if indices_shape[0] != n_pre:
        raise MathError(
            f'indices.shape[0] ({indices_shape[0]}) must equal shape[0] ({n_pre}).'
        )
    contraction = n_pre if transpose else n_post
    if operand_len != contraction:
        raise MathError(
            f'operand length ({operand_len}) must equal '
            f'{"shape[0]" if transpose else "shape[1]"} ({contraction}) for '
            f'{"A.T @ v" if transpose else "A @ v"}.'
        )
    return n_post if transpose else n_pre


def fixed_conn_num_csr_indptr(n_pre: int, n_conn: int, dtype=jnp.int32):
    """The implicit CSR indptr of an ELL structure: ``arange(n_pre+1)*n_conn``."""
    with jax.ensure_compile_time_eval():
        return jnp.arange(n_pre + 1, dtype=dtype) * n_conn


def fixed_conn_num_csc_structure(indices, *, shape: Tuple[int, int]):
    """CSC mirror structure of an ELL matrix.

    Returns ``(csc_indptr, csc_pre_ids, perm)`` where ``perm`` maps CSC slots
    to flat ELL positions (``data.reshape(-1)[perm]``).
    """
    n_pre, n_post = shape
    n_conn = indices.shape[1]
    # uniform repeat = broadcast + reshape (free; jnp.repeat serializes)
    rows = jnp.broadcast_to(
        jnp.arange(n_pre, dtype=indices.dtype)[:, None],
        (n_pre, n_conn)).reshape(-1)
    cols = jnp.asarray(indices).reshape(-1)
    return coo_to_csc_index(rows, cols, shape=(n_pre, n_post))


def fixed_conn_num_to_csc(indices, data, *, shape: Tuple[int, int]):
    """Materialize the CSC mirror ``(data_csc, csc_indptr, csc_pre_ids)``."""
    csc_indptr, csc_rows, perm = fixed_conn_num_csc_structure(indices, shape=shape)
    flat = jnp.broadcast_to(
        jnp.asarray(data), (shape[0], indices.shape[1])
    ).reshape(-1) if jnp.ndim(data) <= 1 and jnp.size(data) == 1 else jnp.asarray(data).reshape(-1)
    return flat[perm], csc_indptr, csc_rows


def normalize_row_index(index, n_rows: int):
    """Normalize a row index (int/slice/array) into an int32 index array."""
    if isinstance(index, slice):
        return jnp.arange(*index.indices(n_rows), dtype=jnp.int32)
    index = jnp.asarray(index)
    if index.dtype == jnp.bool_:
        (index,) = jnp.nonzero(index, size=None)
        return index.astype(jnp.int32)
    if index.ndim == 0:
        index = index[None]
    return jnp.where(index < 0, index + n_rows, index).astype(jnp.int32)


# ----------------------------------------------------------------------------
# Structure/dtype validation (reference brainevent/_misc.py:196-270,506).
# ----------------------------------------------------------------------------

_INDEX_DTYPES = (jnp.int32, jnp.int64, jnp.uint32, jnp.uint64)


def check_csr_structure(weights, indices, indptr, shape: Tuple[int, int]) -> None:
    """Validate CSR operand shapes/dtypes (raises :class:`MathError`)."""
    if len(shape) != 2:
        raise MathError(f'shape must be 2-D, got {shape}.')
    if jnp.dtype(indices.dtype) not in [jnp.dtype(d) for d in _INDEX_DTYPES]:
        raise MathError(f'indices dtype must be integer, got {indices.dtype}.')
    if indices.dtype != indptr.dtype:
        raise MathError(
            f'indices dtype ({indices.dtype}) must match indptr dtype ({indptr.dtype}).'
        )
    if indptr.shape[0] != shape[0] + 1:
        raise MathError(
            f'indptr length ({indptr.shape[0]}) must be shape[0]+1 ({shape[0] + 1}).'
        )
    if weights.ndim != 1 or weights.shape[0] not in (1, indices.shape[0]):
        raise MathError(
            f'weights must be (1,) homogeneous or ({indices.shape[0]},) '
            f'heterogeneous, got shape {weights.shape}.'
        )


def promote_weights(weights, dtype=None):
    """Promote scalar weights to a (1,) array (homogeneous-weight form)."""
    weights = jnp.asarray(weights, dtype=dtype)
    if weights.ndim == 0:
        weights = weights[None]
    return weights


# ----------------------------------------------------------------------------
# namescope: named, per-backend-cached jax.jit wrapper
# (reference brainevent/_misc.py:1713,1802).
# ----------------------------------------------------------------------------

class NameScope:
    """Wrap a function in a named ``jax.jit`` cache keyed by static kwargs.

    Ops wrapped this way appear as named scopes in JAX profiles and HLO,
    which is the package's baseline tracing/profiling integration.
    """

    def __init__(self, fn: Callable, name: Optional[str] = None, static_argnames=()):
        self.fn = fn
        self.name = name or getattr(fn, '__name__', 'op')
        self.static_argnames = tuple(static_argnames)
        self._cache = {}
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        static = tuple(sorted(
            (k, kwargs[k]) for k in self.static_argnames if k in kwargs
        ))
        jitted = self._cache.get(static)
        if jitted is None:
            named = jax.named_scope(self.name)(self.fn)
            jitted = jax.jit(named, static_argnames=self.static_argnames)
            self._cache[static] = jitted
        return jitted(*args, **kwargs)


def namescope(fn: Optional[Callable] = None, *, name: Optional[str] = None,
              static_argnames=()):
    """Decorator form of :class:`NameScope`."""
    def deco(f):
        return NameScope(f, name=name, static_argnames=static_argnames)
    if fn is None:
        return deco
    return deco(fn)
