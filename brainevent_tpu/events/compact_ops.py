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

"""Event encoder primitives (reference ``brainevent/_event/compact.py``).

Eight static-capacity encoders that turn dense spike arrays into
index-compacted structures. All outputs have *static* shapes (capacity =
input size) with a separate valid-count — the design that makes event-driven
dispatch compatible with ``jax.jit`` static shapes.

Every primitive registers one ``jax_raw`` kernel, for every platform:
sort, prefix-sum and scatter formulations that XLA compiles.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.core import XLACustomKernel

__all__ = [
    'binary_1d_array_index_p', 'binary_1d_array_index_p_call',
    'binary_2d_compact_only_p', 'binary_2d_compact_only_p_call',
    'binary_2d_array_index_p', 'binary_2d_array_index_p_call',
    'binary_2d_pair_stream_encode_p', 'binary_2d_pair_stream_encode_p_call',
    'binary_2d_row_sparse_encode_p', 'binary_2d_row_sparse_encode_p_call',
    'binary_2d_csr_row_count_p', 'binary_2d_csr_row_count_p_call',
    'binary_2d_csr_fill_p', 'binary_2d_csr_fill_p_call',
    'binary_2d_csc_encode_p', 'binary_2d_csc_encode_p_call',
    'binary_2d_csr_encode_p_call', 'binary_2d_csc_from_array',
]


def _mask_of(x):
    return x if x.dtype == jnp.bool_ else (x != 0)


def _compact_indices(mask_flat, ids):
    """Move *ids* of true lanes to the front of a capacity buffer.

    Returns ``(compacted_ids, count)``; invalid tail entries are zero.
    Formulated as a single-operand sort (actives keep their ids, inactive
    lanes sort to the back as ``n``) instead of a cumsum+scatter.
    Ascending id order is preserved, so outputs are bitwise identical to
    the scatter form.
    """
    n = mask_flat.shape[0]
    active = mask_flat.astype(jnp.int32)
    count = jnp.sum(active, dtype=jnp.int32).reshape(1)
    key = jnp.where(mask_flat, ids, n)
    srt = jax.lax.sort(key)
    out = jnp.where(jax.lax.iota(jnp.int32, n) < count[0], srt, 0)
    return out, count


# =============================================================================
# 1D stream compaction
# =============================================================================

def _binary_1d_array_index_jax_kernel(**params):
    def kernel(spikes):
        mask = _mask_of(spikes)
        ids = jnp.arange(mask.shape[0], dtype=jnp.int32)
        return _compact_indices(mask, ids)
    return kernel


binary_1d_array_index_p = XLACustomKernel(
    'binary_1d_array_index',
    doc='1D stream compaction: indices of non-zero entries, front-compacted '
        'into a static-capacity buffer (reference _event/compact.py:376).',
)
binary_1d_array_index_p.def_jax_kernel(_binary_1d_array_index_jax_kernel, asdefault=True)
binary_1d_array_index_p.def_tags('event', 'binary')


def binary_1d_array_index_p_call(spikes, *, backend: Optional[str] = None):
    """Compact a 1-D spike vector into ``(active_ids (n,), n_active (1,))``."""
    if spikes.ndim != 1:
        raise ValueError(f'`spikes` must be 1D, got {spikes.ndim}D.')
    n = spikes.shape[0]
    return binary_1d_array_index_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n,), jnp.int32),
              jax.ShapeDtypeStruct((1,), jnp.int32)],
        backend=backend,
    )


binary_1d_array_index_p.def_call(binary_1d_array_index_p_call)


# =============================================================================
# 2D row-level compaction (no bitpack)
# =============================================================================

def _binary_2d_compact_only_jax_kernel(**params):
    def kernel(spikes):
        mask = jnp.any(_mask_of(spikes), axis=1)
        ids = jnp.arange(mask.shape[0], dtype=jnp.int32)
        return _compact_indices(mask, ids)
    return kernel


binary_2d_compact_only_p = XLACustomKernel(
    'binary_2d_compact_only',
    doc='Row-level compaction of a 2D spike matrix: rows with any non-zero '
        'entry (reference _event/compact.py:228).',
)
binary_2d_compact_only_p.def_jax_kernel(_binary_2d_compact_only_jax_kernel, asdefault=True)
binary_2d_compact_only_p.def_tags('event', 'binary')


def binary_2d_compact_only_p_call(spikes, *, backend: Optional[str] = None):
    """Compact active rows of ``(n_pre, n_batch)`` spikes into
    ``(active_ids (n_pre,), n_active (1,))``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    n = spikes.shape[0]
    return binary_2d_compact_only_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n,), jnp.int32),
              jax.ShapeDtypeStruct((1,), jnp.int32)],
        backend=backend,
    )


binary_2d_compact_only_p.def_call(binary_2d_compact_only_p_call)


# =============================================================================
# 2D fused bitpack + row compaction
# =============================================================================

def _pack_bits_axis1(mask):
    """Pack a bool (n, b) mask into (n, ceil(b/32)) uint32, bit k of word w =
    element ``w*32 + k`` (little-endian bit order)."""
    n, b = mask.shape
    n_words = -(-b // 32)
    pad = n_words * 32 - b
    m = jnp.pad(mask, ((0, 0), (0, pad))).reshape(n, n_words, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(m.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32)


def _binary_2d_array_index_jax_kernel(**params):
    def kernel(spikes):
        mask2d = _mask_of(spikes)
        packed = _pack_bits_axis1(mask2d)
        row_mask = jnp.any(mask2d, axis=1)
        ids = jnp.arange(row_mask.shape[0], dtype=jnp.int32)
        act, cnt = _compact_indices(row_mask, ids)
        return packed, act, cnt
    return kernel


binary_2d_array_index_p = XLACustomKernel(
    'binary_2d_array_index',
    doc='Fused bitpack + row compaction of a 2D spike matrix '
        '(reference _event/compact.py:552).',
)
binary_2d_array_index_p.def_jax_kernel(_binary_2d_array_index_jax_kernel, asdefault=True)
binary_2d_array_index_p.def_tags('event', 'binary')


def binary_2d_array_index_p_call(spikes, *, backend: Optional[str] = None):
    """Returns ``(packed (n, ceil(b/32)) uint32, active_ids (n,), n_active (1,))``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    n, b = spikes.shape
    return binary_2d_array_index_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n, -(-b // 32)), jnp.uint32),
              jax.ShapeDtypeStruct((n,), jnp.int32),
              jax.ShapeDtypeStruct((1,), jnp.int32)],
        backend=backend,
    )


binary_2d_array_index_p.def_call(binary_2d_array_index_p_call)


# =============================================================================
# 2D pair-stream encoding
# =============================================================================

def _binary_2d_pair_stream_encode_jax_kernel(**params):
    def kernel(spikes):
        n, b = spikes.shape
        mask = _mask_of(spikes).reshape(-1)
        cap = n * b
        rows = (jnp.arange(cap, dtype=jnp.int32) // b)
        cols = (jnp.arange(cap, dtype=jnp.int32) % b)
        active = mask.astype(jnp.int32)
        cnt = jnp.sum(active, dtype=jnp.int32).reshape(1)
        pos = jnp.cumsum(active) - 1
        safe = jnp.where(mask, pos, cap)
        out = jnp.zeros((cap, 2), dtype=jnp.int32)
        out = out.at[safe, 0].set(rows, mode='drop')
        out = out.at[safe, 1].set(cols, mode='drop')
        return out, cnt
    return kernel


binary_2d_pair_stream_encode_p = XLACustomKernel(
    'binary_2d_pair_stream_encode',
    doc='Compact (row, col) pair stream of active entries of a 2D spike '
        'matrix (reference _event/compact.py:706).',
)
binary_2d_pair_stream_encode_p.def_jax_kernel(
    _binary_2d_pair_stream_encode_jax_kernel, asdefault=True)
binary_2d_pair_stream_encode_p.def_tags('event', 'binary')


def binary_2d_pair_stream_encode_p_call(spikes, *, backend: Optional[str] = None):
    """Returns ``(pair_stream (n*b, 2) int32, n_pairs (1,))``; only the first
    ``n_pairs`` rows are valid (row-major order here)."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    n, b = spikes.shape
    return binary_2d_pair_stream_encode_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n * b, 2), jnp.int32),
              jax.ShapeDtypeStruct((1,), jnp.int32)],
        backend=backend,
    )


binary_2d_pair_stream_encode_p.def_call(binary_2d_pair_stream_encode_p_call)


# =============================================================================
# 2D row-sparse encoding (per-row 1-based active column ids)
# =============================================================================

def _binary_2d_row_sparse_encode_jax_kernel(**params):
    row_size = params.get('row_size')

    def kernel(spikes):
        n, b = spikes.shape
        mask = _mask_of(spikes)
        cols1 = jnp.arange(1, b + 1, dtype=jnp.int32)[None, :]
        # Front-compact per row with a stable ascending sort: inactive lanes
        # get a sentinel above every valid id, then become zero padding.
        sentinel = jnp.int32(b + 1)
        vals = jnp.where(mask, cols1, sentinel)
        vals = jnp.sort(vals, axis=1)
        if row_size is not None:
            vals = vals[:, :row_size]
        return (jnp.where(vals == sentinel, 0, vals),)
    return kernel


binary_2d_row_sparse_encode_p = XLACustomKernel(
    'binary_2d_row_sparse_encode',
    doc='Per-row 1-based active column ids, front-compacted and zero-padded '
        '(reference _event/compact.py:875).',
)
binary_2d_row_sparse_encode_p.def_jax_kernel(
    _binary_2d_row_sparse_encode_jax_kernel, asdefault=True)
binary_2d_row_sparse_encode_p.def_tags('event', 'binary')


def binary_2d_row_sparse_encode_p_call(spikes, *, row_size: Optional[int] = None,
                                       backend: Optional[str] = None):
    """Dense 2D spikes -> fixed-width per-row spike layout.

    Returns ``(spike_indices (n_src, row_size) int32,)`` with 1-based active
    batch-column ids per row, front-compacted and zero-padded (reference
    ``brainevent/_event/compact.py:875``). ``row_size`` defaults to the full
    batch width; concrete inputs whose max row NNZ exceeds it raise.

    The capacity check needs concrete values: under ``jit``/``vmap`` the
    input is a tracer, the check is skipped, and an overflowing row is
    truncated after the sort (lowest ``row_size`` ids kept). Size
    ``row_size`` for the worst case, or validate eagerly before tracing."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    n_src, n_batch = spikes.shape
    if row_size is None:
        row_size = n_batch
    if row_size <= 0:
        raise ValueError(f'`row_size` must be positive, got {row_size}.')
    if row_size > n_batch:
        raise ValueError(
            f'`row_size` must be <= n_batch={n_batch}, got {row_size}.')
    import numpy as _np
    if not isinstance(spikes, jax.core.Tracer) and n_src:
        # eager capacity validation on concrete inputs, mirroring the
        # reference (_event/compact.py:853); tracer-time checks are skipped.
        max_row_nnz = int(_np.max(_np.sum(_np.asarray(spikes) != 0, axis=1,
                                          dtype=_np.int32), initial=0))
        if max_row_nnz > row_size:
            raise ValueError(
                f'`row_size={row_size}` is too small for the input spikes; '
                f'max row NNZ is {max_row_nnz}.')
    return binary_2d_row_sparse_encode_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n_src, row_size), jnp.int32)],
        row_size=row_size,
        backend=backend,
    )


binary_2d_row_sparse_encode_p.def_call(binary_2d_row_sparse_encode_p_call)


# =============================================================================
# CSR row count / fill / combined encode
# =============================================================================

def _binary_2d_csr_row_count_jax_kernel(**params):
    def kernel(spikes):
        return (jnp.sum(_mask_of(spikes), axis=1, dtype=jnp.int32),)
    return kernel


binary_2d_csr_row_count_p = XLACustomKernel(
    'binary_2d_csr_row_count',
    doc='Row-wise non-zero count of a 2D spike matrix '
        '(reference _event/compact.py:1014).',
)
binary_2d_csr_row_count_p.def_jax_kernel(_binary_2d_csr_row_count_jax_kernel, asdefault=True)
binary_2d_csr_row_count_p.def_tags('event', 'binary', 'csr')


def binary_2d_csr_row_count_p_call(spikes, *, backend: Optional[str] = None):
    """Returns ``(row_counts (n,) int32,)``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    return binary_2d_csr_row_count_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((spikes.shape[0],), jnp.int32)],
        backend=backend,
    )


binary_2d_csr_row_count_p.def_call(binary_2d_csr_row_count_p_call)


def _binary_2d_csr_fill_jax_kernel(**params):
    def kernel(spikes, indptr):
        n, b = spikes.shape
        cap = n * b
        mask = _mask_of(spikes)
        # position of each active (r, c) within its row's segment
        within = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
        flat_pos = indptr[:-1][:, None] + within
        cols = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[None, :], (n, b))
        safe = jnp.where(mask, flat_pos, cap)
        out = jnp.zeros(cap, dtype=jnp.int32)
        return (out.at[safe.reshape(-1)].set(cols.reshape(-1), mode='drop'),)
    return kernel


binary_2d_csr_fill_p = XLACustomKernel(
    'binary_2d_csr_fill',
    doc='Fill a flat static-capacity CSR column-index buffer from dense '
        'spikes + precomputed row pointers (reference _event/compact.py:1136).',
)
binary_2d_csr_fill_p.def_jax_kernel(_binary_2d_csr_fill_jax_kernel, asdefault=True)
binary_2d_csr_fill_p.def_tags('event', 'binary', 'csr')


def binary_2d_csr_fill_p_call(spikes, indptr, *, backend: Optional[str] = None):
    """Returns ``(indices (n*b,) int32,)``; valid in ``indices[:indptr[-1]]``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    if indptr.shape[0] != spikes.shape[0] + 1:
        raise ValueError(
            f'indptr length must be spikes.shape[0]+1 ({spikes.shape[0] + 1}), '
            f'got {indptr.shape[0]}.'
        )
    indptr = jnp.asarray(indptr, dtype=jnp.int32)
    n, b = spikes.shape
    return binary_2d_csr_fill_p(
        spikes, indptr,
        outs=[jax.ShapeDtypeStruct((n * b,), jnp.int32)],
        backend=backend,
    )


binary_2d_csr_fill_p.def_call(binary_2d_csr_fill_p_call)


def binary_2d_csr_encode_p_call(spikes, *, backend: Optional[str] = None):
    """Dense 2D spikes -> static-capacity CSR ``(indices, indptr)``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    (row_counts,) = binary_2d_csr_row_count_p_call(spikes, backend=backend)
    indptr = jnp.concatenate([
        jnp.zeros((1,), dtype=jnp.int32),
        jnp.cumsum(row_counts, dtype=jnp.int32),
    ])
    (indices,) = binary_2d_csr_fill_p_call(spikes, indptr, backend=backend)
    return indices, indptr


# =============================================================================
# CSC encode
# =============================================================================

def _binary_2d_csc_encode_jax_kernel(**params):
    def kernel(spikes):
        n, b = spikes.shape
        cap = n * b
        mask = _mask_of(spikes)
        col_counts = jnp.sum(mask, axis=0, dtype=jnp.int32)
        indptr = jnp.concatenate([
            jnp.zeros((1,), dtype=jnp.int32),
            jnp.cumsum(col_counts, dtype=jnp.int32),
        ])
        within = jnp.cumsum(mask, axis=0, dtype=jnp.int32) - 1
        flat_pos = indptr[:-1][None, :] + within
        rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, b))
        safe = jnp.where(mask, flat_pos, cap)
        indices = jnp.zeros(cap, dtype=jnp.int32).at[
            safe.reshape(-1)].set(rows.reshape(-1), mode='drop')
        return indices, indptr
    return kernel


binary_2d_csc_encode_p = XLACustomKernel(
    'binary_2d_csc_encode',
    doc='Dense 2D spikes -> static-capacity CSC (row-index buffer + column '
        'pointers) (reference _event/compact.py:1259).',
)
binary_2d_csc_encode_p.def_jax_kernel(_binary_2d_csc_encode_jax_kernel, asdefault=True)
binary_2d_csc_encode_p.def_tags('event', 'binary', 'csc')


def binary_2d_csc_encode_p_call(spikes, *, backend: Optional[str] = None):
    """Returns ``(indices (n*b,) int32, indptr (b+1,) int32)``."""
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    n, b = spikes.shape
    return binary_2d_csc_encode_p(
        spikes,
        outs=[jax.ShapeDtypeStruct((n * b,), jnp.int32),
              jax.ShapeDtypeStruct((b + 1,), jnp.int32)],
        backend=backend,
    )


binary_2d_csc_encode_p.def_call(binary_2d_csc_encode_p_call)


def binary_2d_csc_from_array(spikes, *, backend: Optional[str] = None):
    """Function-style wrapper: dense 2D spikes -> CSC ``(indices, indptr)``."""
    spikes = jnp.asarray(spikes)
    return binary_2d_csc_encode_p_call(spikes, backend=backend)


# Generic batching for all encoders.
for _p in (
    binary_1d_array_index_p, binary_2d_compact_only_p, binary_2d_array_index_p,
    binary_2d_pair_stream_encode_p, binary_2d_row_sparse_encode_p,
    binary_2d_csr_row_count_p, binary_2d_csr_fill_p, binary_2d_csc_encode_p,
):
    _p.def_general_batching()
