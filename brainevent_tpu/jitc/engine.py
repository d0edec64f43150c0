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

"""The just-in-time connectivity walk engine.

The reference implements the geometric-skip connectivity sampler three times
per family (Numba scalar loops + two CUDA kernels per op, ~25k LoC across
``brainevent/_jit_scalar``, ``_jit_normal``, ``_jit_uniform``). This module
is the single engine behind all 24 JITC primitives:

- Streams are keyed ``(row, chunk, lane)`` exactly as the reference
  (``light_rng_init``), with ``stride = 32`` in mv mode / ``4`` in mm mode
  and ``chunk_size = ceil(shape[1] / 4)`` — the layout *is* the sampled
  matrix, so these constants are part of the data contract
  (``brainevent/_misc.py:37-38,74``).
- All streams advance **together** as whole uint32 arrays: one
  ``lax.while_loop`` round advances every still-active stream by one
  geometric skip. Expected rounds ≈ ``chunk_width * prob / stride`` + a
  small tail, so the loop is short and fully vectorized — the XLA
  counterpart of the reference's per-thread skip loops.

Walk orientation: for ``corder=True`` the walk rows are *output* indices and
walk cols are *input* indices; ``corder=False`` the reverse (scatter form).
Both draw different matrices by design (hash arguments swap) — the same
contract as the reference (``brainevent/_typing.py:79-82``).
"""

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .._misc import _MM_STRIDE, _MV_STRIDE, _normalize_chunk_size
from ..rng.light import (
    light_rng_bounded,
    light_rng_init,
    light_rng_initial_q,
    light_rng_next,
)

__all__ = [
    'walk_setup', 'walk_plan_setup', 'walk_fold',
    'walk_matvec', 'walk_matmat', 'walk_todense',
    'walk_count', 'walk_collect', 'walk_keys', 'walk_dt2t',
]

_U = jnp.uint32


def walk_setup(seed, clen, n_rows: int, n_cols: int, stride: int,
               chunk_size: int, row0=0):
    """Initialize every stream of the walk.

    Returns ``(rows3, chunks3, lanes3, state, q, cl)`` — all
    ``(n_rows, n_chunks, stride)`` arrays (``cl`` scalar uint32).
    ``row0`` (static or traced) offsets the walk-row ids: the streams of
    rows ``[row0, row0 + n_rows)`` — the sharding hook (each shard walks
    its GLOBAL row range so the sampled matrix is partition-invariant).
    """
    n_chunks = -(-n_cols // chunk_size)
    seed = jnp.asarray(seed).astype(jnp.uint32).reshape(())
    cl = jnp.maximum(jnp.asarray(clen).astype(jnp.uint32).reshape(()), _U(2))
    shape3 = (n_rows, n_chunks, stride)
    rows3 = (jax.lax.broadcasted_iota(jnp.uint32, shape3, 0)
             + jnp.asarray(row0).astype(jnp.uint32))
    chunks3 = jax.lax.broadcasted_iota(jnp.uint32, shape3, 1)
    lanes3 = jax.lax.broadcasted_iota(jnp.uint32, shape3, 2)
    state = light_rng_init(seed, rows3, chunks3, lanes3)
    q, state = light_rng_initial_q(state, cl)
    return rows3, chunks3, lanes3, state, q, cl


def walk_plan_setup(seed, clen, n_rows: int, n_cols: int, stride: int,
                    chunk_size: int):
    """The hoistable stream setup of a walk: ``(state2, q2, cl)`` with
    ``state2``/``q2`` of shape ``(n_rows, n_chunks * stride)`` uint32.

    The stationary initial ``q`` is drawn by rejection over all streams; it
    depends only on ``(seed, clen, n_rows, n_cols, chunk_size)``, so a
    matrix with fixed seed and shape can compute it once (the walk-plan
    primitives' operands).
    """
    n_chunks = -(-n_cols // chunk_size)
    _, _, _, state, q, cl = walk_setup(
        seed, clen, n_rows, n_cols, stride, chunk_size)
    return (state.reshape(n_rows, n_chunks * stride),
            q.reshape(n_rows, n_chunks * stride), cl)


def walk_fold(
    seed,
    clen,
    n_rows: int,
    n_cols: int,
    *,
    stride: int,
    chunk_size: Optional[int] = None,
    logical_cols: Optional[int] = None,
    body: Callable,
    carry,
    row_mask: Optional[jax.Array] = None,
    row0=0,
):
    """Drive the connectivity walk, folding *body* over rounds.

    Parameters
    ----------
    n_rows, n_cols : int
        Walk dimensions (rows = stream axis, cols = enumerated axis).
    logical_cols : int, optional
        The logical ``shape[1]`` that defines ``chunk_size`` when
        *chunk_size* is None (the reference keys chunking on the logical
        column count, not the walk width).
    body : Callable
        ``body(carry, rows3, cols3, active3) -> carry`` — called once per
        round with uint32 stream arrays and the active mask.
    row_mask : bool array (n_rows,), optional
        Rows whose streams never activate (event-driven skipping).

    Returns the folded carry.
    """
    if chunk_size is None:
        chunk_size = _normalize_chunk_size(
            n_cols if logical_cols is None else logical_cols, None)
    n_chunks = -(-n_cols // chunk_size)
    rows3, chunks3, lanes3, state, q, cl = walk_setup(
        seed, clen, n_rows, n_cols, stride, chunk_size, row0)

    chunk_start = chunks3 * _U(chunk_size)
    chunk_width = jnp.minimum(
        _U(chunk_size),
        _U(n_cols) - chunk_start,
    )
    # promote the carry to the streams' varying-manual-axes type: under
    # shard_map a plain-zeros carry is axis-unvarying while the body's
    # contributions vary, and the while_loop carry check rejects the mix
    # (outside shard_map this adds a fused-away zero)
    zvar = (state.reshape(-1)[0] * _U(0))
    carry = jax.tree.map(lambda c: c + zvar.astype(c.dtype), carry)
    local_j = lanes3 + _U(stride) * q
    alive_rows = (jnp.ones((n_rows, 1, 1), bool) if row_mask is None
                  else row_mask.reshape(n_rows, 1, 1))

    def cond(val):
        carry, state, q, local_j = val
        active = jnp.logical_and(local_j < chunk_width, alive_rows)
        return jnp.any(active)

    def loop(val):
        carry, state, q, local_j = val
        active = jnp.logical_and(local_j < chunk_width, alive_rows)
        cols3 = chunk_start + local_j
        carry = body(carry, rows3, cols3, active)
        state = light_rng_next(state)
        q = q + _U(1) + light_rng_bounded(state, cl - _U(1))
        local_j = lanes3 + _U(stride) * q
        return carry, state, q, local_j

    carry, _, _, _ = jax.lax.while_loop(cond, loop, (carry, state, q, local_j))
    return carry


# =============================================================================
# Derived operations. ``weight_fn(seed, rows, cols) -> f32 weights`` encodes
# the family's weight law (scalar/normal/uniform).
# =============================================================================

def walk_matvec(weight_fn, seed, clen, v, out_len: int, *,
                corder: bool, logical_cols: int, stride: int = _MV_STRIDE,
                event: bool = False, out_dtype=jnp.float32, row0=0):
    """Implicit mat-vec: ``out[row] += v[col] * w`` (corder=True walk) or
    ``out[col] += v[row] * w`` (corder=False walk)."""
    in_len = v.shape[0]
    if event:
        gate = (v.astype(out_dtype) if v.dtype == jnp.bool_
                else (v > 0).astype(out_dtype))
    else:
        gate = v.astype(out_dtype)

    if corder:
        n_rows, n_cols = out_len, in_len

        def body(carry, rows3, cols3, active):
            w = weight_fn(seed, rows3, cols3).astype(out_dtype)
            contrib = jnp.where(active, gate[cols3.astype(jnp.int32)] * w, 0)
            return carry + jnp.sum(contrib, axis=(1, 2))

        out = walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                        logical_cols=logical_cols, body=body,
                        carry=jnp.zeros(out_len, out_dtype), row0=row0)
        return out

    n_rows, n_cols = in_len, out_len
    row_mask = (v != 0) if event else None
    r0u = jnp.asarray(row0).astype(jnp.uint32)

    def body(carry, rows3, cols3, active):
        # rows3 carries GLOBAL walk-row ids (the weight-hash contract);
        # the operand lives in LOCAL coordinates under sharding
        w = weight_fn(seed, rows3, cols3).astype(out_dtype)
        vals = gate[(rows3 - r0u).astype(jnp.int32)] * w
        tgt = jnp.where(active, cols3.astype(jnp.int32), out_len)
        return carry.at[tgt.reshape(-1)].add(
            jnp.where(active, vals, 0).reshape(-1), mode='drop')

    out = walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                    logical_cols=logical_cols, body=body,
                    carry=jnp.zeros(out_len, out_dtype), row_mask=row_mask,
                    row0=row0)
    return out


def walk_matmat(weight_fn, seed, clen, B, out_len: int, *,
                corder: bool, logical_cols: int, stride: int = _MM_STRIDE,
                event: bool = False, out_dtype=jnp.float32):
    """Implicit mat-mat: rows of ``B`` are gathered/scattered whole."""
    in_len, n_batch = B.shape
    if event:
        gate = (B.astype(out_dtype) if B.dtype == jnp.bool_
                else (B > 0).astype(out_dtype))
    else:
        gate = B.astype(out_dtype)

    if corder:
        n_rows, n_cols = out_len, in_len

        def body(carry, rows3, cols3, active):
            w = weight_fn(seed, rows3, cols3).astype(out_dtype)
            vals = jnp.where(active, w, 0)[..., None] * \
                gate[cols3.astype(jnp.int32)]
            return carry + jnp.sum(vals, axis=(1, 2))

        return walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                         logical_cols=logical_cols, body=body,
                         carry=jnp.zeros((out_len, n_batch), out_dtype))

    n_rows, n_cols = in_len, out_len

    def body(carry, rows3, cols3, active):
        w = weight_fn(seed, rows3, cols3).astype(out_dtype)
        vals = jnp.where(active, w, 0)[..., None] * \
            gate[rows3.astype(jnp.int32)]
        tgt = jnp.where(active, cols3.astype(jnp.int32), out_len)
        return carry.at[tgt.reshape(-1)].add(
            vals.reshape(-1, n_batch), mode='drop')

    return walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                     logical_cols=logical_cols, body=body,
                     carry=jnp.zeros((out_len, n_batch), out_dtype))


def walk_todense(weight_fn, seed, clen, shape: Tuple[int, int], *,
                 corder: bool, stride: int = _MV_STRIDE,
                 out_dtype=jnp.float32):
    """Materialize the dense implicit matrix (logical orientation:
    ``M[r, c]``; corder=False walks the transposed layout)."""
    m, k = shape
    if corder:
        n_rows, n_cols = m, k
    else:
        n_rows, n_cols = k, m

    def body(carry, rows3, cols3, active):
        w = weight_fn(seed, rows3, cols3).astype(out_dtype)
        if corder:
            flat = rows3.astype(jnp.int32) * k + cols3.astype(jnp.int32)
        else:
            flat = cols3.astype(jnp.int32) * k + rows3.astype(jnp.int32)
        flat = jnp.where(active, flat, m * k)
        return carry.at[flat.reshape(-1)].add(
            jnp.where(active, w, 0).reshape(-1), mode='drop')

    dense = walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                      logical_cols=k, body=body,
                      carry=jnp.zeros(m * k, out_dtype))
    return dense.reshape(m, k)


def walk_count(seed, clen, shape: Tuple[int, int], *, corder: bool,
               stride: int = _MV_STRIDE):
    """Per-logical-row hit counts of the implicit matrix (int32, (m,))."""
    m, k = shape
    n_rows, n_cols = (m, k) if corder else (k, m)

    def body(carry, rows3, cols3, active):
        per_stream, logical = carry
        return per_stream + active.astype(jnp.int32), logical

    per_stream = jnp.zeros(
        (n_rows, -(-n_cols // _normalize_chunk_size(k, None)), stride),
        jnp.int32)
    per_stream, _ = walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                              logical_cols=k, body=body,
                              carry=(per_stream, None))
    walk_row_counts = jnp.sum(per_stream, axis=(1, 2))
    if corder:
        return walk_row_counts
    # corder=False: walk rows are logical columns; count per logical row
    # needs the per-hit row ids -> fall back to a scatter count.
    def body2(carry, rows3, cols3, active):
        tgt = jnp.where(active, cols3.astype(jnp.int32), m)
        return carry.at[tgt.reshape(-1)].add(
            active.astype(jnp.int32).reshape(-1), mode='drop')

    return walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                     logical_cols=k, body=body2,
                     carry=jnp.zeros(m, jnp.int32))


def walk_keys(seed, clen, shape: Tuple[int, int], nse: int, *,
              corder: bool, stride: int = _MV_STRIDE):
    """Sorted flat keys ``row * k + col`` of every hit, length ``nse``.

    ``nse`` must be the (static) total hit count from :func:`walk_count`.
    Hits are unique per (row, col) — lanes partition residues and ``q``
    strictly increases — so sorting flat keys yields the canonical
    column-sorted CSR flat order used by ``to_csr`` and ``dt2t``.
    """
    m, k = shape
    n_rows, n_cols = (m, k) if corder else (k, m)
    cap = max(int(nse), 1)

    def body(carry, rows3, cols3, active):
        keys, base = carry
        if corder:
            flat = rows3.astype(jnp.int32) * k + cols3.astype(jnp.int32)
        else:
            flat = cols3.astype(jnp.int32) * k + rows3.astype(jnp.int32)
        act_flat = active.reshape(-1)
        pos = base + jnp.cumsum(act_flat.astype(jnp.int32)) - 1
        pos = jnp.where(act_flat, pos, cap)
        keys = keys.at[pos].set(flat.reshape(-1), mode='drop')
        base = base + jnp.sum(act_flat.astype(jnp.int32))
        return keys, base

    keys0 = jnp.full(cap, jnp.iinfo(jnp.int32).max, jnp.int32)
    keys, _ = walk_fold(seed, clen, n_rows, n_cols, stride=stride,
                        logical_cols=k, body=body,
                        carry=(keys0, jnp.int32(0)))
    return jnp.sort(keys)


def walk_collect(weight_fn, seed, clen, shape: Tuple[int, int], nse: int, *,
                 corder: bool, stride: int = _MV_STRIDE,
                 out_dtype=jnp.float32):
    """Collect every hit as a sorted CSR ``(data, indices, indptr)``.

    See :func:`walk_keys` for the canonical-order argument.
    """
    m, k = shape
    keys = walk_keys(seed, clen, shape, nse, corder=corder, stride=stride)
    rows = keys // k
    cols = keys % k
    # weight hash uses WALK coordinates
    if corder:
        w = weight_fn(seed, rows.astype(jnp.uint32), cols.astype(jnp.uint32))
    else:
        w = weight_fn(seed, cols.astype(jnp.uint32), rows.astype(jnp.uint32))
    counts = jnp.zeros(m, jnp.int32).at[rows].add(1, mode='drop')
    indptr = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts, dtype=jnp.int32)])
    return (w.astype(out_dtype), cols.astype(jnp.int32), indptr)


def walk_dt2t(weight_fn, seed, clen, y, shape: Tuple[int, int], nse: int, *,
              transpose: bool, corder: bool, stride: int = _MV_STRIDE,
              out_dtype=jnp.float32):
    """Fused per-synapse ``w * y`` fill in canonical CSR flat order.

    The counterpart of the reference's fused dt2t fill primitive
    (``brainevent/_jit_normal/dt2t.py:121-232``): weights are regenerated
    from the hash at each structural non-zero and multiplied by the
    row-gathered (``transpose=False``) or column-gathered
    (``transpose=True``) trace — no CSR indices/indptr/data are ever
    materialized; the only O(nse) intermediate is the sorted key array
    that defines the canonical order.
    """
    m, k = shape
    keys = walk_keys(seed, clen, shape, nse, corder=corder, stride=stride)
    rows = keys // k
    cols = keys % k
    # weight hash uses WALK coordinates
    if corder:
        w = weight_fn(seed, rows.astype(jnp.uint32), cols.astype(jnp.uint32))
    else:
        w = weight_fn(seed, cols.astype(jnp.uint32), rows.astype(jnp.uint32))
    gathered = y[cols if transpose else rows]
    return w.astype(out_dtype) * gathered.astype(out_dtype)
