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

"""Event-compacted implicit scatter products over a walk plan.

The full walk visits every stream regardless of event sparsity — for a
binary operand with a few hundred active rows out of 80k that is ~99% dead
work. This route is the JITC analog of the FCN compact-scatter path
(``fcn/binary.py``): compact the active rows, gather THEIR plan streams,
walk only those streams for a **static** number of rounds collecting
(target, weight) candidates, and scatter-add the candidates
(:func:`brainevent_tpu.ops.scatter.event_scatter_add`).

Exactness is unconditional: each compacted stream replays exactly the
same draw sequence as :func:`brainevent_tpu.jitc.engine.walk_fold` (same
stationary initial ``q`` — it comes from the same plan — same
``next/bounded`` advance), and a ``lax.cond`` fallback to the full
product fires whenever the active-row count exceeds the static
capacity or any stream is still inside its chunk after ``scan_rounds``
rounds. A tight capacity or round bound only ever costs a slower step,
never accuracy (the ``event_capacity`` contract of ``fcn/binary.py``).

The reference's CUDA event kernels skip inactive rows per SIMT thread
(``brainevent/_jit_normal/binary_jitnmv.cu`` early-outs on the spike
test); under XLA's static shapes the skip must be a *shape* change —
compaction — not a branch, hence this formulation.
"""

import math
from typing import Optional

import jax
import jax.numpy as jnp

from .._misc import _MV_STRIDE
from ..ops.scatter import event_scatter_add
from ..rng.light import light_rng_bounded, light_rng_next

__all__ = ['default_scan_rounds', 'jitc_event_matvec_plan']

_U = jnp.uint32


def default_scan_rounds(prob: float, chunk_size: int, n_streams: int,
                        *, miss_budget: float = 1e-3,
                        max_rounds: int = 64) -> int:
    """Static per-stream round bound for the event-compacted walk.

    A stream's hit count over a ``chunk_size``-column chunk is the number
    of partial sums of iid skips ``~ 1 + U[1, clen-1]`` that stay below
    ``ceil(chunk_size/32)``; ``P(>= R hits) <= ratio^R / R!`` with
    ``ratio = chunk_size / (32 * (clen - 1))`` (simplex volume bound).
    Picks the smallest ``R`` whose bound, summed over ``n_streams``,
    stays under *miss_budget* per call — misses are not errors (the
    residual check falls back to the exact full product), just slow
    steps.
    """
    clen = max(2.0, 2.0 / max(prob, 1e-9))
    ratio = chunk_size / (_MV_STRIDE * max(clen - 1.0, 1.0))
    bound = 1.0
    for r in range(1, max_rounds + 1):
        bound *= ratio / r
        if bound * n_streams <= miss_budget:
            return r
    return max_rounds


def default_row_cap(prob: float, n_cols: int, slots: int) -> int:
    """Static per-row candidate capacity for the compaction stage.

    Per-row hit count is ~Poisson(deg) with ``deg = prob * n_cols``;
    ``deg + 5 sqrt(deg) + 16`` puts the overflow probability far below
    per-step relevance (the residual check falls back exactly anyway).
    Clamped to the raw slot count (no compaction win beyond it).
    """
    deg = max(1.0, prob * n_cols)
    cap = int(math.ceil((deg + 5.0 * math.sqrt(deg) + 16.0) / 8.0) * 8)
    return min(slots, cap)


def jitc_event_matvec_plan(weight_fn_raw, npar: int, params, seed, v,
                           out_len: int, *, n_rows: int, chunk_size: int,
                           setup, scan_rounds: int, cap: int,
                           fallback, out_dtype=jnp.float32,
                           row_cap: Optional[int] = None):
    """Event-compacted ``out[col] += w(row, col)`` over active rows of *v*.

    Parameters
    ----------
    weight_fn_raw : Callable
        ``weight_fn_raw(params, seed, rows, cols) -> weights`` (the
        family's weight law).
    v : array (n_rows,)
        Binary/gating operand; rows with ``v > 0`` (or true) are active.
    setup : (state2 (n_rows, L) u32, q2 (n_rows, L) u32, cl scalar u32)
        The walk plan for this product's scatter-direction geometry.
    scan_rounds : int
        Static walk rounds per compacted stream
        (:func:`default_scan_rounds`).
    cap : int
        Static active-row capacity.
    fallback : Callable () -> (out_len,) array
        Exact full product, entered via ``lax.cond`` on overflow (active
        rows > *cap*) or residual (any stream still in-chunk after
        *scan_rounds*).
    """
    state2, q2, cl = setup
    L = state2.shape[1]
    n_chunks = L // _MV_STRIDE

    # active-row compaction through the library's own event encoder
    # (events/compact_ops.py binary_1d_array_index)
    from ..events.compact_ops import binary_1d_array_index_p_call
    idbuf, count = binary_1d_array_index_p_call(v)
    n_act = count[0]
    take = min(cap, idbuf.shape[0])
    ids_c = jax.lax.slice(idbuf, (0,), (take,))
    if take < cap:
        ids_c = jnp.pad(ids_c, (0, cap - take))
    valid = jax.lax.iota(jnp.int32, cap) < n_act
    safe = jnp.where(valid, ids_c, 0)

    # gather the active rows' streams (row-contiguous gather: cap rows of
    # L u32 each, not an element gather)
    st = state2[safe].reshape(cap, n_chunks, _MV_STRIDE)
    q = q2[safe].reshape(cap, n_chunks, _MV_STRIDE).astype(jnp.uint32)

    shape3 = (cap, n_chunks, _MV_STRIDE)
    rows3 = jnp.broadcast_to(
        safe.astype(jnp.uint32)[:, None, None], shape3)
    valid3 = jnp.broadcast_to(valid[:, None, None], shape3)
    chunks3 = jax.lax.broadcasted_iota(jnp.uint32, shape3, 1)
    lanes3 = jax.lax.broadcasted_iota(jnp.uint32, shape3, 2)
    chunk_start = chunks3 * _U(chunk_size)
    chunk_width = jnp.minimum(_U(chunk_size), _U(out_len) - chunk_start)

    # walk_fold's loop body as a fori_loop (one traced body regardless
    # of scan_rounds — unrolling it made XLA compile minutes-slow),
    # collecting per-round TARGETS into a static buffer. Weights are NOT
    # computed here: the weight law is stateless in (seed, row, col)
    # (rng/light.py edge hash), so the evaluation defers to the row_cap
    # survivors after compaction: an in-loop evaluation would pay
    # rounds x cap x L Acklam draws plus a second (rounds, cap, L) f32
    # buffer and a 2-operand sort for identical output.
    def round_body(r, carry):
        st, q, tgt_buf = carry
        local_j = lanes3 + _U(_MV_STRIDE) * q
        active = jnp.logical_and(local_j < chunk_width, valid3)
        cols3 = chunk_start + local_j
        tgt_r = jnp.where(active, cols3.astype(jnp.int32), out_len)
        tgt_buf = jax.lax.dynamic_update_index_in_dim(
            tgt_buf, tgt_r.reshape(cap, L), r, 0)
        st = light_rng_next(st)
        q = q + _U(1) + light_rng_bounded(st, cl - _U(1))
        return st, q, tgt_buf

    tgt_buf0 = jnp.full((scan_rounds, cap, L), out_len, jnp.int32)
    st, q, tgt_buf = jax.lax.fori_loop(
        0, scan_rounds, round_body, (st, q, tgt_buf0))
    local_j = lanes3 + _U(_MV_STRIDE) * q
    residual = jnp.any(jnp.logical_and(local_j < chunk_width, valid3))

    slots = scan_rounds * L
    # (cap, scan_rounds * L): all of one row's candidates on one axis
    tgt2 = tgt_buf.transpose(1, 0, 2).reshape(cap, slots)

    # Tiered tail: compaction puts the n_act live rows FIRST, so rows
    # >= n_act are pure sentinel and a prefix slice is exact — and
    # EVERYTHING downstream (the per-row candidate sort, the deferred
    # weight evaluation, the scatter's per-slot bill) scales with the
    # sliced row count. The static cap keeps burst headroom (a tight cap
    # sends burst steps to the full product); the
    # lax.switch picks the smallest prefix covering THIS step's rows,
    # so typical steps pay a quarter/half of the burst capacity.
    def tail(budget):
        t2 = tgt2[:budget]
        over = jnp.bool_(False)
        if row_cap is not None and row_cap < slots:
            # per-row compaction: sort each row's candidates by target
            # (the out_len sentinel sorts last), keep the first row_cap
            # — the sort cuts the scatter input ~slots/row_cap fold.
            # Single-operand sort: the row id is the (implicit)
            # sort dimension and weights don't exist yet.
            t2 = jax.lax.sort(t2, dimension=1)
            over = jnp.any(t2[:, row_cap] < out_len)
            t2 = t2[:, :row_cap]
        # deferred weight evaluation on the surviving candidates only
        live2 = t2 < out_len
        rows2 = jnp.broadcast_to(
            safe.astype(jnp.uint32)[:budget, None], t2.shape)
        cols2 = jnp.where(live2, t2, 0).astype(jnp.uint32)
        w2 = weight_fn_raw(params, seed, rows2, cols2).astype(jnp.float32)
        val2 = jnp.where(live2, w2, 0.0)
        out = event_scatter_add(t2.reshape(-1), val2.reshape(-1), out_len,
                                dtype=jnp.float32).astype(out_dtype)
        return out, over

    eighth = max(1, cap // 8)
    quarter = max(1, cap // 4)
    half = max(1, cap // 2)
    idx = jnp.where(n_act <= eighth, 3,
                    jnp.where(n_act <= quarter, 2,
                              jnp.where(n_act <= half, 1, 0)))
    out_fast, over_row = jax.lax.switch(
        idx, [lambda: tail(cap), lambda: tail(half),
              lambda: tail(quarter), lambda: tail(eighth)])

    overflow = jnp.logical_or(jnp.logical_or(n_act > cap, residual),
                              over_row)
    return jax.lax.cond(overflow, lambda: fallback().astype(out_dtype),
                        lambda: out_fast)
