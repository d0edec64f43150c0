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

"""Sharded event-driven operators over a device mesh.

Op-level multi-device wrappers (an extension; the reference is
single-GPU, SURVEY §2.9). The sharding recipe for event SpMV follows the
"How to Scale Your Model" playbook: pick a mesh, shard the synapse tables
by presynaptic rows aligned with the spike vector, compute local partials
with the REAL single-chip primitives inside ``shard_map`` (so backend
dispatch, AD and vmap rules all apply per shard), and reduce with one
collective:

- gather direction (``transpose=False``): the output is row-aligned with
  the shards — no communication at all; the padded tail is sliced off.
- scatter direction (``transpose=True``): full-length local partials,
  reduced with ``reduce='psum'`` (replicated output) or
  ``reduce='psum_scatter'`` (output sharded along the mesh axis — the
  minimal-traffic choice when the consumer is also sharded).

Arbitrary sizes are handled by PADDING, not divisibility errors: FCN rows
pad with zero-weight connections, CSR structures are rebalanced into
equal-``nse`` row-aligned shards by :func:`balance_csr_shards` (dummy
entries attach to padded empty rows, so they are exactly inert in both
directions). Structure padding happens host-side on concrete index arrays
— build the plan once outside ``jit`` (or pass ``plan=``) and the wrapped
call itself is fully jittable/differentiable.
"""

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = [
    'sharded_binary_fcnmv', 'sharded_fcnmv',
    'sharded_binary_fcnmm', 'sharded_fcnmm',
    'sharded_binary_csrmv', 'sharded_csrmv',
    'sharded_binary_csrmm', 'sharded_csrmm',
    'CsrShardPlan', 'balance_csr_shards',
    'sharded_jitmv',
]


def _reduce(partial_out, axis, reduce):
    if reduce == 'psum':
        return jax.lax.psum(partial_out, axis)
    if reduce == 'psum_scatter':
        return jax.lax.psum_scatter(partial_out, axis,
                                    scatter_dimension=0, tiled=True)
    raise ValueError(f"reduce must be 'psum' or 'psum_scatter', got {reduce!r}")


def _concrete(x, what):
    try:
        return np.asarray(x)
    except Exception:
        raise ValueError(
            f'{what} must be concrete (not a tracer) to build the shard '
            f'plan; construct the sharded op (or its plan) outside jit and '
            f'close over it.') from None


def _check_reduce(reduce, out_len, n_dev, transpose):
    if not transpose:
        return 'none'
    if reduce == 'psum_scatter' and out_len % n_dev:
        raise ValueError(
            f'psum_scatter needs the output length ({out_len}) divisible by '
            f'the mesh size ({n_dev}); use reduce="psum" or pad the '
            f'postsynaptic axis.')
    return reduce


# =============================================================================
# FCN (ELL) family
# =============================================================================

def _sharded_fcn(p_call, weights, indices, operand, *, mesh, shape,
                 transpose, axis, reduce, backend):
    axis = axis or mesh.axis_names[0]
    n_dev = int(np.prod([mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
    n_pre, n_post = shape
    weights = jnp.atleast_1d(jnp.asarray(weights))
    homo = weights.ndim == 1 and weights.shape[0] == 1
    rows_loc = -(-n_pre // n_dev)
    m_pad = rows_loc * n_dev
    pad = m_pad - n_pre
    reduce = _check_reduce(reduce, n_post, n_dev, transpose)

    indices = jnp.asarray(indices)
    if pad:
        indices = jnp.pad(indices, ((0, pad), (0, 0)))
    w = weights if homo else jnp.pad(weights, ((0, pad), (0, 0)))
    if transpose:
        # operand is spike/value vector (or matrix) over presynaptic rows
        op_pad = ((0, pad),) + ((0, 0),) * (operand.ndim - 1)
        operand = jnp.pad(operand, op_pad)
        op_spec, out_spec = P(axis), (P() if reduce == 'psum' else P(axis))
    else:
        op_spec, out_spec = P(), P(axis)
    w_spec = P() if homo else P(axis)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(w_spec, P(axis), op_spec), out_specs=out_spec,
             check_vma=False)
    def run(w_, idx_, op_):
        (out,) = p_call(w_, idx_, op_, shape=(rows_loc, n_post),
                        transpose=transpose, backend=backend)
        return out if reduce == 'none' else _reduce(out, axis, reduce)

    out = run(w, indices, operand)
    return out[:n_pre] if (not transpose and pad) else out


def sharded_binary_fcnmv(weights, indices, spikes, *, mesh: Mesh, shape,
                         transpose: bool = True, axis: Optional[str] = None,
                         reduce: str = 'psum', backend: Optional[str] = None):
    """Multi-chip event ELL product through the ``binary_fcnmv`` primitive.

    ``transpose=True`` (default, the scatter direction ``y = W.T @ s``)
    shards rows+spikes and reduces with one collective; ``transpose=False``
    (gather, ``y = W @ gate(s)``) replicates the spike vector and needs no
    communication. Row counts not divisible by the mesh pad with inert
    connections. Fully differentiable (the single-chip AD rules apply per
    shard; the collective transposes automatically).
    """
    from ..fcn.binary import binary_fcnmv_p_call
    return _sharded_fcn(binary_fcnmv_p_call, weights, indices, spikes,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend)


def sharded_fcnmv(weights, indices, v, *, mesh: Mesh, shape,
                  transpose: bool = True, axis: Optional[str] = None,
                  reduce: str = 'psum', backend: Optional[str] = None):
    """Multi-chip float ELL product through the ``fcnmv`` primitive."""
    from ..fcn.float import fcnmv_p_call
    return _sharded_fcn(fcnmv_p_call, weights, indices, v,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend)


def sharded_binary_fcnmm(weights, indices, S, *, mesh: Mesh, shape,
                         transpose: bool = True, axis: Optional[str] = None,
                         reduce: str = 'psum', backend: Optional[str] = None):
    """Multi-chip event ELL matmat through the ``binary_fcnmm`` primitive."""
    from ..fcn.binary import binary_fcnmm_p_call
    return _sharded_fcn(binary_fcnmm_p_call, weights, indices, S,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend)


def sharded_fcnmm(weights, indices, B, *, mesh: Mesh, shape,
                  transpose: bool = True, axis: Optional[str] = None,
                  reduce: str = 'psum', backend: Optional[str] = None):
    """Multi-chip float ELL matmat through the ``fcnmm`` primitive."""
    from ..fcn.float import fcnmm_p_call
    return _sharded_fcn(fcnmm_p_call, weights, indices, B,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend)


# =============================================================================
# CSR family
# =============================================================================

@dataclasses.dataclass(frozen=True)
class CsrShardPlan:
    """Static row-aligned equal-``nse`` resharding of a CSR structure.

    Built host-side by :func:`balance_csr_shards`; every field except the
    jnp arrays is Python-static so the plan can close over a jitted call.

    - ``indices_pad`` ``(n_dev * nse_loc,)`` and ``counts_pad``
      ``(n_dev * rows_loc,)``: the padded structure, shard-major. Dummy
      entries point at column 0 and attach to padded empty rows, so they
      contribute exactly zero in both product directions.
    - ``row_pos`` maps original row -> padded position (for operand
      scatter / output gather); ``nse_pos`` maps original nonzero ->
      padded position (for heterogeneous weight scatter).
    """
    n_dev: int
    shape: tuple
    rows_loc: int
    nse_loc: int
    indices_pad: jnp.ndarray
    counts_pad: jnp.ndarray
    row_pos: jnp.ndarray
    nse_pos: jnp.ndarray

    def pad_weights(self, weights):
        weights = jnp.atleast_1d(jnp.asarray(weights))
        if weights.shape[0] == 1:
            return weights
        out = jnp.zeros((self.n_dev * self.nse_loc,), weights.dtype)
        return out.at[self.nse_pos].set(weights)

    def pad_rows(self, x, fill=0):
        """Scatter a row-aligned operand (1-D or 2-D) to padded order."""
        shp = (self.n_dev * self.rows_loc,) + x.shape[1:]
        out = jnp.full(shp, fill, dtype=x.dtype)
        return out.at[self.row_pos].set(x)

    def unpad_rows(self, y):
        return y[self.row_pos]


def balance_csr_shards(indices, indptr, n_dev: int,
                       shape=None) -> CsrShardPlan:
    """Split a CSR structure into ``n_dev`` row-aligned shards of equal
    padded size, balancing nonzeros across shards (the multi-chip analogue
    of the reference's hybrid task decomposition,
    ``/root/reference/brainevent/_csr/hybrid_config.py``).

    Row boundaries are chosen so each shard carries ~``nse / n_dev``
    nonzeros; shards then pad to the common ``rows_loc``/``nse_loc`` with
    empty rows that absorb the dummy entries.
    """
    indices = _concrete(indices, 'indices')
    indptr = _concrete(indptr, 'indptr')
    counts = np.diff(indptr).astype(np.int64)
    m = counts.shape[0]
    nse = int(indices.shape[0])
    if shape is None:
        shape = (m, int(indices.max()) + 1 if nse else 1)
    if n_dev <= 0:
        raise ValueError(f'n_dev must be positive, got {n_dev}')
    # contiguous row ranges with ~equal nnz: boundary b_s = first row whose
    # cumulative nnz reaches s * nse / n_dev
    cum = np.concatenate([[0], np.cumsum(counts)])
    targets = (np.arange(1, n_dev) * nse) / n_dev
    bounds = np.concatenate([[0], np.searchsorted(cum[1:], targets,
                                                  side='left') + 1, [m]])
    bounds = np.clip(bounds, 0, m)
    row_cnt = np.diff(bounds)
    nse_cnt = cum[bounds[1:]] - cum[bounds[:-1]]
    rows_loc = int(row_cnt.max()) + 1          # +1 padding row per shard
    nse_loc = int(nse_cnt.max())
    indices_pad = np.zeros((n_dev, nse_loc), dtype=indices.dtype)
    counts_pad = np.zeros((n_dev, rows_loc), dtype=np.int32)
    row_pos = np.empty(m, dtype=np.int64)
    nse_pos = np.empty(nse, dtype=np.int64)
    for s in range(n_dev):
        r0, r1 = int(bounds[s]), int(bounds[s + 1])
        e0, e1 = int(cum[r0]), int(cum[r1])
        k = e1 - e0
        indices_pad[s, :k] = indices[e0:e1]
        counts_pad[s, :r1 - r0] = counts[r0:r1]
        counts_pad[s, r1 - r0] = nse_loc - k      # dummy entries -> pad row
        row_pos[r0:r1] = s * rows_loc + np.arange(r1 - r0)
        nse_pos[e0:e1] = s * nse_loc + np.arange(k)
    return CsrShardPlan(
        n_dev=n_dev, shape=tuple(shape), rows_loc=rows_loc, nse_loc=nse_loc,
        indices_pad=jnp.asarray(indices_pad.reshape(-1)),
        counts_pad=jnp.asarray(counts_pad.reshape(-1)),
        row_pos=jnp.asarray(row_pos), nse_pos=jnp.asarray(nse_pos))


def _sharded_csr(p_call, weights, indices, indptr, operand, *, mesh, shape,
                 transpose, axis, reduce, backend, plan):
    axis = axis or mesh.axis_names[0]
    n_dev = int(np.prod([mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
    m, k = shape
    if plan is None:
        plan = balance_csr_shards(indices, indptr, n_dev, shape=shape)
    if plan.n_dev != n_dev or plan.shape != tuple(shape):
        raise ValueError(
            f'plan was built for n_dev={plan.n_dev}, shape={plan.shape}; '
            f'this call uses n_dev={n_dev}, shape={tuple(shape)}.')
    weights = jnp.atleast_1d(jnp.asarray(weights))
    homo = weights.shape[0] == 1
    w = plan.pad_weights(weights)
    rows_loc, nse_loc = plan.rows_loc, plan.nse_loc
    reduce = _check_reduce(reduce, k, n_dev, transpose)
    if transpose:
        operand = plan.pad_rows(operand)
        op_spec, out_spec = P(axis), (P() if reduce == 'psum' else P(axis))
    else:
        op_spec, out_spec = P(), P(axis)
    w_spec = P() if homo else P(axis)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(w_spec, P(axis), P(axis), op_spec),
             out_specs=out_spec, check_vma=False)
    def run(w_, idx_, cnt_, op_):
        indptr_loc = jnp.concatenate([
            jnp.zeros((1,), cnt_.dtype), jnp.cumsum(cnt_)])
        (out,) = p_call(w_, idx_, indptr_loc, op_,
                        shape=(rows_loc, k), transpose=transpose,
                        backend=backend)
        return out if reduce == 'none' else _reduce(out, axis, reduce)

    out = run(w, plan.indices_pad, plan.counts_pad, operand)
    return out if transpose else plan.unpad_rows(out)


def sharded_binary_csrmv(weights, indices, indptr, spikes, *, mesh: Mesh,
                         shape, transpose: bool = True,
                         axis: Optional[str] = None, reduce: str = 'psum',
                         backend: Optional[str] = None,
                         plan: Optional[CsrShardPlan] = None):
    """Multi-chip event CSR product through the ``binary_csrmv`` primitive.

    Rows (and the spike vector in the scatter direction) are sharded over
    *mesh* after :func:`balance_csr_shards` equalizes per-shard nonzeros;
    arbitrary structures work — no divisibility constraints. Pass a
    prebuilt ``plan`` to call under ``jit``.
    """
    from ..csr.binary import binary_csrmv_p_call
    return _sharded_csr(binary_csrmv_p_call, weights, indices, indptr,
                        spikes, mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_csrmv(weights, indices, indptr, v, *, mesh: Mesh, shape,
                  transpose: bool = True, axis: Optional[str] = None,
                  reduce: str = 'psum', backend: Optional[str] = None,
                  plan: Optional[CsrShardPlan] = None):
    """Multi-chip float CSR product through the ``csrmv`` primitive."""
    from ..csr.float import csrmv_p_call
    return _sharded_csr(csrmv_p_call, weights, indices, indptr, v,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_binary_csrmm(weights, indices, indptr, S, *, mesh: Mesh, shape,
                         transpose: bool = True, axis: Optional[str] = None,
                         reduce: str = 'psum', backend: Optional[str] = None,
                         plan: Optional[CsrShardPlan] = None):
    """Multi-chip event CSR matmat through the ``binary_csrmm`` primitive."""
    from ..csr.binary import binary_csrmm_p_call
    return _sharded_csr(binary_csrmm_p_call, weights, indices, indptr, S,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_csrmm(weights, indices, indptr, B, *, mesh: Mesh, shape,
                  transpose: bool = True, axis: Optional[str] = None,
                  reduce: str = 'psum', backend: Optional[str] = None,
                  plan: Optional[CsrShardPlan] = None):
    """Multi-chip float CSR matmat through the ``csrmm`` primitive."""
    from ..csr.float import csrmm_p_call
    return _sharded_csr(csrmm_p_call, weights, indices, indptr, B,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


# =============================================================================
# JITC (implicit connectivity): rows partition across the mesh; each shard
# walks its GLOBAL row range (engine row0 hook) so the sampled matrix is
# partition-invariant — how to shard a matrix with no storage.
# =============================================================================

_JITC_LAWS = {}


def _jitc_law(law: str):
    if not _JITC_LAWS:
        from ..jitc.scalar import _scalar_weight
        from ..jitc.normal import _normal_weight
        from ..jitc.uniform import _uniform_weight
        _JITC_LAWS.update(s=(_scalar_weight, 1), n=(_normal_weight, 2),
                          u=(_uniform_weight, 2))
    return _JITC_LAWS[law]


def sharded_jitmv(law: str, params, prob, v, seed, *, mesh: Mesh, shape,
                  corder: bool = True, axis: Optional[str] = None,
                  event: bool = False, transpose: bool = False):
    """Multi-chip implicit mat-vec (families ``'s'``/``'n'``/``'u'``).

    ``corder=True``: output rows shard; ``v`` replicates; no collective.
    ``corder=False`` (scatter direction): input rows shard; each shard
    scatters into a full-width output and ONE ``psum`` combines.  Each
    shard's streams are keyed on global row ids, so the result equals the
    single-chip :func:`brainevent_tpu.jitnmv` (etc.) bit-for-bit in
    structure (float sums associate differently across shards).

    ``transpose=True`` computes ``M.T @ v`` of the SAME sampled matrix
    ``M`` of ``shape`` (the weight-hash stream keys on the original
    orientation — ``logical_cols`` stays ``shape[1]`` — exactly like the
    single-chip family wrappers' ``transpose`` flag, so
    ``v @ JITCNormalR(...)`` class products are shardable stream-exactly:
    pass ``transpose=True, corder=not M.corder``).
    """
    from .._misc import _MV_STRIDE, _initialize_conn_length
    from ..jitc import engine

    axis = axis or mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    weight_fn, npar = _jitc_law(law)
    params = tuple(jnp.atleast_1d(jnp.asarray(p, jnp.float32))
                   for p in params)
    assert len(params) == npar, (law, len(params))
    clen = _initialize_conn_length(prob)
    seed_arr = jnp.atleast_1d(jnp.asarray(seed)).astype(jnp.uint32)

    out_len, in_len = ((shape[1], shape[0]) if transpose
                       else (shape[0], shape[1]))
    walk_rows = out_len if corder else in_len
    pad = (-walk_rows) % n_dev
    rows_p = walk_rows + pad

    wfn = lambda s, rows, cols: weight_fn(params, s, rows, cols)

    if corder:
        @partial(jax.shard_map, mesh=mesh, in_specs=(P(),),
                 out_specs=P(axis))
        def run(v_rep):
            i = jax.lax.axis_index(axis)
            local = rows_p // n_dev
            out = engine.walk_matvec(
                wfn, seed_arr[0], clen[0], v_rep, local, corder=True,
                logical_cols=shape[1], event=event,
                row0=i * local)
            return out

        return run(v)[:out_len]

    v_pad = jnp.pad(v, (0, pad))

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis),), out_specs=P())
    def run(v_loc):
        i = jax.lax.axis_index(axis)
        local = rows_p // n_dev
        out = engine.walk_matvec(
            wfn, seed_arr[0], clen[0], v_loc, out_len, corder=False,
            logical_cols=shape[1], event=event, row0=i * local)
        return jax.lax.psum(out, axis)

    return run(v_pad)
