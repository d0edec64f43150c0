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

"""Event-driven fixed-number-connectivity (ELL) products
(reference ``brainevent/_fcn/binary.py``).

``binary_fcnmv(weights, indices, spikes, shape=(n_pre, n_post), transpose)``:

- ``transpose=False`` (gather): ``y[i] = sum_k w[i,k] * gate(s[indices[i,k]])``
- ``transpose=True`` (scatter): ``y[indices[i,k]] += w[i,k] * gate(s[i])``

The scatter direction is the hot path of event-driven SNN simulation
(presynaptic spikes -> postsynaptic currents). The design is a
**compact-scatter**: active spike rows are stream-compacted into a static
capacity buffer (``max(128, n_pre // divisor)``), only those rows' target
indices are gathered and scatter-added, and a ``lax.cond`` falls back to the
full scatter if more neurons fire than the capacity — exact at every firing
rate, O(active x n_conn) in the steady state. This replaces the reference's CUDA scatter kernels with
atomicAdd (``_fcn/binary_fcnmv.cu``).
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .. import config
from .._compat import ad
from .._misc import namescope, check_fixed_conn_num_shape
from ..ops.core import XLACustomKernel
from ..ops.util import general_batching_rule
from ..ops.benchmark import BenchmarkConfig
from ..ops.scatter import event_scatter_add
from ..units import maybe_unit, split_mantissa_unit

__all__ = [
    'binary_fcnmv', 'binary_fcnmv_p', 'binary_fcnmv_p_call',
    'binary_fcnmm', 'binary_fcnmm_p', 'binary_fcnmm_p_call',
]


def _gate(s, dtype):
    return s.astype(dtype) if s.dtype == jnp.bool_ else (s > 0).astype(dtype)


def event_capacity(n: int) -> int:
    """Static active-spike capacity for compact event scatter.

    Sized for biological firing regimes (a few percent of neurons active per
    dt) with a several-fold margin; the ``lax.cond`` overflow fallback keeps
    results exact beyond it, so a tight capacity only ever costs a slower
    step, never accuracy.
    """
    div = config.get_event_capacity_divisor()
    cap = max(64, -(-n // div))
    cap = ((cap + 7) // 8) * 8
    return min(n, cap)


def _full_scatter(weights, indices, gate_vec, n_post, out_dtype):
    """Dense-mask scatter over the whole ELL (the overflow fallback)."""
    if weights.size == 1:
        vals = jnp.broadcast_to(
            weights[0].astype(out_dtype) * gate_vec[:, None], indices.shape)
    else:
        vals = weights.astype(out_dtype) * gate_vec[:, None]
    return event_scatter_add(indices, vals, n_post, dtype=out_dtype)


def _compact_scatter(weights, indices, spikes, n_post, out_dtype):
    """Event-driven scatter: compact active rows, gather their targets,
    scatter only those. Falls back to the full scatter on overflow."""
    n_pre = indices.shape[0]
    cap = event_capacity(n_pre)
    homo = weights.size == 1
    gate_vec = _gate(spikes, out_dtype)

    active = spikes if spikes.dtype == jnp.bool_ else (spikes > 0)
    n_active = jnp.sum(active, dtype=jnp.int32)
    (ids,) = jnp.nonzero(active, size=cap, fill_value=n_pre)
    valid = ids < n_pre
    safe_ids = jnp.where(valid, ids, 0)
    tgt = indices[safe_ids]                      # (cap, n_conn)
    if homo:
        vals = jnp.broadcast_to(weights[0], tgt.shape).astype(out_dtype)
    else:
        vals = weights[safe_ids].astype(out_dtype)
    # float events: the gate value multiplies (it is 0/1 after gating)
    vals = vals * gate_vec[safe_ids][:, None]
    mask = jnp.broadcast_to(valid[:, None], tgt.shape)
    compact_out = event_scatter_add(tgt, vals, n_post, mask=mask,
                                    dtype=out_dtype)

    if cap >= n_pre:
        return compact_out
    return jax.lax.cond(
        n_active <= cap,
        lambda: compact_out,
        lambda: _full_scatter(weights, indices, gate_vec, n_post, out_dtype),
    )


def _binary_fcnmv_jax_kernel(*, shape, transpose, **params):
    n_pre, n_post = shape
    out_dtype = params['outs'][0].dtype

    def kernel(weights, indices, spikes):
        if transpose:
            return (_compact_scatter(weights, indices, spikes, n_post,
                                     out_dtype),)
        # gather: y[i] = sum_k w[i,k] * gate(s[indices[i,k]])
        g = _gate(spikes, out_dtype)
        taken = g[indices]                       # (n_pre, n_conn)
        if weights.size == 1:
            return (weights[0] * jnp.sum(taken, axis=1),)
        return (jnp.sum(weights * taken, axis=1),)

    return kernel


def _binary_fcnmv_jvp_weights(w_dot, weights, indices, spikes, **params):
    return binary_fcnmv_p_call(w_dot, indices, spikes,
                               shape=params['shape'],
                               transpose=params['transpose'],
                               backend=params.get('backend'))


def _binary_fcnmv_jvp_spikes(s_dot, weights, indices, spikes, **params):
    from .float import fcnmv_p_call
    return fcnmv_p_call(weights, indices, s_dot,
                        shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _binary_fcnmv_transpose_rule(ct, weights, indices, spikes, **params):
    from .float import fcnmv_p_call
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(spikes):
        s_bar = fcnmv_p_call(weights, indices, ct,
                             shape=shape, transpose=not transpose,
                             backend=params.get('backend'))[0]
        return weights, indices, s_bar
    # d/dw[i,k]: gate at the appropriate endpoint times ct at the other.
    g = _gate(spikes, ct.dtype)
    if transpose:
        w_bar = g[:, None] * ct[indices]
    else:
        w_bar = ct[:, None] * g[indices]
    w_shape = (weights.aval.shape if ad.is_undefined_primal(weights)
               else weights.shape)
    if w_shape == (1,):
        w_bar = jnp.sum(w_bar).reshape(1)
    return w_bar, indices, spikes


def _binary_fcnmv_batching(args, axes, **params):
    weights, indices, spikes = args
    wa, ia, sa = axes
    if wa is None and ia is None and sa is not None and spikes.ndim == 2:
        S = jnp.moveaxis(spikes, sa, 1)
        out = binary_fcnmm_p_call(weights, indices, S,
                                  shape=params['shape'],
                                  transpose=params['transpose'],
                                  backend=params.get('backend'))
        return out, [1]
    return general_batching_rule(binary_fcnmv_p, args, axes, **params)


binary_fcnmv_p = XLACustomKernel(
    'binary_fcnmv',
    doc='Event-driven ELL matvec (reference brainevent/_fcn/binary.py:43).',
)
binary_fcnmv_p.def_jax_kernel(_binary_fcnmv_jax_kernel, asdefault=True)
binary_fcnmv_p.def_jvp_rule2(
    _binary_fcnmv_jvp_weights, None, _binary_fcnmv_jvp_spikes)
binary_fcnmv_p.def_transpose_rule(_binary_fcnmv_transpose_rule)
binary_fcnmv_p.def_batching_rule(_binary_fcnmv_batching)
binary_fcnmv_p.def_tags('fcn', 'binary', 'mv')


def binary_fcnmv_p_call(weights, indices, spikes, *, shape,
                        transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    out_len = check_fixed_conn_num_shape(
        indices.shape, spikes.shape[0], shape, transpose)
    assert weights.shape in ((1,), tuple(indices.shape)), (
        f'weights must be (1,) or {tuple(indices.shape)}, got {weights.shape}')
    return binary_fcnmv_p(
        weights, indices, spikes,
        outs=[jax.ShapeDtypeStruct((out_len,), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        spike_info=jax.ShapeDtypeStruct(spikes.shape, spikes.dtype),
    )


binary_fcnmv_p.def_call(binary_fcnmv_p_call)


@namescope(name='binary_fcnmv', static_argnames=('shape', 'transpose', 'backend'))
def binary_fcnmv(weights, indices, spikes, *, shape,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven ELL matvec (unit-aware)."""
    w, w_unit = split_mantissa_unit(weights)
    s, s_unit = split_mantissa_unit(spikes)
    (out,) = binary_fcnmv_p_call(w, indices, s, shape=shape,
                                 transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, s_unit)


def _binary_fcnmv_benchmark_data(*, platform):
    import numpy as np
    rng = np.random.default_rng(0)
    configs = []
    for n, n_conn, rate in ((4000, 80, 0.005), (40000, 80, 0.005),
                            (10000, 100, 0.01)):
        indices = jnp.asarray(rng.integers(0, n, (n, n_conn)), dtype=jnp.int32)
        w = jnp.asarray([0.5], dtype=jnp.float32)
        s = jnp.asarray(rng.random(n) < rate)
        for transpose in (True, False):
            configs.append(BenchmarkConfig(
                f'n={n},conn={n_conn},rate={rate},{"T" if transpose else "NT"}',
                (w, indices, s), {'shape': (n, n), 'transpose': transpose}))
    return configs


binary_fcnmv_p.def_benchmark_data(_binary_fcnmv_benchmark_data)


# =============================================================================
# mm
# =============================================================================

def _binary_fcnmm_jax_kernel(*, shape, transpose, **params):
    n_pre, n_post = shape
    out_dtype = params['outs'][0].dtype

    def kernel(weights, indices, S):
        g = _gate(S, out_dtype)                   # (n, batch)
        homo = weights.size == 1
        if transpose:
            # out[indices[i,k], b] += w[i,k] * g[i, b]
            n_batch = S.shape[1]
            if homo:
                vals = jnp.repeat(g, indices.shape[1], axis=0
                                  ).reshape(n_pre, indices.shape[1], n_batch)
                vals = vals * weights[0]
            else:
                vals = weights[:, :, None] * g[:, None, :]
            flat_idx = indices.reshape(-1)
            flat_vals = vals.reshape(-1, n_batch)
            out = jnp.zeros((n_post, n_batch), dtype=out_dtype)
            return (out.at[flat_idx].add(flat_vals, mode='drop'),)
        taken = g[indices]                        # (n_pre, n_conn, batch)
        if homo:
            return (weights[0] * jnp.sum(taken, axis=1),)
        return (jnp.sum(weights[:, :, None] * taken, axis=1),)

    return kernel


def _binary_fcnmm_jvp_weights(w_dot, weights, indices, S, **params):
    return binary_fcnmm_p_call(w_dot, indices, S,
                               shape=params['shape'],
                               transpose=params['transpose'],
                               backend=params.get('backend'))


def _binary_fcnmm_jvp_S(S_dot, weights, indices, S, **params):
    from .float import fcnmm_p_call
    return fcnmm_p_call(weights, indices, S_dot,
                        shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _binary_fcnmm_transpose_rule(ct, weights, indices, S, **params):
    from .float import fcnmm_p_call
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(S):
        S_bar = fcnmm_p_call(weights, indices, ct,
                             shape=shape, transpose=not transpose,
                             backend=params.get('backend'))[0]
        return weights, indices, S_bar
    g = _gate(S, ct.dtype)
    if transpose:
        w_bar = jnp.einsum('ib,ikb->ik', g, ct[indices])
    else:
        w_bar = jnp.einsum('ib,ikb->ik', ct, g[indices])
    if (weights.aval.shape == (1,) if ad.is_undefined_primal(weights)
            else weights.shape == (1,)):
        w_bar = jnp.sum(w_bar).reshape(1)
    return w_bar, indices, S


binary_fcnmm_p = XLACustomKernel(
    'binary_fcnmm',
    doc='Event-driven ELL matmat (reference brainevent/_fcn/binary.py:564).',
)
binary_fcnmm_p.def_jax_kernel(_binary_fcnmm_jax_kernel, asdefault=True)
binary_fcnmm_p.def_jvp_rule2(
    _binary_fcnmm_jvp_weights, None, _binary_fcnmm_jvp_S)
binary_fcnmm_p.def_transpose_rule(_binary_fcnmm_transpose_rule)
binary_fcnmm_p.def_general_batching()
binary_fcnmm_p.def_tags('fcn', 'binary', 'mm')


def binary_fcnmm_p_call(weights, indices, S, *, shape,
                        transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    assert S.ndim == 2
    out_len = check_fixed_conn_num_shape(
        indices.shape, S.shape[0], shape, transpose)
    return binary_fcnmm_p(
        weights, indices, S,
        outs=[jax.ShapeDtypeStruct((out_len, S.shape[1]), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
        spike_info=jax.ShapeDtypeStruct(S.shape, S.dtype),
    )


binary_fcnmm_p.def_call(binary_fcnmm_p_call)


@namescope(name='binary_fcnmm', static_argnames=('shape', 'transpose', 'backend'))
def binary_fcnmm(weights, indices, S, *, shape,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven ELL matmat (unit-aware)."""
    w, w_unit = split_mantissa_unit(weights)
    s, s_unit = split_mantissa_unit(S)
    (out,) = binary_fcnmm_p_call(w, indices, s, shape=shape,
                                 transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, s_unit)
