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

"""Float (non-event) fixed-number-connectivity products + dt2t
(reference ``brainevent/_fcn/float.py`` and ``_fcn/dt2t.py``)."""

from typing import Optional

import jax
import jax.numpy as jnp

from .._compat import ad
from .._misc import namescope, check_fixed_conn_num_shape
from ..ops.core import XLACustomKernel
from ..ops.util import general_batching_rule
from ..ops.scatter import event_scatter_add
from ..units import maybe_unit, split_mantissa_unit

__all__ = [
    'fcnmv', 'fcnmv_p', 'fcnmv_p_call',
    'fcnmm', 'fcnmm_p', 'fcnmm_p_call',
    'fcnmv_dt2t', 'fcnmm_dt2t',
]


def _fcnmv_jax_kernel(*, shape, transpose, **params):
    n_pre, n_post = shape
    out_dtype = params['outs'][0].dtype

    def kernel(weights, indices, v):
        homo = weights.size == 1
        vc = v.astype(out_dtype)
        if transpose:
            if homo:
                vals = jnp.broadcast_to(
                    weights[0] * vc[:, None], indices.shape)
            else:
                vals = weights * vc[:, None]
            return (event_scatter_add(indices, vals, n_post, dtype=out_dtype),)
        taken = vc[indices]
        if homo:
            return (weights[0] * jnp.sum(taken, axis=1),)
        return (jnp.sum(weights * taken, axis=1),)

    return kernel


def _fcnmv_jvp_weights(w_dot, weights, indices, v, **params):
    return fcnmv_p_call(w_dot, indices, v, shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _fcnmv_jvp_v(v_dot, weights, indices, v, **params):
    return fcnmv_p_call(weights, indices, v_dot, shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _fcnmv_transpose_rule(ct, weights, indices, v, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(v):
        v_bar = fcnmv_p_call(weights, indices, ct, shape=shape,
                             transpose=not transpose,
                             backend=params.get('backend'))[0]
        return weights, indices, v_bar
    if transpose:
        w_bar = v[:, None] * ct[indices]
    else:
        w_bar = ct[:, None] * v[indices]
    w_shape = (weights.aval.shape if ad.is_undefined_primal(weights)
               else weights.shape)
    if w_shape == (1,):
        w_bar = jnp.sum(w_bar).reshape(1)
    return w_bar, indices, v


def _fcnmv_batching(args, axes, **params):
    weights, indices, v = args
    wa, ia, va = axes
    if wa is None and ia is None and va is not None and v.ndim == 2:
        V = jnp.moveaxis(v, va, 1)
        out = fcnmm_p_call(weights, indices, V, shape=params['shape'],
                           transpose=params['transpose'],
                           backend=params.get('backend'))
        return out, [1]
    return general_batching_rule(fcnmv_p, args, axes, **params)


fcnmv_p = XLACustomKernel(
    'fcnmv',
    doc='Float ELL matvec (reference brainevent/_fcn/float.py:33).',
)
fcnmv_p.def_jax_kernel(_fcnmv_jax_kernel, asdefault=True)
fcnmv_p.def_jvp_rule2(_fcnmv_jvp_weights, None, _fcnmv_jvp_v)
fcnmv_p.def_transpose_rule(_fcnmv_transpose_rule)
fcnmv_p.def_batching_rule(_fcnmv_batching)
fcnmv_p.def_tags('fcn', 'float', 'mv')


def fcnmv_p_call(weights, indices, v, *, shape, transpose: bool = False,
                 backend: Optional[str] = None):
    """Low-level float ELL matvec; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    out_len = check_fixed_conn_num_shape(
        indices.shape, v.shape[0], shape, transpose)
    return fcnmv_p(
        weights, indices, v,
        outs=[jax.ShapeDtypeStruct((out_len,), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


fcnmv_p.def_call(fcnmv_p_call)


@namescope(name='fcnmv', static_argnames=('shape', 'transpose', 'backend'))
def fcnmv(weights, indices, v, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float ELL matvec ``W @ v`` / ``W.T @ v`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weights)
    v, v_unit = split_mantissa_unit(v)
    (out,) = fcnmv_p_call(w, indices, v, shape=shape, transpose=transpose,
                          backend=backend)
    return maybe_unit(out, w_unit, v_unit)


# =============================================================================
# mm
# =============================================================================

def _fcnmm_jax_kernel(*, shape, transpose, **params):
    n_pre, n_post = shape
    out_dtype = params['outs'][0].dtype

    def kernel(weights, indices, B):
        homo = weights.size == 1
        Bc = B.astype(out_dtype)
        n_batch = B.shape[1]
        if transpose:
            if homo:
                vals = weights[0] * jnp.broadcast_to(
                    Bc[:, None, :], indices.shape + (n_batch,))
            else:
                vals = weights[:, :, None] * Bc[:, None, :]
            out = jnp.zeros((n_post, n_batch), dtype=out_dtype)
            return (out.at[indices.reshape(-1)].add(
                vals.reshape(-1, n_batch), mode='drop'),)
        taken = Bc[indices]                      # (n_pre, n_conn, batch)
        if homo:
            return (weights[0] * jnp.sum(taken, axis=1),)
        return (jnp.sum(weights[:, :, None] * taken, axis=1),)

    return kernel


def _fcnmm_jvp_weights(w_dot, weights, indices, B, **params):
    return fcnmm_p_call(w_dot, indices, B, shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _fcnmm_jvp_B(B_dot, weights, indices, B, **params):
    return fcnmm_p_call(weights, indices, B_dot, shape=params['shape'],
                        transpose=params['transpose'],
                        backend=params.get('backend'))


def _fcnmm_transpose_rule(ct, weights, indices, B, **params):
    shape = params['shape']
    transpose = params['transpose']
    ct = ct[0]
    if ad.is_undefined_primal(B):
        B_bar = fcnmm_p_call(weights, indices, ct, shape=shape,
                             transpose=not transpose,
                             backend=params.get('backend'))[0]
        return weights, indices, B_bar
    if transpose:
        w_bar = jnp.einsum('ib,ikb->ik', B, ct[indices])
    else:
        w_bar = jnp.einsum('ib,ikb->ik', ct, B[indices])
    w_shape = (weights.aval.shape if ad.is_undefined_primal(weights)
               else weights.shape)
    if w_shape == (1,):
        w_bar = jnp.sum(w_bar).reshape(1)
    return w_bar, indices, B


fcnmm_p = XLACustomKernel(
    'fcnmm',
    doc='Float ELL matmat (reference brainevent/_fcn/float.py:136).',
)
fcnmm_p.def_jax_kernel(_fcnmm_jax_kernel, asdefault=True)
fcnmm_p.def_jvp_rule2(_fcnmm_jvp_weights, None, _fcnmm_jvp_B)
fcnmm_p.def_transpose_rule(_fcnmm_transpose_rule)
fcnmm_p.def_general_batching()
fcnmm_p.def_tags('fcn', 'float', 'mm')


def fcnmm_p_call(weights, indices, B, *, shape, transpose: bool = False,
                 backend: Optional[str] = None):
    """Low-level float ELL matmat; returns a one-element list."""
    weights = jnp.atleast_1d(jnp.asarray(weights))
    assert B.ndim == 2
    out_len = check_fixed_conn_num_shape(
        indices.shape, B.shape[0], shape, transpose)
    return fcnmm_p(
        weights, indices, B,
        outs=[jax.ShapeDtypeStruct((out_len, B.shape[1]), weights.dtype)],
        shape=tuple(shape), transpose=bool(transpose), backend=backend,
        weight_info=jax.ShapeDtypeStruct(weights.shape, weights.dtype),
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


fcnmm_p.def_call(fcnmm_p_call)


@namescope(name='fcnmm', static_argnames=('shape', 'transpose', 'backend'))
def fcnmm(weights, indices, B, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float ELL matmat (unit-aware)."""
    w, w_unit = split_mantissa_unit(weights)
    B, b_unit = split_mantissa_unit(B)
    (out,) = fcnmm_p_call(w, indices, B, shape=shape, transpose=transpose,
                          backend=backend)
    return maybe_unit(out, w_unit, b_unit)


# =============================================================================
# dt2t: per-connection broadcast
# =============================================================================

@namescope(name='fcnmv_dt2t', static_argnames=('shape', 'transpose', 'backend'))
def fcnmv_dt2t(y, weights, indices, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """Per-connection broadcast: ``out[i,k] = w[i,k] * y[i]`` (non-transposed)
    or ``w[i,k] * y[indices[i,k]]`` (transposed); unit-aware
    (reference ``brainevent/_fcn/dt2t.py:33``)."""
    del backend
    y, y_unit = split_mantissa_unit(y)
    w, w_unit = split_mantissa_unit(weights)
    w = jnp.atleast_1d(jnp.asarray(w))
    if transpose:
        src = y[indices]
    else:
        src = jnp.broadcast_to(y[:, None], indices.shape)
    w_full = w[0] if w.shape[0] == 1 else w
    return maybe_unit(w_full * src, y_unit, w_unit)


@namescope(name='fcnmm_dt2t', static_argnames=('shape', 'transpose', 'backend'))
def fcnmm_dt2t(Y, weights, indices, *, shape, transpose: bool = False,
               backend: Optional[str] = None):
    """Batched per-connection broadcast over ``(n_units, n_batch)`` traces
    (reference ``brainevent/_fcn/dt2t.py:179``)."""
    del backend
    Y, y_unit = split_mantissa_unit(Y)
    w, w_unit = split_mantissa_unit(weights)
    w = jnp.atleast_1d(jnp.asarray(w))
    if transpose:
        src = Y[indices]                           # (n_pre, n_conn, batch)
    else:
        src = jnp.broadcast_to(Y[:, None, :], indices.shape + (Y.shape[1],))
    w_full = w[0] if w.shape[0] == 1 else w[:, :, None]
    return maybe_unit(w_full * src, y_unit, w_unit)
