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

"""Fixed-connectivity STDP updates
(reference ``brainevent/_fcn/plasticity_binary.py``).

One row-driven primitive serves both directions:
``data[i, k] += gate(spike[i]) * trace[indices[i, k]]``.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..units import maybe_unit, split_mantissa_unit

__all__ = [
    'fcn_plasticity_row_p', 'fcn_plasticity_row_prim_call',
    'update_fixed_post_conn_on_binary_pre',
    'update_fixed_pre_conn_on_binary_post',
]


def _row_plasticity_jax_kernel(**params):
    def kernel(data, indices, spike, trace):
        gate = (spike.astype(data.dtype) if spike.dtype == jnp.bool_
                else (spike > 0).astype(data.dtype))
        return (data + gate[:, None] * trace[indices].astype(data.dtype),)
    return kernel


fcn_plasticity_row_p = XLACustomKernel(
    'fcn_plasticity_row',
    doc='Row-driven ELL STDP update: data[i,k] += gate(spike[i]) * '
        'trace[indices[i,k]] (reference brainevent/_fcn/plasticity_binary.py:152).',
)
fcn_plasticity_row_p.def_jax_kernel(_row_plasticity_jax_kernel, asdefault=True)
fcn_plasticity_row_p.def_general_batching()


def _plasticity_jvp_weight(w_dot, *primals, **kw):
    # reference contract (brainevent/_fcn/plasticity_binary.py): the trace addition is treated as a
    # constant for AD — d(update)/d(weight) = identity; spike/trace are
    # non-differentiable.
    return [w_dot]


def _plasticity_transpose(ct, *primals, **kw):
    from .._compat import ad as _ad
    if not _ad.is_undefined_primal(primals[0]):
        return (primals[0],) + primals[1:]
    c = ct[0]
    wbar = _ad.Zero(primals[0]) if type(c) is _ad.Zero else c
    return (wbar,) + primals[1:]
fcn_plasticity_row_p.def_jvp_rule2(_plasticity_jvp_weight, None, None, None)
fcn_plasticity_row_p.def_transpose_rule(_plasticity_transpose)
fcn_plasticity_row_p.def_tags('fcn', 'binary', 'plasticity')


def fcn_plasticity_row_prim_call(data, indices, spike, trace, *,
                                 backend: Optional[str] = None):
    """Low-level row-driven plasticity call; returns ``[new_data]``."""
    data = jnp.asarray(data)
    if data.ndim == 1 and data.shape[0] == 1:
        data = jnp.broadcast_to(data[:, None], indices.shape)
    assert data.shape == indices.shape, (
        f'data shape {data.shape} must match indices shape {indices.shape}')
    return fcn_plasticity_row_p(
        data, indices, spike, trace,
        outs=[jax.ShapeDtypeStruct(data.shape, data.dtype)],
        backend=backend,
    )


fcn_plasticity_row_p.def_call(fcn_plasticity_row_prim_call)


def _clip(out, w_min, w_max):
    if w_min is not None or w_max is not None:
        out = jnp.clip(out, w_min, w_max)
    return out


@namescope(name='update_fixed_post_conn_on_binary_pre',
           static_argnames=('backend',))
def update_fixed_post_conn_on_binary_pre(weight, indices, pre_spike,
                                         post_trace, w_min=None, w_max=None,
                                         *, backend: Optional[str] = None):
    """On-pre STDP for pre-grouped (FixedNumPerPre) connectivity:
    ``w[i, k] += post_trace[indices[i, k]]`` for spiking pre ``i``
    (reference ``brainevent/_fcn/plasticity_binary.py:207``)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(post_trace)
    (out,) = fcn_plasticity_row_prim_call(w, indices, pre_spike, t,
                                          backend=backend)
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)


@namescope(name='update_fixed_pre_conn_on_binary_post',
           static_argnames=('backend',))
def update_fixed_pre_conn_on_binary_post(weight, indices, pre_trace,
                                         post_spike, w_min=None, w_max=None,
                                         *, backend: Optional[str] = None):
    """On-post STDP for post-grouped (FixedNumPerPost) connectivity:
    ``w[j, k] += pre_trace[indices[j, k]]`` for spiking post ``j``
    (reference ``brainevent/_fcn/plasticity_binary.py:269``)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(pre_trace)
    (out,) = fcn_plasticity_row_prim_call(w, indices, post_spike, t,
                                          backend=backend)
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)
