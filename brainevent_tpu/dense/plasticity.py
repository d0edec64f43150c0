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

"""Dense STDP weight updates (reference ``brainevent/_dense/plasticity_binary.py``).

``update_dense_on_binary_pre``:  ``W[i, :] += post_trace`` for spiking pre ``i``.
``update_dense_on_binary_post``: ``W[:, j] += pre_trace`` for spiking post ``j``.
Both optionally clip to ``[w_min, w_max]``.

These are rank-1 outer-product updates — elementwise work that XLA fuses
into a single pass over ``W``.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..units import maybe_unit, split_mantissa_unit

__all__ = [
    'update_dense_on_binary_pre', 'update_dense_on_binary_pre_p',
    'update_dense_on_binary_post', 'update_dense_on_binary_post_p',
]


def _spike_gate(spike, dtype):
    """Event gate as a {0,1} multiplier of the weight dtype."""
    if spike.dtype == jnp.bool_:
        return spike.astype(dtype)
    return (spike != 0).astype(dtype)


def _on_pre_jax_kernel(**params):
    def kernel(weight, spike, trace):
        return [weight + jnp.outer(_spike_gate(spike, weight.dtype), trace)]
    return kernel


def _on_post_jax_kernel(**params):
    def kernel(weight, trace, spike):
        return [weight + jnp.outer(trace, _spike_gate(spike, weight.dtype))]
    return kernel


update_dense_on_binary_pre_p = XLACustomKernel(
    'update_dense_on_binary_pre',
    doc='Pre-spike-driven dense STDP update '
        '(reference brainevent/_dense/plasticity_binary.py:42).',
)
update_dense_on_binary_pre_p.def_jax_kernel(_on_pre_jax_kernel, asdefault=True)
update_dense_on_binary_pre_p.def_general_batching()


def _plasticity_jvp_weight(w_dot, *primals, **kw):
    # reference contract (brainevent/_dense/plasticity_binary.py:351): the trace addition is treated as a
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
update_dense_on_binary_pre_p.def_jvp_rule2(_plasticity_jvp_weight, None, None)
update_dense_on_binary_pre_p.def_transpose_rule(_plasticity_transpose)
update_dense_on_binary_pre_p.def_tags('dense', 'binary', 'plasticity')

update_dense_on_binary_post_p = XLACustomKernel(
    'update_dense_on_binary_post',
    doc='Post-spike-driven dense STDP update '
        '(reference brainevent/_dense/plasticity_binary.py:360).',
)
update_dense_on_binary_post_p.def_jax_kernel(_on_post_jax_kernel, asdefault=True)
update_dense_on_binary_post_p.def_general_batching()
update_dense_on_binary_post_p.def_jvp_rule2(_plasticity_jvp_weight, None, None)
update_dense_on_binary_post_p.def_transpose_rule(_plasticity_transpose)
update_dense_on_binary_post_p.def_tags('dense', 'binary', 'plasticity')


def _clip(out, w_min, w_max):
    if w_min is not None or w_max is not None:
        out = jnp.clip(out, w_min, w_max)
    return out


@namescope(name='update_dense_on_binary_pre', static_argnames=('backend',))
def update_dense_on_binary_pre(weight, pre_spike, post_trace,
                               w_min=None, w_max=None, *,
                               backend: Optional[str] = None):
    """``W[i, :] += post_trace`` for every spiking presynaptic ``i``,
    clipped to ``[w_min, w_max]`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(post_trace)
    assert w.ndim == 2 and pre_spike.ndim == 1 and t.ndim == 1
    assert w.shape[0] == pre_spike.shape[0] and w.shape[1] == t.shape[0]
    (out,) = update_dense_on_binary_pre_p(
        w, pre_spike, jnp.asarray(t, dtype=w.dtype),
        outs=[jax.ShapeDtypeStruct(w.shape, w.dtype)],
        backend=backend,
    )
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)


update_dense_on_binary_pre_p.def_call(
    lambda w, s, t, backend=None: update_dense_on_binary_pre(w, s, t, backend=backend))


@namescope(name='update_dense_on_binary_post', static_argnames=('backend',))
def update_dense_on_binary_post(weight, pre_trace, post_spike,
                                w_min=None, w_max=None, *,
                                backend: Optional[str] = None):
    """``W[:, j] += pre_trace`` for every spiking postsynaptic ``j``,
    clipped to ``[w_min, w_max]`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(pre_trace)
    assert w.ndim == 2 and post_spike.ndim == 1 and t.ndim == 1
    assert w.shape[1] == post_spike.shape[0] and w.shape[0] == t.shape[0]
    (out,) = update_dense_on_binary_post_p(
        w, jnp.asarray(t, dtype=w.dtype), post_spike,
        outs=[jax.ShapeDtypeStruct(w.shape, w.dtype)],
        backend=backend,
    )
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)


update_dense_on_binary_post_p.def_call(
    lambda w, t, s, backend=None: update_dense_on_binary_post(w, t, s, backend=backend))
