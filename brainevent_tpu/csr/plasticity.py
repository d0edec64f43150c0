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

"""CSR STDP weight updates (reference ``brainevent/_csr/plasticity_binary.py``;
semantics preserved, one XLA formulation per direction).

``update_csr_on_binary_pre``:
    ``w[indptr[i]:indptr[i+1]] += post_trace[indices[...]]`` for spiking pre
    ``i``, i.e. per-nse: ``w[j] += gate(pre_spike[row(j)]) * post_trace[col(j)]``.
``update_csr_on_binary_post``:
    per-nse: ``w[j] += pre_trace[row(j)] * gate(post_spike[col(j)])``; the
    ``weight_indices`` permutation argument of the reference (CSC-driven CUDA
    iteration) is accepted and unused by the gather formulation.

Both clip to ``[w_min, w_max]`` when given.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..ops.benchmark import BenchmarkConfig
from ..units import maybe_unit, split_mantissa_unit
from ._common import event_gate, row_ids_from_indptr

__all__ = [
    'update_csr_on_binary_pre', 'update_csr_on_binary_pre_p',
    'update_csr_on_binary_post', 'update_csr_on_binary_post_p',
    'update_csc_on_binary_pre', 'update_csc_on_binary_post',
]


def _on_pre_jax_kernel(*, shape, **params):
    nse = params['indices_info'].shape[0]

    def kernel(weight, indices, indptr, pre_spike, post_trace):
        rows = row_ids_from_indptr(indptr, nse)
        gate = event_gate(pre_spike, weight.dtype)
        return (weight + gate[rows] * post_trace[indices].astype(weight.dtype),)

    return kernel


update_csr_on_binary_pre_p = XLACustomKernel(
    'update_csr_on_binary_pre',
    doc='Pre-spike-driven CSR STDP update '
        '(reference brainevent/_csr/plasticity_binary.py:45).',
)
update_csr_on_binary_pre_p.def_jax_kernel(_on_pre_jax_kernel, asdefault=True)
update_csr_on_binary_pre_p.def_general_batching()


def _plasticity_jvp_weight(w_dot, *primals, **kw):
    # reference contract (brainevent/_csr/plasticity_binary.py): the trace addition is treated as a
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
update_csr_on_binary_pre_p.def_jvp_rule2(_plasticity_jvp_weight, None, None, None, None)
update_csr_on_binary_pre_p.def_transpose_rule(_plasticity_transpose)
update_csr_on_binary_pre_p.def_tags('csr', 'binary', 'plasticity')


def csr_on_pre_prim_call(weight, indices, indptr, pre_spike, post_trace, *,
                         shape, backend: Optional[str] = None):
    """Low-level on-pre plasticity call; returns ``[new_weight]``."""
    weight = jnp.atleast_1d(jnp.asarray(weight))
    if weight.shape[0] == 1:
        weight = jnp.broadcast_to(weight, indices.shape)
    return update_csr_on_binary_pre_p(
        weight, indices, indptr, pre_spike, post_trace,
        outs=[jax.ShapeDtypeStruct(weight.shape, weight.dtype)],
        shape=tuple(shape), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


update_csr_on_binary_pre_p.def_call(csr_on_pre_prim_call)


def _clip(out, w_min, w_max):
    if w_min is not None or w_max is not None:
        out = jnp.clip(out, w_min, w_max)
    return out


@namescope(name='update_csr_on_binary_pre',
           static_argnames=('shape', 'backend'))
def update_csr_on_binary_pre(weight, indices, indptr, pre_spike, post_trace,
                             w_min=None, w_max=None, *, shape,
                             backend: Optional[str] = None):
    """STDP on-pre: add post traces to all outgoing weights of spiking pre
    neurons; clip to ``[w_min, w_max]`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(post_trace)
    (out,) = csr_on_pre_prim_call(w, indices, indptr, pre_spike, t,
                                  shape=shape, backend=backend)
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)


def _on_pre_benchmark_data(*, platform):
    import numpy as np
    rng = np.random.default_rng(0)
    n, conn = 1000, 0.1
    nse = int(n * n * conn)
    indices = jnp.asarray(rng.integers(0, n, nse), dtype=jnp.int32)
    counts = np.full(n, nse // n)
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]), dtype=jnp.int32)
    w = jnp.asarray(rng.normal(size=nse), dtype=jnp.float32)
    trace = jnp.asarray(rng.normal(size=n), dtype=jnp.float32)
    configs = []
    for bool_event in (True, False):
        spk = rng.random(n) < 0.01
        spike = jnp.asarray(spk if bool_event else spk.astype(np.float32))
        configs.append(BenchmarkConfig(
            f'n={n},{"bool" if bool_event else "float"}',
            (w, indices, indptr, spike, trace), {'shape': (n, n)}))
    return configs


update_csr_on_binary_pre_p.def_benchmark_data(_on_pre_benchmark_data)


# =============================================================================
# on-post
# =============================================================================

def _on_post_jax_kernel(*, shape, **params):
    nse = params['indices_info'].shape[0]

    def kernel(weight, indices, indptr, weight_indices, pre_trace, post_spike):
        del weight_indices  # CSC-iteration permutation; unused by gather form
        rows = row_ids_from_indptr(indptr, nse)
        gate = event_gate(post_spike, weight.dtype)
        return (weight + pre_trace[rows].astype(weight.dtype) * gate[indices],)

    return kernel


update_csr_on_binary_post_p = XLACustomKernel(
    'update_csr_on_binary_post',
    doc='Post-spike-driven CSR STDP update '
        '(reference brainevent/_csr/plasticity_binary.py:477).',
)
update_csr_on_binary_post_p.def_jax_kernel(_on_post_jax_kernel, asdefault=True)
update_csr_on_binary_post_p.def_general_batching()
update_csr_on_binary_post_p.def_jvp_rule2(_plasticity_jvp_weight, None, None, None, None, None)
update_csr_on_binary_post_p.def_transpose_rule(_plasticity_transpose)
update_csr_on_binary_post_p.def_tags('csr', 'binary', 'plasticity')


def csr2csc_on_post_prim_call(weight, indices, indptr, weight_indices,
                              pre_trace, post_spike, *, shape,
                              backend: Optional[str] = None):
    """Low-level on-post plasticity call; returns ``[new_weight]``."""
    weight = jnp.atleast_1d(jnp.asarray(weight))
    if weight.shape[0] == 1:
        weight = jnp.broadcast_to(weight, indices.shape)
    if weight_indices is None:
        weight_indices = jnp.arange(indices.shape[0], dtype=jnp.int32)
    return update_csr_on_binary_post_p(
        weight, indices, indptr, weight_indices, pre_trace, post_spike,
        outs=[jax.ShapeDtypeStruct(weight.shape, weight.dtype)],
        shape=tuple(shape), backend=backend,
        indices_info=jax.ShapeDtypeStruct(indices.shape, indices.dtype),
    )


update_csr_on_binary_post_p.def_call(csr2csc_on_post_prim_call)


def _on_post_benchmark_data(*, platform):
    import numpy as np
    rng = np.random.default_rng(0)
    n, conn = 1000, 0.1
    nse = int(n * n * conn)
    indices = jnp.asarray(rng.integers(0, n, nse), dtype=jnp.int32)
    counts = np.full(n, nse // n)
    indptr = jnp.asarray(np.concatenate([[0], np.cumsum(counts)]),
                         dtype=jnp.int32)
    wi = jnp.arange(nse, dtype=jnp.int32)
    w = jnp.asarray(rng.normal(size=nse), dtype=jnp.float32)
    trace = jnp.asarray(rng.normal(size=n), dtype=jnp.float32)
    configs = []
    for bool_event in (True, False):
        spk = rng.random(n) < 0.01
        spike = jnp.asarray(spk if bool_event else spk.astype(np.float32))
        configs.append(BenchmarkConfig(
            f'n={n},{"bool" if bool_event else "float"}',
            (w, indices, indptr, wi, trace, spike), {'shape': (n, n)}))
    return configs


update_csr_on_binary_post_p.def_benchmark_data(_on_post_benchmark_data)


@namescope(name='update_csr_on_binary_post',
           static_argnames=('shape', 'backend'))
def update_csr_on_binary_post(weight, indices, indptr, weight_indices,
                              pre_trace, post_spike,
                              w_min=None, w_max=None, *, shape,
                              backend: Optional[str] = None):
    """STDP on-post: add pre traces to all incoming weights of spiking post
    neurons; clip to ``[w_min, w_max]`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weight)
    t, _ = split_mantissa_unit(pre_trace)
    (out,) = csr2csc_on_post_prim_call(
        w, indices, indptr, weight_indices, t, post_spike,
        shape=shape, backend=backend)
    w_min, _ = split_mantissa_unit(w_min) if w_min is not None else (None, None)
    w_max, _ = split_mantissa_unit(w_max) if w_max is not None else (None, None)
    return maybe_unit(_clip(out, w_min, w_max), w_unit)


# =============================================================================
# CSC entry points: CSC storage of A == CSR storage of A.T, so pre/post swap.
# (reference brainevent/_csr/plasticity_binary.py:968,1066)
# =============================================================================

def update_csc_on_binary_pre(weight, indices, indptr, pre_spike, post_trace,
                             w_min=None, w_max=None, *, shape,
                             backend: Optional[str] = None):
    """On-pre update for CSC-stored weights: columns of the CSC structure are
    presynaptic rows of the logical matrix."""
    m, k = shape
    return update_csr_on_binary_post(
        weight, indices, indptr, None, post_trace, pre_spike,
        w_min, w_max, shape=(k, m), backend=backend)


def update_csc_on_binary_post(weight, indices, indptr, pre_trace, post_spike,
                              w_min=None, w_max=None, *, shape,
                              backend: Optional[str] = None):
    """On-post update for CSC-stored weights."""
    m, k = shape
    return update_csr_on_binary_pre(
        weight, indices, indptr, post_spike, pre_trace,
        w_min, w_max, shape=(k, m), backend=backend)
