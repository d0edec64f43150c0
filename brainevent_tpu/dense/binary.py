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

"""Event-driven dense matrix x spike products
(reference ``brainevent/_dense/binary.py``).

Semantics
---------
``binary_densemv(W, s, transpose)``:
  ``transpose=False`` -> ``W[m,k] @ s[k] -> y[m]``;
  ``transpose=True``  -> ``W[k,m].T @ s[k] -> y[m]`` (i.e. ``s @ W``).
``binary_densemm(W, S, transpose)``:
  ``transpose=False`` -> ``W[m,k] @ S[k,n]``;
  ``transpose=True``  -> ``W[k,m].T @ S[k,n]``.

Boolean events gate on truth; float events gate at ``> 0`` — either way an
active event contributes the bare weight (values never scale it), matching
the reference contract (``brainevent/_dense/binary.py:141-142``). AD
treats the spike operand linearly (the reference's surrogate convention).

Design: the ``jax_raw`` backend IS the event kernel here — a dense
matvec/matmul is bandwidth-bound on the weights, which every event-driven
formulation must read anyway, and XLA hands the masked product to cuBLAS.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .._compat import ad
from .._misc import namescope
from ..ops.core import XLACustomKernel
from ..ops.util import general_batching_rule
from ..ops.benchmark import BenchmarkConfig
from ..units import maybe_unit, split_mantissa_unit

__all__ = [
    'binary_densemv', 'binary_densemv_p', 'binary_densemv_p_call',
    'binary_densemm', 'binary_densemm_p', 'binary_densemm_p_call',
]


def _as_weight_dtype(spikes, dtype):
    """0/1 gate in the weight dtype. Bool spikes gate on truth; float
    spikes gate at ``> 0`` — the reference's event contract for the dense
    family (``brainevent/_dense/binary.py:141-142``: values do NOT scale
    the weights)."""
    if spikes.dtype == jnp.bool_:
        return spikes.astype(dtype)
    return (spikes > 0).astype(dtype)


# =============================================================================
# mv
# =============================================================================

def _densemv_jax_kernel(*, transpose, **params):
    def kernel(weights, spikes):
        s = _as_weight_dtype(spikes, weights.dtype)
        return (s @ weights,) if transpose else (weights @ s,)
    return kernel


def _densemv_jvp_weights(w_dot, weights, spikes, *, transpose, **params):
    return binary_densemv_p_call(w_dot, spikes, transpose=transpose,
                                 backend=params.get('backend'))


def _densemv_jvp_spikes(s_dot, weights, spikes, *, transpose, **params):
    return [s_dot @ weights] if transpose else [weights @ s_dot]


def _densemv_transpose_rule(ct, weights, spikes, *, transpose, **params):
    ct = ct[0]
    if ad.is_undefined_primal(spikes):
        s_bar = weights @ ct if transpose else weights.T @ ct
        return weights, s_bar
    w_bar = (jnp.outer(_as_weight_dtype(spikes, ct.dtype), ct)
             if transpose else
             jnp.outer(ct, _as_weight_dtype(spikes, ct.dtype)))
    return w_bar, spikes


def _densemv_batching(args, axes, **params):
    weights, spikes = args
    wa, sa = axes
    if wa is None and sa is not None:
        spikes = jnp.moveaxis(spikes, sa, 1)  # (k, batch)
        out = binary_densemm_p_call(weights, spikes,
                                    transpose=params['transpose'],
                                    backend=params.get('backend'))
        return out, [1]
    return general_batching_rule(binary_densemv_p, args, axes, **params)


binary_densemv_p = XLACustomKernel(
    'binary_densemv',
    doc='Event-driven dense matrix x spike-vector product '
        '(reference brainevent/_dense/binary.py:79).',
)
binary_densemv_p.def_jax_kernel(_densemv_jax_kernel, asdefault=True)
binary_densemv_p.def_jvp_rule2(_densemv_jvp_weights, _densemv_jvp_spikes)
binary_densemv_p.def_transpose_rule(_densemv_transpose_rule)
binary_densemv_p.def_batching_rule(_densemv_batching)
binary_densemv_p.def_tags('dense', 'binary', 'mv')


def binary_densemv_p_call(weights, spikes, *, transpose, backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    assert weights.ndim == 2, f'weights must be 2D, got {weights.ndim}D'
    assert spikes.ndim == 1, f'spikes must be 1D, got {spikes.ndim}D'
    if transpose:
        assert spikes.shape[0] == weights.shape[0], (
            f'spikes length {spikes.shape[0]} != weights.shape[0] {weights.shape[0]}')
        out_len = weights.shape[1]
    else:
        assert spikes.shape[0] == weights.shape[1], (
            f'spikes length {spikes.shape[0]} != weights.shape[1] {weights.shape[1]}')
        out_len = weights.shape[0]
    return binary_densemv_p(
        weights, spikes,
        outs=[jax.ShapeDtypeStruct((out_len,), weights.dtype)],
        transpose=transpose,
        backend=backend,
    )


binary_densemv_p.def_call(binary_densemv_p_call)


@namescope(name='binary_densemv', static_argnames=('transpose', 'backend'))
def binary_densemv(weights, spikes, *, transpose, backend: Optional[str] = None):
    """Event-driven dense matvec ``W @ s`` / ``W.T @ s``.

    Unit-aware wrapper over :data:`binary_densemv_p`.
    """
    w, w_unit = split_mantissa_unit(weights)
    s, s_unit = split_mantissa_unit(spikes)
    (out,) = binary_densemv_p_call(w, s, transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, s_unit)


def _densemv_benchmark_data(*, platform):
    import numpy as np
    configs = []
    for n, rate in ((1000, 0.01), (1000, 0.1), (10000, 0.01)):
        w = jnp.asarray(np.random.randn(n, n), dtype=jnp.float32)
        s = jnp.asarray(np.random.rand(n) < rate)
        for transpose in (False, True):
            configs.append(BenchmarkConfig(
                f'n={n},rate={rate},{"T" if transpose else "NT"}',
                (w, s), {'transpose': transpose}))
    return configs


binary_densemv_p.def_benchmark_data(_densemv_benchmark_data)


# =============================================================================
# mm
# =============================================================================

def _densemm_jax_kernel(*, transpose, **params):
    def kernel(weights, spikes):
        s = _as_weight_dtype(spikes, weights.dtype)
        return (weights.T @ s,) if transpose else (weights @ s,)
    return kernel


def _densemm_jvp_weights(w_dot, weights, spikes, *, transpose, **params):
    return binary_densemm_p_call(w_dot, spikes, transpose=transpose,
                                 backend=params.get('backend'))


def _densemm_jvp_spikes(s_dot, weights, spikes, *, transpose, **params):
    return [weights.T @ s_dot] if transpose else [weights @ s_dot]


def _densemm_transpose_rule(ct, weights, spikes, *, transpose, **params):
    ct = ct[0]
    if ad.is_undefined_primal(spikes):
        s_bar = weights @ ct if transpose else weights.T @ ct
        return weights, s_bar
    s = _as_weight_dtype(spikes, ct.dtype)
    w_bar = (s @ ct.T) if transpose else (ct @ s.T)
    return w_bar, spikes


def _densemm_batching(args, axes, **params):
    return general_batching_rule(binary_densemm_p, args, axes, **params)


binary_densemm_p = XLACustomKernel(
    'binary_densemm',
    doc='Event-driven dense matrix x spike-matrix product '
        '(reference brainevent/_dense/binary.py:487).',
)
binary_densemm_p.def_jax_kernel(_densemm_jax_kernel, asdefault=True)
binary_densemm_p.def_jvp_rule2(_densemm_jvp_weights, _densemm_jvp_spikes)
binary_densemm_p.def_transpose_rule(_densemm_transpose_rule)
binary_densemm_p.def_batching_rule(_densemm_batching)
binary_densemm_p.def_tags('dense', 'binary', 'mm')


def binary_densemm_p_call(weights, spikes, *, transpose, backend: Optional[str] = None):
    """Low-level primitive call; returns a one-element list."""
    assert weights.ndim == 2 and spikes.ndim == 2
    k = spikes.shape[0]
    if transpose:
        assert weights.shape[0] == k, (
            f'weights.shape[0] {weights.shape[0]} != spikes.shape[0] {k}')
        out_shape = (weights.shape[1], spikes.shape[1])
    else:
        assert weights.shape[1] == k, (
            f'weights.shape[1] {weights.shape[1]} != spikes.shape[0] {k}')
        out_shape = (weights.shape[0], spikes.shape[1])
    return binary_densemm_p(
        weights, spikes,
        outs=[jax.ShapeDtypeStruct(out_shape, weights.dtype)],
        transpose=transpose,
        backend=backend,
    )


binary_densemm_p.def_call(binary_densemm_p_call)


@namescope(name='binary_densemm', static_argnames=('transpose', 'backend'))
def binary_densemm(weights, spikes, *, transpose, backend: Optional[str] = None):
    """Event-driven dense matmul ``W @ S`` / ``W.T @ S`` (unit-aware)."""
    w, w_unit = split_mantissa_unit(weights)
    s, s_unit = split_mantissa_unit(spikes)
    (out,) = binary_densemm_p_call(w, s, transpose=transpose, backend=backend)
    return maybe_unit(out, w_unit, s_unit)


def _densemm_benchmark_data(*, platform):
    import numpy as np
    configs = []
    for n, nb, rate in ((1000, 32, 0.01), (1000, 32, 0.1)):
        w = jnp.asarray(np.random.randn(n, n), dtype=jnp.float32)
        s = jnp.asarray(np.random.rand(n, nb) < rate)
        for transpose in (False, True):
            name = f'n={n},rate={rate},{"T" if transpose else "NT"}'
            configs.append(BenchmarkConfig(
                name, (w, s), {'transpose': transpose}))
    return configs


binary_densemm_p.def_benchmark_data(_densemm_benchmark_data)
