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

"""Leaky integrate-and-fire neurons (functional, jit-first).

The reference delegates neuron dynamics to the brainpy/brainstate stack
(``/root/reference/examples/CUBA_2005.py``); brainevent-tpu ships a
self-contained functional implementation so the acceptance workloads (CUBA/
COBA EI networks) run stand-alone. All state lives in explicit pytrees;
every update is a pure function suitable for ``lax.fori_loop``.

Units convention (brainunit optional): voltages in mV, times in ms,
conductances in mS, currents in mA.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ['LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
           'surrogate_spike']


@dataclasses.dataclass(frozen=True)
class LIFRefParams:
    """Leaky integrate-and-fire with refractory period.

    Matches the parameterization of the reference examples
    (``examples/COBA_2005.py:42-49``): ``tau dV/dt = (V_rest - V) + R*I``,
    spike at ``V >= V_th``, reset to ``V_reset``, absolute refractory
    ``tau_ref``.
    """
    v_rest: float = -60.0      # mV
    v_th: float = -50.0        # mV
    v_reset: float = -60.0     # mV
    tau: float = 20.0          # ms
    tau_ref: float = 5.0       # ms
    r: float = 1.0             # membrane resistance


class LIFRefState(NamedTuple):
    """Neuron state: membrane potential and time of last spike."""
    v: jax.Array           # (n,) mV
    t_last: jax.Array      # (n,) ms; -inf-ish before any spike


def lifref_init(key, n: int, params: LIFRefParams,
                v_mean: float = -55.0, v_std: float = 2.0,
                dtype=jnp.float32) -> LIFRefState:
    """Initialize membrane potentials ~ N(v_mean, v_std) (reference
    ``V_initializer=Normal(-55., 2.)``)."""
    v = v_mean + v_std * jax.random.normal(key, (n,), dtype=dtype)
    t_last = jnp.full((n,), -1e7, dtype=dtype)
    return LIFRefState(v=v, t_last=t_last)


def lifref_step(state: LIFRefState, current: jax.Array, t: float, dt: float,
                params: LIFRefParams):
    """One Euler step; returns ``(new_state, spikes)``.

    Neurons in their refractory window hold at ``v_reset``; spikes are the
    boolean threshold crossings of this step.
    """
    p = params
    refractory = (t - state.t_last) < p.tau_ref
    dv = (p.v_rest - state.v + p.r * current) * (dt / p.tau)
    v = jnp.where(refractory, state.v, state.v + dv)
    spike = v >= p.v_th
    v = jnp.where(spike, p.v_reset, v)
    t_last = jnp.where(spike, t, state.t_last)
    return LIFRefState(v=v, t_last=t_last), spike


@jax.custom_jvp
def surrogate_spike(v_minus_th: jax.Array) -> jax.Array:
    """Heaviside spike with a sigmoid surrogate gradient.

    Forward: ``1.0`` where the membrane crosses threshold. Backward: the
    derivative of a steep sigmoid — the standard trick that makes SNNs
    trainable end-to-end with ``jax.grad``.
    """
    return (v_minus_th >= 0).astype(v_minus_th.dtype)


@surrogate_spike.defjvp
def _surrogate_spike_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = (x >= 0).astype(x.dtype)
    alpha = 4.0
    sg = jax.nn.sigmoid(alpha * x)
    dy = alpha * sg * (1 - sg) * dx
    return y, dy
