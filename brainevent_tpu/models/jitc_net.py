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

"""EI LIF network over implicit (JITC) connectivity.

The "80k-neuron net on JITCNormalR/JITCUniformR" acceptance workload
(BASELINE.json): the same EI dynamics as :class:`~.networks.EINet`, but
the connectivity is never stored — both projections are
:class:`~brainevent_tpu.jitc` generative matrices whose weights and
structure are regenerated from the seed inside every product (reference
``brainevent/_jit_normal/main.py``; the examples' EventJitFixedProb
usage). Weight memory is O(1) regardless of network size.

Design: each projection holds a :class:`JITCWalkPlan` built once at
construction (the stationary-q stream setup), and spike propagation runs
the event-compacted scatter route (``jitc/event_route.py``): only the
spiking rows' plan streams walk, candidates are scatter-added, and a
``lax.cond`` fallback keeps every step exact under bursts.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..events.binary import BinaryArray
from ..jitc import JITCNormalR, JITCScalarR, JITCUniformR
from .neurons import LIFRefParams, LIFRefState, lifref_init, lifref_step

__all__ = ['JITCNet', 'JITCNetState']


class JITCNetState(NamedTuple):
    neurons: LIFRefState
    g_e: jax.Array          # excitatory synaptic drive, (n,)
    g_i: jax.Array          # inhibitory synaptic drive, (n,)
    spike_count: jax.Array  # per-neuron cumulative spikes


_WEIGHT_CLASSES = {
    'normal': JITCNormalR,
    'uniform': JITCUniformR,
    'scalar': JITCScalarR,
}


@dataclasses.dataclass
class JITCNet:
    """EI network with just-in-time regenerated connectivity.

    Parameters
    ----------
    scale : float
        ``n = 4000 * scale`` neurons (80% excitatory / 20% inhibitory);
        ~``n_conn`` incoming synapses per neuron from each population's
        fixed-probability implicit matrix.
    weight_law : {'normal', 'uniform', 'scalar'}
        Weight family: per-edge ``Normal(w, 0.1 w)``, per-edge
        ``Uniform(0.8 w, 1.2 w)``, or the homogeneous ``w`` of the
        reference examples.
    coba : bool
        Conductance-based (COBA) vs current-based (CUBA) synapses.
    """
    scale: float = 1.0
    weight_law: str = 'normal'
    coba: bool = True
    dt: float = 0.1          # ms
    n_conn: int = 80         # expected in-degree per projection pair
    w_e: float = 0.6
    w_i: float = 6.7
    tau_e: float = 5.0       # ms
    tau_i: float = 10.0      # ms
    e_e: float = 0.0         # mV
    e_i: float = -80.0       # mV
    seed: int = 42
    # static active-spike capacity per projection = n_pre / cap_divisor
    # (biological regimes fire ~0.2-0.5% of neurons per dt; the exact
    # lax.cond fallback makes a tight capacity safe — bursts only cost
    # a slower step). Candidate-array size, and so step time, scales
    # linearly with the capacity.
    cap_divisor: int = 128

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.params = LIFRefParams()
        key = jax.random.PRNGKey(self.seed)
        (self._init_key,) = jax.random.split(key, 1)
        if self.weight_law not in _WEIGHT_CLASSES:
            raise ValueError(
                f"weight_law must be one of {sorted(_WEIGHT_CLASSES)}, "
                f"got {self.weight_law!r}")
        cls = _WEIGHT_CLASSES[self.weight_law]
        prob = min(1.0, self.n_conn / self.num)

        def make(n_pre, w, seed):
            if self.weight_law == 'normal':
                data = (w, 0.1 * w, prob, seed)
            elif self.weight_law == 'uniform':
                data = (0.8 * w, 1.2 * w, prob, seed)
            else:
                data = (w, prob, seed)
            # corder=True so the pre->post product (spk @ M) walks the
            # presynaptic axis — the direction the event-compacted
            # scatter route accelerates
            return cls(data, shape=(n_pre, self.num), corder=True)

        self.conn_e = make(self.n_exc, self.w_e, self.seed)
        self.conn_i = make(self.n_inh, self.w_i, self.seed + 1)
        # walk plans: the stream setup is computed exactly once here
        self.plan_e = self.conn_e.build_walk_plan()
        self.plan_i = self.conn_i.build_walk_plan()
        self.plan_e.event_cap = max(128, self.n_exc // self.cap_divisor)
        self.plan_i.event_cap = max(128, self.n_inh // self.cap_divisor)

    # -- state -------------------------------------------------------------

    def init_state(self, key: Optional[jax.Array] = None) -> JITCNetState:
        key = self._init_key if key is None else key
        neurons = lifref_init(key, self.num, self.params)
        zeros = jnp.zeros(self.num, jnp.float32)
        return JITCNetState(neurons=neurons, g_e=zeros, g_i=zeros,
                            spike_count=jnp.zeros(self.num, jnp.int32))

    # -- dynamics ----------------------------------------------------------

    def _propagate(self, spike: jax.Array):
        """This step's spikes -> synaptic increments, through the implicit
        matrices (event-compacted plan products; exact)."""
        spk_e = BinaryArray(spike[:self.n_exc])
        spk_i = BinaryArray(spike[self.n_exc:])
        inc_e = spk_e @ self.plan_e
        inc_i = spk_i @ self.plan_i
        return inc_e, inc_i

    def step(self, state: JITCNetState, t: jax.Array,
             inp: float = 20.0) -> JITCNetState:
        """One dt step (the reference examples' ``spk = N(inp); E(spk);
        I(spk)`` order — propagate the crossings returned by the LIF
        update, before the reset erases them)."""
        p = self.params
        g_e = state.g_e * jnp.float32(math.exp(-self.dt / self.tau_e))
        g_i = state.g_i * jnp.float32(math.exp(-self.dt / self.tau_i))

        if self.coba:
            current = (g_e * (self.e_e - state.neurons.v)
                       + g_i * (self.e_i - state.neurons.v) + inp)
        else:
            current = g_e - g_i + inp

        neurons, spike = lifref_step(state.neurons, current, t, self.dt, p)
        inc_e, inc_i = self._propagate(spike)
        return JITCNetState(
            neurons=neurons, g_e=g_e + inc_e, g_i=g_i + inc_i,
            spike_count=state.spike_count + spike.astype(jnp.int32))

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[JITCNetState] = None) -> JITCNetState:
        """Run ``n_steps`` under one ``lax.fori_loop`` (jit this)."""
        if state is None:
            state = self.init_state()

        def body(i, s):
            return self.step(s, i * self.dt, inp)

        return jax.lax.fori_loop(0, n_steps, body, state)

    def firing_rate_hz(self, state: JITCNetState, n_steps: int) -> jax.Array:
        t_sec = n_steps * self.dt * 1e-3
        return state.spike_count.mean() / t_sec
