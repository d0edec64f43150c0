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

"""EI (excitatory/inhibitory) LIF networks — the acceptance workloads.

Re-implementation of the reference benchmark networks
(``/root/reference/examples/CUBA_2005.py`` — Vogels & Abbott 2005 — and
``COBA_2005.py`` — Brette et al. 2007): 80% excitatory / 20% inhibitory LIF
neurons with event-driven fixed-number random connectivity (~80 synapses per
presynaptic neuron), exponential synapses, current-based (CUBA) or
conductance-based (COBA) coupling, stepped at dt = 0.1 ms.

Design: the whole state is one pytree; a step is a pure function; the
100k-step simulation is a single ``lax.fori_loop`` compiled once, so the
loop stays on the device. Spike propagation compacts this step's spikes
into a static-capacity buffer and scatter-adds their rows of the
connectivity table (:mod:`brainevent_tpu.ops.scatter`).
"""

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..fcn.binary import event_capacity
from ..fcn.main import FixedNumPerPre
from ..ops.scatter import event_scatter_add, event_scatter_add_multi
from .neurons import LIFRefParams, LIFRefState, lifref_init, lifref_step

__all__ = ['EINet', 'EINetState']


class EINetState(NamedTuple):
    neurons: LIFRefState
    g_e: jax.Array          # excitatory synaptic conductance/current, (n,)
    g_i: jax.Array          # inhibitory synaptic conductance/current, (n,)
    spike_count: jax.Array  # per-neuron cumulative spikes (rate monitor)


@dataclasses.dataclass
class EINet:
    """EI network with event-driven fixed-number connectivity.

    Parameters
    ----------
    scale : float
        Network scale; ``n = 4000 * scale`` neurons (3200*scale exc,
        800*scale inh), ~80 outgoing synapses per neuron.
    coba : bool
        Conductance-based (COBA, reference ``COBA_2005.py``) vs
        current-based (CUBA, ``CUBA_2005.py``) synapses.
    """
    scale: float = 1.0
    coba: bool = True
    dt: float = 0.1          # ms
    n_conn: int = 80
    w_e: float = 0.6         # mS (COBA) / mV-equivalent (CUBA)
    w_i: float = 6.7
    tau_e: float = 5.0       # ms
    tau_i: float = 10.0      # ms
    e_e: float = 0.0         # mV (COBA reversal)
    e_i: float = -80.0       # mV
    seed: int = 42

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.params = LIFRefParams()
        key = jax.random.PRNGKey(self.seed)
        k_e, k_i, self._init_key = jax.random.split(key, 3)
        n_conn = min(self.n_conn, self.num)
        # fixed out-degree random connectivity (EventFixedProb equivalent);
        # one combined table so both projections share a single compaction
        # per step
        idx_e = jax.random.randint(k_e, (self.n_exc, n_conn), 0, self.num,
                                   dtype=jnp.int32)
        idx_i = jax.random.randint(k_i, (self.n_inh, n_conn), 0, self.num,
                                   dtype=jnp.int32)
        self.conn_all = jnp.concatenate([idx_e, idx_i], axis=0)
        self.conn_e = FixedNumPerPre(
            (jnp.asarray([self.w_e], jnp.float32), idx_e),
            shape=(self.n_exc, self.num))
        self.conn_i = FixedNumPerPre(
            (jnp.asarray([self.w_i], jnp.float32), idx_i),
            shape=(self.n_inh, self.num))

    # -- state -------------------------------------------------------------

    def init_state(self, key: Optional[jax.Array] = None) -> EINetState:
        key = self._init_key if key is None else key
        neurons = lifref_init(key, self.num, self.params)
        zeros = jnp.zeros(self.num, jnp.float32)
        return EINetState(neurons=neurons, g_e=zeros, g_i=zeros,
                          spike_count=jnp.zeros(self.num, jnp.int32))

    # -- dynamics ------------------------------------------------------------

    def _propagate(self, spk: jax.Array):
        """Fused event propagation: one spike compaction + one 2-channel
        scatter covering both projections; exact overflow fallback."""
        num = self.num
        cap = event_capacity(num)
        n_act = jnp.sum(spk, dtype=jnp.int32)
        (ids,) = jnp.nonzero(spk, size=cap, fill_value=num)
        valid = ids < num
        safe = jnp.where(valid, ids, 0)
        tgt = self.conn_all[safe]                         # (cap, n_conn)
        tgt = jnp.where(valid[:, None], tgt, num)         # drop invalid rows
        is_exc = safe < self.n_exc
        # binary hit counts scaled by the homogeneous weight after the
        # scatter: integer counts in f32 are exact in any summation order,
        # so every device and every shard layout gives the same spikes
        ve = jnp.where(valid & is_exc, 1.0, 0.0).astype(jnp.float32)
        vi = jnp.where(valid & ~is_exc, 1.0, 0.0).astype(jnp.float32)
        n_conn = tgt.shape[1]
        vals = jnp.stack([
            jnp.broadcast_to(ve[:, None], (cap, n_conn)).reshape(-1),
            jnp.broadcast_to(vi[:, None], (cap, n_conn)).reshape(-1),
        ])
        compact = event_scatter_add_multi(tgt.reshape(-1), vals, num)

        if cap >= num:
            return self.w_e * compact[0], self.w_i * compact[1]

        def full():
            gate = spk.astype(jnp.float32)
            exc_gate = gate * (jnp.arange(num) < self.n_exc)
            inh_gate = gate * (jnp.arange(num) >= self.n_exc)
            inc_e = event_scatter_add(
                self.conn_all, exc_gate[:, None], num, dtype=jnp.float32)
            inc_i = event_scatter_add(
                self.conn_all, inh_gate[:, None], num, dtype=jnp.float32)
            return inc_e, inc_i

        counts = jax.lax.cond(n_act <= cap,
                              lambda: (compact[0], compact[1]), full)
        return self.w_e * counts[0], self.w_i * counts[1]

    def step(self, state: EINetState, t: jax.Array,
             inp: float = 20.0) -> EINetState:
        """One dt step: decay synapses, update membranes, then propagate THIS
        step's threshold crossings into the conductances the next step reads
        (the reference examples' ``spk = N(inp); E(spk); I(spk)`` order,
        ``examples/COBA_4k_neurons.py``). Propagating the spikes returned by
        the LIF update — not re-detected from the already-reset membrane —
        is what keeps the recurrent coupling alive: every spike is scattered
        exactly once, before the reset erases the crossing."""
        p = self.params
        import math
        g_e = state.g_e * jnp.float32(math.exp(-self.dt / self.tau_e))
        g_i = state.g_i * jnp.float32(math.exp(-self.dt / self.tau_i))

        if self.coba:
            current = (g_e * (self.e_e - state.neurons.v)
                       + g_i * (self.e_i - state.neurons.v) + inp)
        else:
            current = g_e - g_i + inp

        neurons, spike = lifref_step(state.neurons, current, t, self.dt, p)
        # event-driven scatter: this step's spikes -> conductance increments
        inc_e, inc_i = self._propagate(spike)
        return EINetState(
            neurons=neurons, g_e=g_e + inc_e, g_i=g_i + inc_i,
            spike_count=state.spike_count + spike.astype(jnp.int32))

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[EINetState] = None) -> EINetState:
        """Run ``n_steps`` under one ``lax.fori_loop`` (jit this)."""
        if state is None:
            state = self.init_state()

        def body(i, s):
            return self.step(s, i * self.dt, inp)

        return jax.lax.fori_loop(0, n_steps, body, state)

    def firing_rate_hz(self, state: EINetState, n_steps: int) -> jax.Array:
        """Mean firing rate in Hz over the simulated window."""
        t_sec = n_steps * self.dt * 1e-3
        return state.spike_count.mean() / t_sec
