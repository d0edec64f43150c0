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

"""Multi-device SNN simulation over a device mesh.

The reference is single-GPU only (SURVEY §2.9: no distributed layer). This
module adds neuron-axis model parallelism via ``shard_map`` over a
``jax.sharding.Mesh``.

Design (one step, per device):

1. Each device owns a contiguous slice of neurons: membrane state, synaptic
   conductances, and the *outgoing* connectivity rows of its neurons.
2. Local spikes scatter through local ELL rows into a full-length partial
   current vector (no communication — targets may be anywhere).
3. One ``psum_scatter`` (reduce-scatter, which XLA lowers to NCCL on GPUs)
   per synapse class reduces the partials and hands every device exactly
   its neuron slice's increments.
4. The LIF membrane update is purely local.

Per step the only collective traffic is one reduce-scatter of two f32
vectors — the minimal possible for arbitrary connectivity.
"""

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.neurons import LIFRefParams
from ..ops.scatter import event_scatter_add

__all__ = ['ShardedEINet', 'ShardedEINetState', 'neuron_mesh',
           'host_chip_mesh']


def neuron_mesh(n_devices: Optional[int] = None, axis: str = 'neurons') -> Mesh:
    """A 1-D device mesh over the neuron axis."""
    devs = jax.devices()[: n_devices] if n_devices else jax.devices()
    import numpy as np
    return Mesh(np.array(devs), (axis,))


def host_chip_mesh(n_hosts: Optional[int] = None,
                   chips_per_host: Optional[int] = None,
                   axes=('hosts', 'chips')) -> Mesh:
    """A 2-D ``(hosts, chips)`` mesh — the multi-host layout.

    On a multi-host cluster the outer axis crosses the network between
    hosts and the inner axis stays on the host's device interconnect, so
    shardings that ``psum_scatter`` over ``chips`` and all-gather over
    ``hosts`` keep the heavy traffic inside a host. On a single host this
    still produces a valid hierarchical mesh for layout testing (e.g. 2x4
    over 8 virtual CPUs).
    The sharded ops (``parallel/ops.py``) accept ``axis=('hosts',
    'chips')`` to shard the row axis over both.
    """
    import numpy as np
    # jax.devices() order is not guaranteed to group by process; if it
    # interleaves, a blind reshape would put cross-host hops on the inner
    # "chips" axis and invert the intended traffic split. Sort so each
    # mesh row holds one process's devices.
    devs = sorted(jax.devices(),
                  key=lambda d: (getattr(d, 'process_index', 0),
                                 getattr(d, 'id', 0)))
    if n_hosts is None:
        n_hosts = max(1, len({getattr(d, 'process_index', 0) for d in devs}))
    if chips_per_host is None:
        chips_per_host = len(devs) // n_hosts
    n = n_hosts * chips_per_host
    return Mesh(np.array(devs[:n]).reshape(n_hosts, chips_per_host), axes)


class ShardedEINetState(NamedTuple):
    v: jax.Array            # (num,) sharded over neurons
    t_last: jax.Array       # (num,)
    g_e: jax.Array          # (num,)
    g_i: jax.Array          # (num,)
    spike_count: jax.Array  # (num,) int32


@dataclasses.dataclass
class ShardedEINet:
    """EI network sharded over the neuron axis of a device mesh.

    Connectivity is one ELL table ``indices (num, n_conn)`` (row ``i`` =
    outgoing targets of neuron ``i``), row-sharded aligned with the neuron
    state; excitatory/inhibitory routing is by global row index
    (first ``n_exc`` rows are excitatory).
    """
    mesh: Mesh
    num: int = 4096
    exc_fraction: float = 0.8
    n_conn: int = 80
    dt: float = 0.1
    w_e: float = 0.6
    w_i: float = 6.7
    tau_e: float = 5.0
    tau_i: float = 10.0
    e_e: float = 0.0
    e_i: float = -80.0
    coba: bool = True
    seed: int = 0
    indices: Optional[jax.Array] = None   # (num, n_conn) global ELL table

    def __post_init__(self):
        self.axis = self.mesh.axis_names[0]
        self.n_dev = self.mesh.devices.size
        if self.num % self.n_dev != 0:
            raise ValueError(
                f'num ({self.num}) must be divisible by the mesh size '
                f'({self.n_dev}).')
        self.n_exc = int(self.num * self.exc_fraction)
        self.params = LIFRefParams()
        key = jax.random.PRNGKey(self.seed)
        k_conn, self._init_key = jax.random.split(key)
        if self.indices is None:
            self.indices = jax.random.randint(
                k_conn, (self.num, self.n_conn), 0, self.num,
                dtype=jnp.int32)
        else:
            self.indices = jnp.asarray(self.indices, jnp.int32)
            if self.indices.shape != (self.num, self.n_conn):
                raise ValueError(
                    f'indices shape {self.indices.shape} != '
                    f'({self.num}, {self.n_conn})')
        self.row_sharding = NamedSharding(self.mesh, P(self.axis))
        self.indices = jax.device_put(self.indices, self.row_sharding)

    @classmethod
    def from_einet(cls, einet, mesh: Mesh) -> 'ShardedEINet':
        """Shard an existing single-chip :class:`~..models.EINet` — same
        connectivity table, weights, and dynamics, so the sharded run can
        be validated state-for-state against the single-chip engine."""
        return cls(mesh=mesh, num=einet.num,
                   exc_fraction=einet.n_exc / einet.num,
                   n_conn=einet.conn_all.shape[1], dt=einet.dt,
                   w_e=einet.w_e, w_i=einet.w_i,
                   tau_e=einet.tau_e, tau_i=einet.tau_i,
                   e_e=einet.e_e, e_i=einet.e_i, coba=einet.coba,
                   seed=einet.seed, indices=einet.conn_all)

    # -- state ------------------------------------------------------------

    def init_state(self) -> ShardedEINetState:
        v = -55.0 + 2.0 * jax.random.normal(self._init_key, (self.num,),
                                            jnp.float32)
        zeros = jnp.zeros(self.num, jnp.float32)
        state = ShardedEINetState(
            v=v, t_last=jnp.full((self.num,), -1e7, jnp.float32),
            g_e=zeros, g_i=zeros,
            spike_count=jnp.zeros(self.num, jnp.int32))
        return jax.tree.map(
            lambda x: jax.device_put(x, self.row_sharding), state)

    def init_state_from(self, einet_state) -> ShardedEINetState:
        """Shard a single-chip :class:`~..models.EINetState` (for exact
        cross-validation against the single-chip engines)."""
        state = ShardedEINetState(
            v=einet_state.neurons.v, t_last=einet_state.neurons.t_last,
            g_e=einet_state.g_e, g_i=einet_state.g_i,
            spike_count=einet_state.spike_count)
        return jax.tree.map(
            lambda x: jax.device_put(x, self.row_sharding), state)

    # -- per-device step body -------------------------------------------------

    def _local_step(self, state: ShardedEINetState, indices_loc, t, inp):
        p = self.params
        axis = self.axis
        n_loc = state.v.shape[0]
        dev = jax.lax.axis_index(axis)
        row0 = dev * n_loc
        global_ids = row0 + jnp.arange(n_loc, dtype=jnp.int32)
        is_exc = global_ids < self.n_exc

        # host-computed f32 decay constants, identical to EINet.step
        # (a traced jnp.exp could differ by 1 ulp and break exactness)
        import math
        g_e = state.g_e * jnp.float32(math.exp(-self.dt / self.tau_e))
        g_i = state.g_i * jnp.float32(math.exp(-self.dt / self.tau_i))

        if self.coba:
            current = (g_e * (self.e_e - state.v)
                       + g_i * (self.e_i - state.v) + inp)
        else:
            current = g_e - g_i + inp

        refractory = (t - state.t_last) < p.tau_ref
        dv = (p.v_rest - state.v + p.r * current) * (self.dt / p.tau)
        v = jnp.where(refractory, state.v, state.v + dv)
        spike = v >= p.v_th

        # Propagate THIS step's crossings (pre-reset — same single-scatter
        # semantics as EINet.step): local hit-COUNT scatter of excitatory/
        # inhibitory events into full-length partials, one reduce-scatter
        # each, then scale by the homogeneous weight. Counting first keeps
        # every partial an exact small integer in f32, so the cross-device
        # reduction is exact and the result is bitwise equal to the
        # single-device count-then-scale path (EINet._propagate).
        part_e = event_scatter_add(
            indices_loc, 1.0, self.num,
            mask=(spike & is_exc)[:, None], dtype=jnp.float32)
        part_i = event_scatter_add(
            indices_loc, 1.0, self.num,
            mask=(spike & ~is_exc)[:, None], dtype=jnp.float32)
        inc_e = self.w_e * jax.lax.psum_scatter(
            part_e, axis, scatter_dimension=0, tiled=True)
        inc_i = self.w_i * jax.lax.psum_scatter(
            part_i, axis, scatter_dimension=0, tiled=True)

        v = jnp.where(spike, p.v_reset, v)
        t_last = jnp.where(spike, t, state.t_last)
        return ShardedEINetState(
            v=v, t_last=t_last, g_e=g_e + inc_e, g_i=g_i + inc_i,
            spike_count=state.spike_count + spike.astype(jnp.int32))

    # -- public API -----------------------------------------------------------

    def step_fn(self):
        """Return a jittable sharded step ``(state, t, inp) -> state``."""
        spec = P(self.axis)

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(ShardedEINetState(*(spec,) * 5), spec, P(), P()),
                 out_specs=ShardedEINetState(*(spec,) * 5),
                 check_vma=False)
        def step(state, indices, t, inp):
            return self._local_step(state, indices, t, inp)

        return lambda state, t, inp=20.0: step(
            state, self.indices, jnp.asarray(t, jnp.float32),
            jnp.asarray(inp, jnp.float32))

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[ShardedEINetState] = None) -> ShardedEINetState:
        """Run ``n_steps`` of the sharded simulation under one fori_loop."""
        if state is None:
            state = self.init_state()
        step = self.step_fn()

        def body(i, s):
            return step(s, i * self.dt, inp)

        return jax.lax.fori_loop(0, n_steps, body, state)
