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

"""Event scatter-add and masked gather.

Every event scatter is ``zeros(n).at[idx].add(v, mode='drop')``: XLA lowers
it to a native atomic scatter on the GPU, the counterpart of the reference's
per-spike ``atomicAdd`` kernels (``brainevent/_csr/binary_csrmv_hybrid.cu``).
Out-of-range targets are dropped, which is how masked events are expressed.

Both helpers are pure JAX, differentiable, and vmap/jit friendly. They are
the workhorses behind the ``jax_raw`` backends of the event primitives and
the EI network's propagation.
"""

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ['event_scatter_add', 'event_scatter_add_multi', 'masked_gather']


def event_scatter_add(
    targets: jax.Array,
    values: jax.Array,
    n_out: int,
    *,
    mask: Optional[jax.Array] = None,
    dtype=None,
) -> jax.Array:
    """``out[targets[e]] += values[e]`` over all events ``e``.

    Parameters
    ----------
    targets : int array, any shape
        Target indices in ``[0, n_out)``. Flattened internally.
    values : array broadcastable to ``targets.shape``
        Contributions. Scalars are broadcast.
    n_out : int
        Output length.
    mask : bool array broadcastable to ``targets.shape``, optional
        Events with a false mask contribute nothing.
    dtype : optional
        Output dtype; defaults to ``values.dtype``.

    Returns
    -------
    jax.Array of shape ``(n_out,)``.
    """
    targets = jnp.asarray(targets)
    values = jnp.broadcast_to(jnp.asarray(values), targets.shape).reshape(-1)
    out_dtype = jnp.dtype(dtype or values.dtype)
    if mask is not None:
        # the out-of-range sentinel drops the event
        targets = jnp.where(jnp.broadcast_to(mask, targets.shape), targets,
                            n_out)
    targets = targets.reshape(-1).astype(jnp.int32)
    out = jnp.zeros(n_out, dtype=out_dtype)
    return out.at[targets].add(values.astype(out_dtype), mode='drop')


def event_scatter_add_multi(
    targets: jax.Array,
    values: jax.Array,
    n_out: int,
) -> jax.Array:
    """Multi-channel scatter-add over one shared target stream.

    ``out[c, p] = sum_e values[c, e] * [targets[e] == p]``, e.g. the
    excitatory and inhibitory projections of an EI network sharing one
    spike compaction. Masking is expressed by zeroing ``values`` or by
    out-of-range targets.

    Parameters
    ----------
    targets : (E,) int array
    values : (C, E) array (already masked)
    n_out : int

    Returns
    -------
    (C, n_out) float32 array.
    """
    targets = targets.reshape(-1).astype(jnp.int32)
    return jnp.stack([
        jnp.zeros(n_out, jnp.float32).at[targets].add(
            values[c].astype(jnp.float32), mode='drop')
        for c in range(values.shape[0])
    ])


def masked_gather(src: jax.Array, idx: jax.Array, mask: Optional[jax.Array] = None, fill=0):
    """``src[idx]`` with invalid lanes replaced by *fill* (gather with drop
    semantics; the gather direction of every transpose product)."""
    idx = jnp.asarray(idx)
    taken = jnp.take(src, jnp.clip(idx, 0, src.shape[0] - 1), axis=0)
    if mask is None:
        return taken
    if taken.ndim > mask.ndim:
        mask = jnp.expand_dims(mask, tuple(range(mask.ndim, taken.ndim)))
    return jnp.where(mask, taken, fill)
