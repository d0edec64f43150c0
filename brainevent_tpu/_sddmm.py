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

"""Sampled dense-dense matrix multiplication (reference ``brainevent/_sddmm.py``).

``S[i, j] = (A @ B)[i, j]`` evaluated only at the given sparsity pattern —
used by the CSR transpose rules to form per-synapse weight gradients without
materializing the dense product: the per-sample row/column gathers feed
one fused multiply-reduce."""

import jax
import jax.numpy as jnp
from jax.experimental import sparse
from jax.experimental.sparse import BCOO

from ._misc import namescope

__all__ = ['sddmm_indices', 'sddmm_coo_indices', 'sddmm_bcoo']


@namescope
def sddmm_indices(A: jax.Array, B: jax.Array, indices: jax.Array) -> BCOO:
    """SDDMM with an ``(nse, 2)`` index array; returns a BCOO."""
    assert A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0]
    assert indices.ndim == 2 and indices.shape[1] == 2
    data = sparse.bcoo_dot_general_sampled(
        A, B, indices, dimension_numbers=(((1,), (0,)), ((), ())))
    return BCOO((data, indices), shape=(A.shape[0], B.shape[1]))


@namescope
def sddmm_coo_indices(A: jax.Array, B: jax.Array,
                      pre_idx: jax.Array, post_idx: jax.Array) -> BCOO:
    """SDDMM with separate row/column index arrays; returns a BCOO."""
    assert pre_idx.ndim == 1 and post_idx.ndim == 1
    assert pre_idx.shape == post_idx.shape
    indices = jnp.stack([pre_idx, post_idx], axis=1)
    return sddmm_indices(A, B, indices)


@namescope
def sddmm_bcoo(A: jax.Array, B: jax.Array, sparsity_pattern: BCOO) -> BCOO:
    """SDDMM sampled at the structure of an existing BCOO matrix."""
    return sddmm_indices(A, B, sparsity_pattern.indices)
