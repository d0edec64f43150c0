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

"""``CompactBinary``: bitpack + stream compaction of spike events
(reference ``brainevent/_event/compact_binary.py:53``).

The static-capacity active-index list (``active_ids``/``n_active``) is the
key structure for event-driven kernels: downstream scatter/gather ops
iterate only over ``active_ids[:n_active]`` (masked to the static capacity),
turning per-step work from O(n) into O(events) without dynamic shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .bitpack import bitpack
from .compact_ops import (
    binary_1d_array_index_p_call,
    binary_2d_array_index_p_call,
    binary_2d_compact_only_p_call,
)

__all__ = ['CompactBinary']


@jax.tree_util.register_pytree_node_class
class CompactBinary:
    """Binary events stored as (bitpacked words, compacted active indices).

    For 1D input ``(n,)``: packed along axis 0; ``active_ids`` lists active
    element indices. For 2D input ``(n, batch)``: packed along axis 1;
    ``active_ids`` lists rows active in ANY batch column.

    Construct via :meth:`from_array` (full), :meth:`from_array_light`
    (compaction only), or :meth:`from_packed` (precomputed pieces).
    """

    __slots__ = ('_packed', '_active_ids', '_n_active', '_value',
                 '_n_orig', '_batch_size', '_bit_width')
    __array_priority__ = 100

    def __init__(self, packed, active_ids, n_active, value,
                 n_orig, batch_size=None, bit_width=32):
        self._packed = packed
        self._active_ids = active_ids
        self._n_active = n_active
        self._value = value
        self._n_orig = n_orig
        self._batch_size = batch_size
        self._bit_width = bit_width

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_array(cls, x, bit_width=32) -> 'CompactBinary':
        """Bitpack + compact a dense 1D/2D spike array."""
        x = jnp.asarray(x)
        if x.ndim == 1:
            packed = bitpack(x, 0)
            active_ids, n_active = binary_1d_array_index_p_call(x)
            return cls(packed, active_ids, n_active, x, x.shape[0],
                       None, bit_width)
        elif x.ndim == 2:
            packed, active_ids, n_active = binary_2d_array_index_p_call(x)
            return cls(packed, active_ids, n_active, x, x.shape[0],
                       x.shape[1], bit_width)
        raise ValueError(f'CompactBinary.from_array needs 1D/2D, got {x.ndim}D.')

    @classmethod
    def from_array_light(cls, x, bit_width=32) -> 'CompactBinary':
        """Compaction only (no bitpack); ``packed`` is ``None``."""
        x = jnp.asarray(x)
        if x.ndim == 1:
            active_ids, n_active = binary_1d_array_index_p_call(x)
            return cls(None, active_ids, n_active, x, x.shape[0], None, bit_width)
        elif x.ndim == 2:
            active_ids, n_active = binary_2d_compact_only_p_call(x)
            return cls(None, active_ids, n_active, x, x.shape[0],
                       x.shape[1], bit_width)
        raise ValueError(f'from_array_light needs 1D/2D, got {x.ndim}D.')

    @classmethod
    def from_packed(cls, packed, active_ids, n_active, value,
                    n_orig=None, batch_size=None, bit_width=32) -> 'CompactBinary':
        """Assemble from precomputed components."""
        if n_orig is None:
            n_orig = value.shape[0]
        return cls(packed, active_ids, n_active, value, n_orig,
                   batch_size, bit_width)

    @classmethod
    def compacy_only_vector(cls, x) -> 'CompactBinary':
        """Compaction-only 1D constructor.

        (Name kept for API parity with the reference,
        ``brainevent/_event/compact_binary.py:230``; see
        :meth:`compact_only_vector`.)
        """
        return cls.from_array_light(jnp.asarray(x).reshape(-1))

    compact_only_vector = compacy_only_vector

    # -- properties ----------------------------------------------------------

    @property
    def packed(self):
        """Bit-packed uint32 words (or ``None`` for light construction)."""
        return self._packed

    @property
    def active_ids(self):
        """Int32 active indices; valid entries are ``active_ids[:n_active]``."""
        return self._active_ids

    @property
    def n_active(self):
        """Int32 ``(1,)`` count of valid entries of ``active_ids``."""
        return self._n_active

    @property
    def value(self):
        """Original dense spike array (autodiff carrier)."""
        return self._value

    @property
    def n_orig(self) -> int:
        return self._n_orig

    @property
    def batch_size(self):
        return self._batch_size

    @property
    def bit_width(self) -> int:
        return self._bit_width

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def ndim(self):
        return self._value.ndim

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    # -- conversion -------------------------------------------------------------

    def to_dense(self):
        """Return the original dense spike array."""
        return self._value

    # -- products -----------------------------------------------------------------

    def __matmul__(self, oc):
        from .binary import BinaryArray
        return BinaryArray(self._value) @ oc

    def __rmatmul__(self, oc):
        from .binary import BinaryArray
        return oc @ BinaryArray(self._value)

    # -- pytree -------------------------------------------------------------------

    def tree_flatten(self):
        children = (self._packed, self._active_ids, self._n_active, self._value)
        aux = (self._n_orig, self._batch_size, self._bit_width)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = cls.__new__(cls)
        (obj._packed, obj._active_ids, obj._n_active, obj._value) = children
        (obj._n_orig, obj._batch_size, obj._bit_width) = aux_data
        return obj

    def __repr__(self):
        return (f'CompactBinary(shape={self.shape}, dtype={self.dtype}, '
                f'bit_width={self._bit_width})')
