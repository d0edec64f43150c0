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

"""Bit-packed event representation
(reference ``brainevent/_event/bitpack_binary.py``).

``bitpack`` packs 32 binary values per uint32 word; bit ``b`` of word ``w``
is element ``w*32 + b`` along the packed axis. :class:`BitPackedBinary`
keeps the original value (for autodiff and dense products) plus per-axis
packed copies, which compress spike traffic 32x — what matters for
device-memory bandwidth.
"""

import jax
import jax.numpy as jnp

from .._error import MathError
from .base import EventRepresentation, extract_raw_value, is_known_type

__all__ = ['bitpack', 'BitPackedBinary']


def bitpack(arr, axis: int) -> jax.Array:
    """Pack a boolean array into uint32 words along *axis*.

    Non-zero values are treated as ``True``. The packed axis shrinks to
    ``ceil(n / 32)``; bit ``b`` of word ``w`` is element ``w*32 + b``.
    """
    arr = jnp.asarray(arr)
    arr = arr if arr.dtype == jnp.bool_ else (arr != 0)
    axis = axis % arr.ndim
    n = arr.shape[axis]
    n_words = -(-n // 32)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, n_words * 32 - n)
    padded = jnp.pad(arr, pad).astype(jnp.uint32)
    shape = list(padded.shape)
    shape[axis] = n_words
    shape.insert(axis + 1, 32)
    grouped = padded.reshape(shape)
    shift_shape = [1] * grouped.ndim
    shift_shape[axis + 1] = 32
    shifts = jnp.arange(32, dtype=jnp.uint32).reshape(shift_shape)
    return jnp.sum(grouped << shifts, axis=axis + 1, dtype=jnp.uint32)


class BitPackedBinary(EventRepresentation):
    """Spike array kept both raw and bit-packed along every axis.

    ``value`` is the original array (used by dense matmuls and AD);
    ``packed[i]`` is the uint32 packing along axis ``i``. Pure index/bit
    structure — no gradients flow through the packings.
    """

    def __init__(self, value):
        super().__init__(value)
        self._original_shape = tuple(self._value.shape)
        self._packed = tuple(
            bitpack(self._value, axis) for axis in range(self._value.ndim)
        )

    # -- structure ------------------------------------------------------

    @property
    def packed(self):
        """Tuple of per-axis packed uint32 arrays."""
        return self._packed

    @property
    def original_shape(self):
        return self._original_shape

    @property
    def shape(self):
        """Logical (unpacked) shape — shape-compatible with BinaryArray."""
        return self._original_shape

    @property
    def ndim(self):
        return len(self._original_shape)

    # -- products ------------------------------------------------------------

    @property
    def T(self):
        return self._value.T

    def transpose(self, *axes):
        return self._value.transpose(*axes)

    def dot(self, oc):
        return self.__matmul__(oc)

    def __matmul__(self, oc):
        from ..dense.binary import binary_densemv, binary_densemm
        if is_known_type(oc):
            oc = extract_raw_value(oc)
            if self.ndim not in (1, 2):
                raise MathError(f'matmul needs 1D/2D events, got {self.ndim}D.')
            if oc.ndim != 2 or self.shape[-1] != oc.shape[0]:
                raise MathError(
                    f'Incompatible matmul operands: {self.shape} @ {oc.shape}.')
            if self.ndim == 1:
                return binary_densemv(oc, self._value, transpose=True)
            return binary_densemm(oc, self._value.T, transpose=True).T
        return oc.__rmatmul__(self)

    def __rmatmul__(self, oc):
        from ..dense.binary import binary_densemv, binary_densemm
        if is_known_type(oc):
            oc = extract_raw_value(oc)
            if self.ndim not in (1, 2):
                raise MathError(f'matmul needs 1D/2D events, got {self.ndim}D.')
            if oc.ndim != 2 or oc.shape[-1] != self.shape[0]:
                raise MathError(
                    f'Incompatible matmul operands: {oc.shape} @ {self.shape}.')
            if self.ndim == 1:
                return binary_densemv(oc, self._value, transpose=False)
            return binary_densemm(oc, self._value, transpose=False)
        return oc.__matmul__(self)

    # -- pytree ---------------------------------------------------------------

    def tree_flatten(self):
        return (self._value, self._packed), (self._original_shape,)

    @classmethod
    def tree_unflatten(cls, aux_data, flat_contents):
        obj = cls.__new__(cls)
        obj._value, obj._packed = flat_contents
        obj._original_shape = aux_data[0]
        return obj
