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

"""Shared type aliases for the brainevent-tpu public API.

Capability parity with the reference type module
(``brainevent/_typing.py:16-82``), re-expressed for a JAX stack.
"""

from typing import Callable, Literal, Sequence, Tuple, Union

import jax
import numpy as np

__all__ = [
    'MatrixShape',
    'Data',
    'Index',
    'Indptr',
    'ArrayLike',
    'KernelGenerator',
    'MatrixMode',
    'PallasRandomKey',
]

# Logical 2-D shape ``(n_rows, n_cols)`` of a sparse/implicit matrix.
MatrixShape = Tuple[int, int]

# Array-valued operator data (weights, vectors, matrices). ``brainunit``
# quantities are accepted wherever ``Data`` appears when brainunit is
# installed; the unit is split off before primitives are bound.
Data = Union[jax.Array, np.ndarray, float, int]

# Integer index arrays (CSR/CSC/ELL indices).
Index = Union[jax.Array, np.ndarray]

# CSR/CSC row/column pointer arrays.
Indptr = Union[jax.Array, np.ndarray]

ArrayLike = Union[jax.Array, np.ndarray, Sequence, float, int, bool]

# A kernel generator is called at lowering time with the primitive's static
# parameters (``shape=``, ``transpose=``, ``outs=``, ...) and returns a
# traceable callable mapping the primitive's array inputs to its outputs
# (reference ``brainevent/_typing.py`` KernelGenerator).
KernelGenerator = Callable[..., Callable]

# Implicit (JIT-connectivity) matrices draw *different* random matrices in
# matrix-vector ('mv', lane stride 32) and matrix-matrix ('mm', lane stride 4)
# modes; this mirrors the reference contract (``brainevent/_typing.py:79-82``).
MatrixMode = Literal['mv', 'mm']

# Counter state threaded through the Pallas LFSR RNG classes: a pytree of four
# uint32 arrays.
PallasRandomKey = Tuple[jax.Array, jax.Array, jax.Array, jax.Array]
