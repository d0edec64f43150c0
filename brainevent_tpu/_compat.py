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

"""JAX internals the package builds on, imported from one place
(capability parity with reference ``brainevent/_compatible_import.py``).
"""

from jax._src.dispatch import apply_primitive
from jax.core import ShapedArray
from jax.extend.core import Primitive
from jax.interpreters import ad, batching, mlir

__all__ = [
    'Primitive',
    'apply_primitive',
    'ShapedArray',
    'ad',
    'batching',
    'mlir',
]
