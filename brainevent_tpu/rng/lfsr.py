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

"""Combined-LFSR random number generators for use inside Pallas kernels.

Capability parity with ``brainevent/_pallas_random.py`` (``PallasLFSR88RNG``,
``PallasLFSR113RNG``, ``PallasLFSR128RNG``): pytree-registered counter RNGs
whose state is four ``uint32`` values and whose steps use only shifts, masks,
and XORs. Because every method is elementwise, the state may be a *tile* of
independent streams (e.g. ``(8, 128)`` uint32): one stream per vector lane
rather than one per CUDA thread.

The three generators are L'Ecuyer's combined Tausworthe families with periods
~2^88, ~2^113, and ~2^128. Select the family globally with
``config.set_lfsr_algorithm`` and :func:`get_pallas_lfsr_rng_class`.
"""

import abc
from typing import Tuple

import jax
import jax.numpy as jnp

from .. import config

__all__ = [
    'LFSRBase',
    'PallasLFSR88RNG',
    'PallasLFSR113RNG',
    'PallasLFSR128RNG',
    'PallasLFSRRNG',
    'get_pallas_lfsr_rng_class',
]

_U = jnp.uint32
_TWO_POW_M32 = 2.3283064365386963e-10  # 2**-32


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


class LFSRBase(abc.ABC):
    """Base class for combined-LFSR generators (reference
    ``brainevent/_pallas_random.py:34``).

    The state (``key``) is a tuple of four uint32 arrays of identical shape;
    scalar keys generate scalars, shaped keys generate per-lane streams.
    Methods advance the internal key in place (Python-object statefulness),
    which composes with JAX tracing because instances are pytree nodes.
    """

    def __init__(self, seed):
        self._key = self.generate_key(seed)

    # -- state ----------------------------------------------------------

    @property
    def key(self) -> Tuple[jax.Array, ...]:
        """Current state: a tuple of four uint32 arrays."""
        return self._key

    @key.setter
    def key(self, value):
        value = tuple(_u32(v) for v in value)
        if len(value) != 4:
            raise ValueError(f'LFSR key must have 4 components, got {len(value)}.')
        self._key = value

    @abc.abstractmethod
    def generate_key(self, seed) -> Tuple[jax.Array, ...]:
        """Expand *seed* into the initial 4-component state."""

    @abc.abstractmethod
    def generate_next_key(self) -> Tuple[jax.Array, ...]:
        """Return the state advanced by one step (does not mutate)."""

    @abc.abstractmethod
    def _output(self, key) -> jax.Array:
        """Combine a state into one uint32 output."""

    # -- draws ----------------------------------------------------------

    def randint(self) -> jax.Array:
        """Uniform uint32 draw; advances the state."""
        self._key = self.generate_next_key()
        return self._output(self._key)

    def rand(self) -> jax.Array:
        """Uniform float in [0, 1); advances the state."""
        return self.randint().astype(jnp.float32) * jnp.float32(_TWO_POW_M32)

    def randn(self, epsilon: float = 1e-10) -> jax.Array:
        """Standard normal via Box-Muller (two draws); advances the state."""
        u1 = self.rand()
        u2 = self.rand()
        u1 = jnp.maximum(u1, jnp.float32(epsilon))
        mag = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
        return mag * jnp.sin(jnp.float32(2.0 * jnp.pi) * u2)

    def uniform(self, low, high) -> jax.Array:
        """Uniform float in [low, high); advances the state."""
        return self.rand() * (high - low) + low

    def normal(self, mu, sigma, epsilon: float = 1e-10) -> jax.Array:
        """Normal draw N(mu, sigma); advances the state."""
        return mu + sigma * self.randn(epsilon)

    def random_integers(self, low, high) -> jax.Array:
        """Uniform integer in [low, high] inclusive; advances the state."""
        span = _U(int(high) + 1 - int(low))
        val = self.randint()
        return (val % span).astype(jnp.int32) + jnp.int32(low)

    # -- pytree protocol --------------------------------------------------

    def tree_flatten(self):
        return (self._key,), None

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = cls.__new__(cls)
        obj._key = children[0]
        return obj

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_node_class(cls)

    def __repr__(self):
        return f'{type(self).__name__}(key={self._key})'


class PallasLFSR88RNG(LFSRBase):
    """Combined Tausworthe LFSR88 (period ~2^88; three active components)."""

    def generate_key(self, seed):
        seed = _u32(seed)
        return (seed + _U(2), seed + _U(8), seed + _U(16), jnp.zeros_like(seed))

    def generate_next_key(self):
        s1, s2, s3, _ = self._key
        b = ((s1 << _U(13)) ^ s1) >> _U(19)
        s1 = ((s1 & _U(0xFFFFFFFE)) << _U(12)) ^ b
        b = ((s2 << _U(2)) ^ s2) >> _U(25)
        s2 = ((s2 & _U(0xFFFFFFF8)) << _U(4)) ^ b
        b = ((s3 << _U(3)) ^ s3) >> _U(11)
        s3 = ((s3 & _U(0xFFFFFFF0)) << _U(17)) ^ b
        return (s1, s2, s3, b)

    def _output(self, key):
        return key[0] ^ key[1] ^ key[2]


class PallasLFSR113RNG(LFSRBase):
    """Combined Tausworthe LFSR113 (period ~2^113; four components)."""

    def generate_key(self, seed):
        seed = _u32(seed)
        return (seed + _U(2), seed + _U(8), seed + _U(16), seed + _U(128))

    def generate_next_key(self):
        z1, z2, z3, z4 = self._key
        b = ((z1 << _U(6)) ^ z1) >> _U(13)
        z1 = ((z1 & _U(0xFFFFFFFE)) << _U(18)) ^ b
        b = ((z2 << _U(2)) ^ z2) >> _U(27)
        z2 = ((z2 & _U(0xFFFFFFF8)) << _U(2)) ^ b
        b = ((z3 << _U(13)) ^ z3) >> _U(21)
        z3 = ((z3 & _U(0xFFFFFFF0)) << _U(7)) ^ b
        b = ((z4 << _U(3)) ^ z4) >> _U(12)
        z4 = ((z4 & _U(0xFFFFFF80)) << _U(13)) ^ b
        return (z1, z2, z3, z4)

    def _output(self, key):
        return key[0] ^ key[1] ^ key[2] ^ key[3]


class PallasLFSR128RNG(LFSRBase):
    """Combined Tausworthe LFSR128 (period ~2^128; four components)."""

    def generate_key(self, seed):
        s = _u32(seed)
        return (
            s + _U(123),
            s ^ _U(0xFEDC7890),
            (s << _U(3)) + _U(0x1A2B3C4D),
            ~(s + _U(0x5F6E7D8C)),
        )

    def generate_next_key(self):
        z1, z2, z3, z4 = self._key
        b = ((z1 << _U(7)) ^ z1) >> _U(9)
        z1 = ((z1 & _U(0xFFFFFFFE)) << _U(15)) ^ b
        b = ((z2 << _U(5)) ^ z2) >> _U(23)
        z2 = ((z2 & _U(0xFFFFFFF0)) << _U(6)) ^ b
        b = ((z3 << _U(11)) ^ z3) >> _U(17)
        z3 = ((z3 & _U(0xFFFFFF80)) << _U(8)) ^ b
        b = ((z4 << _U(13)) ^ z4) >> _U(7)
        z4 = ((z4 & _U(0xFFFFFFE0)) << _U(10)) ^ b
        return (z1, z2, z3, z4)

    def _output(self, key):
        return key[0] ^ key[1] ^ key[2] ^ key[3]


_CLASSES = {
    'lfsr88': PallasLFSR88RNG,
    'lfsr113': PallasLFSR113RNG,
    'lfsr128': PallasLFSR128RNG,
}


def get_pallas_lfsr_rng_class():
    """Return the LFSR class selected by ``config.set_lfsr_algorithm``."""
    return _CLASSES[config.get_lfsr_algorithm()]


def PallasLFSRRNG(seed) -> LFSRBase:
    """Construct an RNG of the globally configured LFSR family."""
    return get_pallas_lfsr_rng_class()(seed)
