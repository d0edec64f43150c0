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

"""light-RNG: the stateless connectivity sampler, vectorized.

The reference implements this sampler twice — CUDA device code and a
bit-exact Numba port (``brainevent/_numba_random.py:370-677``) — and uses it
to *regenerate* the connectivity of the JIT-connectivity matrices on every
kernel call instead of storing weights. This module is a third expression
of the same mathematical spec: **pure uint32 JAX ops**, written to run
identically

- as plain XLA code (the ``jax_raw`` backends),
- inside Pallas kernels (the same functions trace into them), and
- under vmap over whole tiles of streams at once.

All functions are elementwise over uint32 arrays and avoid 64-bit arithmetic
(no u64 is needed, so x64 mode stays optional): the ``(a*b) >> 32``
high-multiply is computed from 16-bit limbs.

Algorithm components (same constants as the reference spec):

- ``light_rng_mix32`` — murmur-style finalizing mixer.
- ``light_rng_next`` — xorshift32 step (13/17/5) with a zero-state escape.
- ``light_rng_init`` — per-``(row, chunk, lane)`` stream seeding.
- ``light_rng_uniform01`` / ``light_rng_normal01`` — stateless 24-bit uniform
  and Acklam inverse-CDF normal per ``(seed, row, col)`` edge.
- ``light_rng_initial_q`` — stationary first residual via rejection
  (two draws per round, matching the stream-advance contract).
"""

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    'light_rng_mix32',
    'light_rng_bounded',
    'light_rng_next',
    'light_rng_init',
    'light_rng_uniform01',
    'light_rng_normal01',
    'light_rng_initial_q',
]

_U = jnp.uint32


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def _mulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays, via 16-bit
    limbs (no u64)."""
    a = _u32(a)
    b = _u32(b)
    a_hi, a_lo = a >> _U(16), a & _U(0xFFFF)
    b_hi, b_lo = b >> _U(16), b & _U(0xFFFF)
    lo = a_lo * b_lo
    mid1 = a_hi * b_lo
    mid2 = a_lo * b_hi
    hi = a_hi * b_hi
    carry = ((mid1 & _U(0xFFFF)) + (mid2 & _U(0xFFFF)) + (lo >> _U(16))) >> _U(16)
    return hi + (mid1 >> _U(16)) + (mid2 >> _U(16)) + carry


def light_rng_mix32(x):
    """Finalizing bit-mixer (elementwise over uint32 arrays)."""
    x = _u32(x)
    x = x ^ (x >> _U(16))
    x = x * _U(0x7FEB352D)
    x = x ^ (x >> _U(15))
    x = x * _U(0x846CA68B)
    x = x ^ (x >> _U(16))
    return x


def light_rng_bounded(r, bound):
    """Map a uniform uint32 *r* into ``[0, bound)`` without modulo bias
    (the ``__umulhi`` trick), elementwise."""
    return _mulhi32(r, bound)


def light_rng_next(state):
    """Advance xorshift32 streams; a zero state escapes to a fixed constant."""
    x = _u32(state)
    x = x ^ (x << _U(13))
    x = x ^ (x >> _U(17))
    x = x ^ (x << _U(5))
    return jnp.where(x == _U(0), _U(0x6D2B79F5), x)


def light_rng_init(seed, row, chunk_id, lane):
    """Seed one stream per ``(row, chunk_id, lane)`` (broadcasting)."""
    x = _u32(seed) ^ _U(0xD1B54A35)
    x = x ^ (_u32(row) * _U(0x85EBCA6B))
    x = x ^ (_u32(chunk_id) * _U(0xC2B2AE35))
    x = x ^ (_u32(lane) * _U(0x27D4EB2D))
    x = light_rng_mix32(x)
    return jnp.where(x == _U(0), _U(0x6D2B79F5), x)


def light_rng_uniform01(seed, row, col):
    """Stateless 24-bit uniform in [0, 1) per ``(seed, row, col)`` edge."""
    h = _u32(seed) ^ _U(0xA0761D65)
    h = h ^ (_u32(row) * _U(0xE7037ED1))
    h = h ^ (_u32(col) * _U(0x8EBC6AF1))
    h = light_rng_mix32(h)
    # cast via int32: the masked value is 24-bit so the route is exact
    return (h & _U(0x00FFFFFF)).astype(jnp.int32).astype(
        jnp.float32) * jnp.float32(1.0 / 16777216.0)


# Acklam inverse-normal-CDF coefficients (float32), identical to the
# reference spec (``brainevent/_numba_random.py:433-487``).
_A = (-39.696830, 220.94609, -275.92851, 138.35775, -30.664799, 2.5066283)
_B = (-54.476099, 161.58584, -155.69898, 66.801312, -13.280681)
_C = (-0.007784894, -0.32239646, -2.4007583, -2.5497325, 4.3746641, 2.9381640)
_D = (0.007784696, 0.32246713, 2.4451342, 3.7544087)


def _acklam_tail(v):
    f32 = jnp.float32
    c1, c2, c3, c4, c5, c6 = (f32(c) for c in _C)
    d1, d2, d3, d4 = (f32(d) for d in _D)
    num = ((((c1 * v + c2) * v + c3) * v + c4) * v + c5) * v + c6
    den = (((d1 * v + d2) * v + d3) * v + d4) * v + f32(1.0)
    return num / den


def _acklam_central(u):
    f32 = jnp.float32
    a1, a2, a3, a4, a5, a6 = (f32(a) for a in _A)
    b1, b2, b3, b4, b5 = (f32(b) for b in _B)
    v = u - f32(0.5)
    r = v * v
    num = (((((a1 * r + a2) * r + a3) * r + a4) * r + a5) * r + a6) * v
    den = ((((b1 * r + b2) * r + b3) * r + b4) * r + b5) * r + f32(1.0)
    return num / den


def light_rng_normal01(seed, row, col):
    """Stateless standard-normal variate per ``(seed, row, col)`` edge
    (Acklam inverse-CDF of the 24-bit uniform), elementwise float32."""
    f32 = jnp.float32
    u = light_rng_uniform01(seed, row, col)
    u = jnp.clip(u, f32(1e-10), f32(1.0 - 1e-10))
    lo_v = jnp.sqrt(f32(-2.0) * jnp.log(jnp.maximum(u, f32(1e-30))))
    hi_v = jnp.sqrt(f32(-2.0) * jnp.log(jnp.maximum(f32(1.0) - u, f32(1e-30))))
    z = jnp.where(
        u < f32(0.02425),
        -_acklam_tail(lo_v),
        jnp.where(u > f32(0.97575), _acklam_tail(hi_v), _acklam_central(u)),
    )
    return z.astype(jnp.float32)


def light_rng_initial_q(state, cl) -> Tuple[jax.Array, jax.Array]:
    """Draw the stationary initial residual ``q`` for every stream.

    Vectorized rejection sampling: each round draws twice per still-pending
    stream (matching the reference's stream-advance contract per stream),
    looping until every stream has accepted.

    Parameters
    ----------
    state : uint32 array
        Current per-stream xorshift32 states.
    cl : uint32 scalar or array
        Connection length (``>= 2``).

    Returns
    -------
    (q, state) : pair of uint32 arrays shaped like the input state.
    """
    state = _u32(state)
    n = _u32(cl) - _U(1)

    def cond(carry):
        _, _, done = carry
        return jnp.logical_not(jnp.all(done))

    def body(carry):
        q, st, done = carry
        st1 = light_rng_next(st)
        cand = light_rng_bounded(st1, n)
        st2 = light_rng_next(st1)
        gate = light_rng_bounded(st2, n)
        accept = jnp.logical_and(jnp.logical_not(done), gate < (n - cand))
        q = jnp.where(accept, cand, q)
        # Pending streams advance; finished streams keep their state.
        st = jnp.where(done, st, st2)
        done = jnp.logical_or(done, accept)
        return q, st, done

    q0 = jnp.zeros_like(state)
    # derive from state so the carry keeps the same varying-manual-axes
    # type under shard_map (a plain zeros() is axis-unvarying and the
    # while_loop carry check rejects the mix)
    done0 = jnp.zeros_like(state, dtype=jnp.bool_)
    q, state, _ = jax.lax.while_loop(cond, body, (q0, state, done0))
    return q, state
