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

"""Global configuration for brainevent-tpu.

Capability parity with the reference config module
(``brainevent/config.py:45-421``): numba threading knobs, LFSR algorithm
selection, the per-platform global backend map and the CUDA toolchain
preferences — plus the static event capacity of the compacted scatter,
JITC plan caching, and the persistent compilation cache used by the
repository's entry points.
"""

import os
from typing import Optional

__all__ = [
    # numba (parity; inert unless numba is installed)
    'set_numba_parallel', 'get_numba_parallel', 'get_numba_num_threads',
    # LFSR algorithm
    'set_lfsr_algorithm', 'get_lfsr_algorithm',
    # global per-platform backend
    'set_backend', 'get_backend', 'clear_backends',
    # CUDA toolchain preferences
    'prefer_system_nvcc', 'set_compute_capability', 'get_compute_capability',
    # event capacity and JITC plan caching
    'set_event_capacity_divisor', 'get_event_capacity_divisor',
    'set_jitc_auto_plan', 'get_jitc_auto_plan',
    # persistent compilation cache
    'set_compilation_cache', 'get_compilation_cache', 'entry_point_cache',
]

# Platforms the backend map accepts; mirrors reference
# ``brainevent/config.py:220-324``.
_KNOWN_PLATFORMS = ('cpu', 'gpu', 'cuda')

_LFSR_ALGORITHMS = ('lfsr88', 'lfsr113', 'lfsr128')

_state = {
    'numba_parallel': True,
    'numba_num_threads': None,  # None = numba default
    'lfsr_algorithm': 'lfsr88',
    'backends': {},  # platform -> backend name or None
    'prefer_system_nvcc': False,
    'compute_capability': None,
    # Event-driven scatter kernels size their static active-spike capacity as
    # n_pre // divisor (>= 128). Overflow falls back to a full scatter via
    # lax.cond, so results stay exact at any firing rate.
    'event_capacity_divisor': int(
        os.environ.get('BRAINEVENT_EVENT_CAPACITY_DIVISOR', 32)),
    # JITC matrix classes transparently build + cache a walk plan on the
    # first concrete 1-D product and reuse it (the stationary-q setup is
    # paid once per matrix instead of once per product).
    'jitc_auto_plan': os.environ.get(
        'BRAINEVENT_JITC_AUTO_PLAN', '1') not in ('0', 'false', 'False'),
    # Persistent XLA compilation cache directory set through this module
    # (None = not set here). Importing the package never sets it.
    'compilation_cache_dir': None,
}


def set_compilation_cache(path: Optional[str],
                          *, min_compile_time_secs: float = 1.0) -> None:
    """Enable (or disable) JAX's persistent compilation cache.

    The counterpart of the reference's on-disk kernel artifact cache
    (``brainevent/_op/kernix_cache.py:41`` — pay nvcc once per content
    hash): here the artifact is the serialized XLA executable, keyed by
    JAX on the program and its compile options, so later *processes*
    skip the compile.

    Parameters
    ----------
    path : str or None
        Cache directory (created if missing); ``None`` disables the cache.
    min_compile_time_secs : float
        Only compiles at least this slow are persisted. Pass ``0.0`` to
        persist everything (useful in tests).
    """
    import jax

    if path is None:
        _state['compilation_cache_dir'] = None
        jax.config.update('jax_compilation_cache_dir', None)
        return
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      float(min_compile_time_secs))
    _state['compilation_cache_dir'] = path


def get_compilation_cache() -> Optional[str]:
    """Return the cache directory set by :func:`set_compilation_cache`
    (or ``None``)."""
    return _state['compilation_cache_dir']


def entry_point_cache(default_dir: str) -> str:
    """The compilation cache rule of the repository's entry points.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache goes to *default_dir*
    (a fixed path: the directory is part of what makes a cache hit).
    Returns the directory in use.
    """
    env_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env_dir:
        return env_dir
    set_compilation_cache(default_dir)
    return _state['compilation_cache_dir']


# ----------------------------------------------------------------------------
# Numba threading (parity with reference brainevent/config.py:45-119).
# ----------------------------------------------------------------------------

def set_numba_parallel(parallel: bool = True, num_threads: Optional[int] = None) -> None:
    """Configure Numba CPU-kernel parallelism.

    Kept for API parity with the reference; it only takes effect when numba
    is installed and numba-backed kernels are used.
    """
    if num_threads is not None:
        num_threads = int(num_threads)
        if num_threads <= 0:
            raise ValueError(f'num_threads must be positive, got {num_threads}.')
        try:
            import numba  # noqa: F401
            numba.set_num_threads(num_threads)
        except ImportError:
            pass
    _state['numba_parallel'] = bool(parallel)
    _state['numba_num_threads'] = num_threads


def get_numba_parallel() -> bool:
    """Return whether Numba CPU kernels should use ``prange`` parallelism."""
    return _state['numba_parallel']


def get_numba_num_threads() -> Optional[int]:
    """Return the configured Numba thread count (``None`` = numba default)."""
    return _state['numba_num_threads']


# ----------------------------------------------------------------------------
# LFSR algorithm selection (parity with reference brainevent/config.py:155-190).
# ----------------------------------------------------------------------------

def set_lfsr_algorithm(algorithm: str) -> None:
    """Select the LFSR family used by the Pallas RNG classes.

    One of ``'lfsr88'``, ``'lfsr113'``, ``'lfsr128'``. Affects
    :func:`brainevent_tpu.get_pallas_lfsr_rng_class`.
    """
    algorithm = str(algorithm).lower()
    if algorithm not in _LFSR_ALGORITHMS:
        raise ValueError(
            f'Unknown LFSR algorithm {algorithm!r}; expected one of {_LFSR_ALGORITHMS}.'
        )
    _state['lfsr_algorithm'] = algorithm


def get_lfsr_algorithm() -> str:
    """Return the currently selected LFSR algorithm name."""
    return _state['lfsr_algorithm']


# ----------------------------------------------------------------------------
# Global per-platform backend map (parity with brainevent/config.py:220-324).
# ----------------------------------------------------------------------------

def set_backend(platform: str, backend: Optional[str]) -> None:
    """Set the global default backend for *platform*.

    Backend-selection priority (highest first), identical to the reference
    (``brainevent/_op/main.py:504-548``)::

        per-call backend= kwarg  >  config.set_backend(platform, backend)
        >  per-primitive default  >  first registered backend

    Passing ``backend=None`` clears the global choice for *platform*.
    """
    platform = str(platform).lower()
    if platform not in _KNOWN_PLATFORMS:
        raise ValueError(
            f'Unknown platform {platform!r}; expected one of {_KNOWN_PLATFORMS}.'
        )
    if platform == 'cuda':
        platform = 'gpu'
    if backend is None:
        _state['backends'].pop(platform, None)
    else:
        _state['backends'][platform] = str(backend)


def get_backend(platform: str) -> Optional[str]:
    """Return the globally configured backend for *platform* (or ``None``)."""
    platform = str(platform).lower()
    if platform == 'cuda':
        platform = 'gpu'
    return _state['backends'].get(platform)


def clear_backends() -> None:
    """Clear every globally configured per-platform backend."""
    _state['backends'] = {}


# ----------------------------------------------------------------------------
# CUDA toolchain preferences — API parity; stored for the CUDA pipeline
# (reference brainevent/config.py:366-421).
# ----------------------------------------------------------------------------

def prefer_system_nvcc(enable: bool = True) -> None:
    """Prefer a system-installed nvcc over pip-bundled toolchains.

    Parity shim: stored for the CUDA pipeline
    (:func:`brainevent_tpu.load_cuda_inline`), which is not built yet.
    """
    _state['prefer_system_nvcc'] = bool(enable)


def set_compute_capability(value: "str | list[str] | None" = None) -> None:
    """Override the GPU compute capabilities targeted by CUDA compilation.

    Parity shim (reference ``brainevent/config.py:387``); stored for the
    CUDA pipeline, which is not built yet.
    """
    if value is None:
        _state['compute_capability'] = None
    elif isinstance(value, str):
        _state['compute_capability'] = [value]
    else:
        _state['compute_capability'] = [str(v) for v in value]


def get_compute_capability() -> "list[str] | None":
    """Return the configured compute-capability override (or ``None``)."""
    return _state['compute_capability']


# ----------------------------------------------------------------------------
# Event capacity and JITC plan caching.
# ----------------------------------------------------------------------------

def set_event_capacity_divisor(n: int) -> None:
    """Set the static active-spike capacity divisor of event scatter kernels.

    The transpose (scatter) direction of the fixed-connectivity event
    products compacts spikes into a static buffer of
    ``max(128, n_pre // divisor)`` entries and falls back to a full scatter
    (``lax.cond``) if more neurons fire. Smaller divisors = more headroom,
    larger = faster steady state. Results are exact either way.
    """
    n = int(n)
    if n < 1:
        raise ValueError(f'divisor must be >= 1, got {n}.')
    _state['event_capacity_divisor'] = n


def get_event_capacity_divisor() -> int:
    """Return the event-capacity divisor (see :func:`set_event_capacity_divisor`)."""
    return _state['event_capacity_divisor']


def set_jitc_auto_plan(enabled: bool) -> None:
    """Enable/disable transparent walk-plan caching on the JITC classes.

    When on (default), the first 1-D product of a matrix with concrete
    buffers builds a :class:`~brainevent_tpu.jitc.JITCWalkPlan` and
    every later 1-D product reuses it — same sampled matrix, the
    stationary-q setup paid once. 2-D products keep the direct route
    (they sample the mm-mode matrix by contract). Off restores
    per-call setup everywhere.
    """
    _state['jitc_auto_plan'] = bool(enabled)


def get_jitc_auto_plan() -> bool:
    """Return whether JITC auto-plan caching is on (see
    :func:`set_jitc_auto_plan`)."""
    return _state['jitc_auto_plan']
