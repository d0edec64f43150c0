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

"""Multi-backend custom-primitive dispatch: the spine of brainevent-tpu.

One :class:`XLACustomKernel` instance owns one JAX primitive with
``multiple_results=True`` and a per-``(platform, backend)`` table of *kernel
generators*. Backend resolution happens at MLIR lowering time, so a single
jitted function picks the right kernel per compilation platform. This mirrors
the reference design (``brainevent/_op/main.py:96-1439``): the backends are
``jax_raw`` (pure JAX compiled by XLA, every platform, the default), and
``cpp_ffi`` (native C++ XLA-FFI custom calls on CPU). The registration
helpers for GPU kernel routes (``def_cuda_raw_kernel`` etc.) are kept for
API parity with the reference.

A kernel generator is called with the primitive's static parameters
(including ``outs``, the tuple of output ``ShapeDtypeStruct``) and returns a
traceable callable mapping the primitive's array inputs to its outputs.
"""

import dataclasses
import functools
import warnings

from typing import Callable, Dict, List, Optional, Sequence, Union

from .. import config
from .._compat import Primitive, ShapedArray, ad, apply_primitive, batching, mlir
from .._error import (
    BenchmarkDataFnNotProvidedError,
    KernelNotAvailableError,
)
from .._registry import register_primitive
from .util import abstract_arguments, defjvp, general_batching_rule

__all__ = ['KernelEntry', 'XLACustomKernel']

# MLIR lowering platform keys -> brainevent platform names.
_LOWERING_PLATFORMS = {
    'cpu': 'cpu',
    'cuda': 'gpu',
    'rocm': 'gpu',
}

_AMBIGUOUS_WARNED = set()


@dataclasses.dataclass
class KernelEntry:
    """One registered backend kernel (reference ``brainevent/_op/main.py:43``).

    Attributes
    ----------
    generator : Callable
        Kernel generator: called with the primitive's static parameters,
        returns a traceable callable over the array inputs.
    backend : str
        Backend name (``'jax_raw'``, ``'cpp_ffi'``, ...).
    platform : str
        Platform this entry serves (``'cpu'`` or ``'gpu'``).
    """
    generator: Callable
    backend: str
    platform: str


class XLACustomKernel:
    """A JAX primitive with per-platform, per-backend custom kernels.

    Parameters
    ----------
    name : str
        Primitive name; must be unique process-wide. The primitive is
        auto-registered in the global registry for CLI/benchmark discovery.
    doc : str, optional
        Documentation attached to the instance.

    Examples
    --------
    >>> import jax, jax.numpy as jnp
    >>> from brainevent_tpu.ops.core import XLACustomKernel
    >>> prim = XLACustomKernel('my_double')
    >>> def jax_gen(**params):
    ...     return lambda x: [x * 2]
    >>> prim.def_jax_kernel(jax_gen, asdefault=True)
    >>> out, = prim(jnp.ones(4), outs=[jax.ShapeDtypeStruct((4,), jnp.float32)])
    """

    def __init__(self, name: str, doc: Optional[str] = None):
        self.name = name
        self.__doc__ = doc
        self.primitive = Primitive(name)
        self.primitive.multiple_results = True
        self.primitive.def_abstract_eval(self._abstract_eval)
        self.primitive.def_impl(functools.partial(apply_primitive, self.primitive))

        # platform -> {backend -> KernelEntry}; dict preserves registration
        # order, which defines the "first registered" fallback.
        self._kernels: Dict[str, Dict[str, KernelEntry]] = {}
        self._defaults: Dict[str, str] = {}
        self.tags: frozenset = frozenset()
        self._call_fn: Optional[Callable] = None
        self._benchmark_data_fn: Optional[Callable] = None

        for lowering_key, platform in _LOWERING_PLATFORMS.items():
            mlir.register_lowering(
                self.primitive,
                functools.partial(self._lowering, platform),
                platform=lowering_key,
            )
        register_primitive(name, self)

    # ------------------------------------------------------------------
    # Calling
    # ------------------------------------------------------------------

    def __call__(self, *ins, outs, **kwargs):
        """Bind the primitive.

        Parameters
        ----------
        *ins
            Array operands.
        outs
            Output spec(s): anything with ``.shape``/``.dtype`` or a sequence
            thereof. Normalized to a hashable tuple of ``ShapeDtypeStruct``.
        **kwargs
            Static parameters forwarded to the kernel generator. Must all be
            hashable (they become primitive params).

        Returns
        -------
        list of jax.Array
            One array per output spec.
        """
        outs = abstract_arguments(outs)
        for key, val in kwargs.items():
            try:
                hash(val)
            except TypeError:
                raise ValueError(
                    f'Parameter {key!r} of primitive {self.name!r} is not '
                    f'hashable (got {type(val).__name__}); static primitive '
                    f'parameters must be hashable.'
                ) from None
        return self.primitive.bind(*ins, outs=outs, **kwargs)

    call = __call__

    # ------------------------------------------------------------------
    # Abstract evaluation & lowering
    # ------------------------------------------------------------------

    @staticmethod
    def _abstract_eval(*ins, outs, **kwargs):
        return tuple(ShapedArray(o.shape, o.dtype) for o in outs)

    def _resolve_backend(self, platform: str, requested: Optional[str]) -> str:
        table = self._kernels.get(platform, {})
        if not table:
            raise KernelNotAvailableError(self._no_kernel_message(platform))
        # 1. per-call kwarg
        if requested is not None:
            if requested not in table:
                raise KernelNotAvailableError(
                    f"Backend {requested!r} is not registered for primitive "
                    f"{self.name!r} on platform {platform!r}. Available "
                    f"backends: {sorted(table)}. Pick one of those via the "
                    f"backend= argument, or register the missing kernel."
                )
            return requested
        # 2. global config
        global_backend = config.get_backend(platform)
        if global_backend is not None and global_backend in table:
            return global_backend
        # 3. per-primitive default
        default = self._defaults.get(platform)
        if default is not None and default in table:
            return default
        # 4. first registered
        first = next(iter(table))
        if len(table) > 1:
            key = (self.name, platform)
            if key not in _AMBIGUOUS_WARNED:
                _AMBIGUOUS_WARNED.add(key)
                warnings.warn(
                    f"Primitive {self.name!r} has multiple backends on "
                    f"{platform!r} ({sorted(table)}) and no default; using "
                    f"{first!r}. Silence this with "
                    f"{self.name}.set_default('{platform}', ...) or "
                    f"config.set_backend('{platform}', ...).",
                    UserWarning,
                    stacklevel=2,
                )
        return first

    def _no_kernel_message(self, platform: str) -> str:
        others = {p: sorted(t) for p, t in self._kernels.items() if t}
        return (
            f"No kernel is registered for primitive {self.name!r} on "
            f"platform {platform!r}. Kernels exist for: {others or 'no platform'}. "
            f"Register a pure-JAX kernel (def_jax_kernel), which serves every "
            f"platform."
        )

    def _lowering(self, platform: str, ctx, *args, **params):
        backend = params.get('backend', None)
        resolved = self._resolve_backend(platform, backend)
        entry = self._kernels[platform][resolved]
        kernel_fn = entry.generator(platform=platform, **params)

        def _wrapped(*xs, **unused):
            res = kernel_fn(*xs)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            return tuple(res)

        rule = mlir.lower_fun(_wrapped, multiple_results=True)
        return rule(ctx, *args)

    # ------------------------------------------------------------------
    # Kernel registration
    # ------------------------------------------------------------------

    def def_kernel(
        self,
        backend: str,
        platform: Union[str, Sequence[str]],
        generator: Callable,
        asdefault: bool = False,
    ) -> None:
        """Register *generator* as the *backend* kernel on *platform*(s)."""
        platforms = (platform,) if isinstance(platform, str) else tuple(platform)
        for p in platforms:
            if p == 'cuda':
                p = 'gpu'
            self._kernels.setdefault(p, {})[backend] = KernelEntry(
                generator=generator, backend=backend, platform=p)
            if asdefault:
                self._defaults[p] = backend

    def def_jax_kernel(
        self,
        generator: Callable,
        platform: Union[str, Sequence[str]] = ('cpu', 'gpu'),
        asdefault: bool = False,
    ) -> None:
        """Register a pure-JAX (XLA-compiled) kernel generator — the
        ``jax_raw`` backend, available on every platform."""
        self.def_kernel('jax_raw', platform, generator, asdefault=asdefault)

    def def_cpp_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register a native C++ XLA-FFI kernel generator for CPU.

        The generator typically uses :func:`brainevent_tpu.load_cpp_inline`
        to compile-or-cache a module and returns a closure over
        ``jax.ffi.ffi_call``.
        """
        self.def_kernel('cpp_ffi', 'cpu', generator, asdefault=asdefault)

    def def_numba_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register a Numba CPU kernel generator (API parity; requires numba)."""
        self.def_kernel('numba', 'cpu', generator, asdefault=asdefault)

    def def_cuda_raw_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register a raw-CUDA kernel generator (API parity; GPU only)."""
        self.def_kernel('cuda_raw', 'gpu', generator, asdefault=asdefault)

    def def_numba_cuda_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register a Numba-CUDA kernel generator (API parity; GPU only)."""
        self.def_kernel('numba_cuda', 'gpu', generator, asdefault=asdefault)

    def def_warp_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register an NVIDIA-Warp kernel generator (API parity; GPU only)."""
        self.def_kernel('warp', 'gpu', generator, asdefault=asdefault)

    def def_triton_kernel(self, generator: Callable, asdefault: bool = False) -> None:
        """Register a Triton kernel generator (API parity; GPU only)."""
        self.def_kernel('triton', 'gpu', generator, asdefault=asdefault)

    def set_default(self, platform: str, backend: str) -> None:
        """Set the per-primitive default backend for *platform*."""
        if platform == 'cuda':
            platform = 'gpu'
        table = self._kernels.get(platform, {})
        if backend not in table:
            raise KernelNotAvailableError(
                f"Cannot set default backend {backend!r} for {self.name!r} on "
                f"{platform!r}: not registered. Available: {sorted(table)}."
            )
        self._defaults[platform] = backend

    def available_backends(self, platform: str) -> List[str]:
        """Return backend names registered for *platform*."""
        if platform == 'cuda':
            platform = 'gpu'
        return list(self._kernels.get(platform, {}))

    # ------------------------------------------------------------------
    # Transform rules
    # ------------------------------------------------------------------

    def def_batching_rule(self, rule: Callable) -> None:
        """Register a vmap batching rule ``rule(args, dims, **params)``."""
        batching.primitive_batchers[self.primitive] = rule

    def def_general_batching(self) -> None:
        """Register the generic loop/stack batching fallback."""
        self.def_batching_rule(
            functools.partial(general_batching_rule, self.primitive)
        )

    def def_jvp_rule(self, *rules: Optional[Callable]) -> None:
        """Register per-operand JVP rules (see :func:`defjvp`)."""
        defjvp(self.primitive, *rules)

    # The reference distinguishes def_jvp_rule / def_jvp_rule2
    # (brainevent/_op/main.py:959,990); both map onto the same multi-result
    # registration here.
    def_jvp_rule2 = def_jvp_rule

    def def_transpose_rule(self, rule: Callable) -> None:
        """Register the transpose (cotangent) rule for reverse-mode AD."""
        ad.primitive_transposes[self.primitive] = rule

    # ------------------------------------------------------------------
    # Metadata, tags, benchmarking
    # ------------------------------------------------------------------

    def def_call(self, fn: Callable) -> None:
        """Register the high-level ``*_p_call`` used by the benchmark harness."""
        self._call_fn = fn

    def def_tags(self, *tags: str) -> None:
        """Attach registry tags (e.g. ``'csr'``, ``'binary'``)."""
        self.tags = frozenset(map(str, tags))

    def def_benchmark_data(self, fn: Callable) -> None:
        """Register a benchmark-data generator ``fn(*, platform) -> [BenchmarkConfig]``."""
        self._benchmark_data_fn = fn

    def benchmark(
        self,
        platform: Optional[str] = None,
        n_warmup: int = 3,
        n_runs: int = 10,
        verbose: bool = True,
        iterations: int = 1,
        max_configs: int = 0,
    ):
        """Benchmark every registered backend on *platform* over the
        primitive's registered benchmark-data grid.

        Returns a :class:`~brainevent_tpu.BenchmarkResult`.
        """
        import jax
        from .benchmark import benchmark_function, BenchmarkResult

        if self._benchmark_data_fn is None:
            raise BenchmarkDataFnNotProvidedError(
                f'Primitive {self.name!r} has no benchmark data; register a '
                f'generator with def_benchmark_data.'
            )
        if self._call_fn is None:
            raise BenchmarkDataFnNotProvidedError(
                f'Primitive {self.name!r} has no call fn; register it with def_call.'
            )
        platform = platform or jax.default_backend()
        records = []
        configs = self._benchmark_data_fn(platform=platform)
        if max_configs > 0:
            configs = configs[:max_configs]
        for cfg in configs:
            for backend in self.available_backends(platform):
                result = benchmark_function(
                    functools.partial(self._call_fn, backend=backend, **cfg.kwargs),
                    *cfg.args,
                    name=f'{self.name}[{cfg.name}][{backend}]',
                    n_warmup=n_warmup,
                    n_runs=n_runs,
                    verbose=verbose,
                    iterations=iterations,
                    loop_arg=cfg.loop_arg,
                )
                records.extend(result.records)
        return BenchmarkResult(records)

    def __repr__(self):
        plats = {p: sorted(t) for p, t in self._kernels.items()}
        return f'XLACustomKernel({self.name!r}, kernels={plats})'
