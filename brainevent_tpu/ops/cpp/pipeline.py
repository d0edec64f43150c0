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

"""Runtime native-compilation pipeline
(reference ``brainevent/_op/kernix_pipeline.py``): parse -> codegen ->
compile -> cache -> load -> register.

The live path is C++ on CPU (``load_cpp_inline``/``load_cpp_file``); the
``load_cuda_*`` entry points are kept for API parity and raise
:class:`CUDANotInstalledError` until runtime CUDA compilation is built
(device code runs through XLA).
"""

from pathlib import Path
from typing import Dict, List, Optional

from ..._error import CUDANotInstalledError
from .cache import CompilationCache, clear_cache, get_cache_dir, set_cache_dir
from .codegen import parse_annotations, preprocess_source
from .compiler import CPPBackend
from .runtime import CompiledModule
from .toolchain import collect_toolchain_diagnostics, detect_cpp_toolchain

__all__ = [
    'load_cpp_inline', 'load_cpp_file',
    'load_cuda_inline', 'load_cuda_file', 'load_cuda_dir',
    'set_cache_dir', 'get_cache_dir', 'clear_cache', 'print_diagnostics',
]

_loaded_modules: Dict[str, CompiledModule] = {}


def load_cpp_inline(source: str, name: str,
                    extra_cflags: Optional[List[str]] = None) -> CompiledModule:
    """Compile (or fetch cached) an inline C++ module and register its
    ``// @BE`` exports as CPU XLA-FFI targets.

    Returns a :class:`CompiledModule`; targets are named
    ``"<name>.<export>"`` and callable via ``jax.ffi.ffi_call``.

    Example
    -------
    >>> mod = load_cpp_inline(r'''
    ... #include "brainevent/tensor.h"
    ... // @BE scale_by_two
    ... void scale_by_two(const BE::Tensor& x, BE::Tensor& out) {
    ...   for (int64_t i = 0; i < x.numel(); ++i)
    ...     out.data<float>()[i] = x.data<float>()[i] * 2.0f;
    ... }
    ... ''', name='demo')          # doctest: +SKIP
    """
    if name in _loaded_modules:
        return _loaded_modules[name]

    specs = parse_annotations(source)
    generated = preprocess_source(source, specs)
    toolchain = detect_cpp_toolchain()
    cache = CompilationCache(
        name, generated + repr(extra_cflags),
        f'{toolchain.cxx}:{toolchain.version}')

    so_path = cache.lookup()
    if so_path is None:
        src_path = cache.store_source(generated)
        so_path = CPPBackend(toolchain).compile_source(
            src_path, cache.so_path, extra_cflags)

    exports = [getattr(s, 'export', s.name) for s in specs]
    module = CompiledModule(name, so_path, exports, cache.key)
    _loaded_modules[name] = module
    return module


def load_cpp_file(path, name: Optional[str] = None,
                  extra_cflags: Optional[List[str]] = None) -> CompiledModule:
    """Compile-or-load a C++ source file (see :func:`load_cpp_inline`)."""
    path = Path(path)
    return load_cpp_inline(path.read_text(), name or path.stem,
                           extra_cflags=extra_cflags)


_CUDA_MSG = (
    'Runtime CUDA compilation ({fn}) is not built yet. Device code runs '
    'through XLA (XLACustomKernel.def_jax_kernel); native CPU kernels use '
    'load_cpp_inline / load_cpp_file.'
)


def load_cuda_inline(*args, **kwargs):
    """API-parity stub (reference ``kernix_pipeline.py:255``)."""
    raise CUDANotInstalledError(_CUDA_MSG.format(fn='load_cuda_inline'))


def load_cuda_file(*args, **kwargs):
    """API-parity stub (reference ``kernix_pipeline.py:448``)."""
    raise CUDANotInstalledError(_CUDA_MSG.format(fn='load_cuda_file'))


def load_cuda_dir(*args, **kwargs):
    """API-parity stub (reference ``kernix_pipeline.py:476``)."""
    raise CUDANotInstalledError(_CUDA_MSG.format(fn='load_cuda_dir'))


def print_diagnostics() -> None:
    """Print a toolchain/cache snapshot (reference ``kernix_pipeline.py:701``)."""
    print('brainevent-tpu native pipeline diagnostics')
    print(f'  cache_dir: {get_cache_dir()}')
    for key, val in collect_toolchain_diagnostics().items():
        print(f'  {key}: {val}')
    print(f'  loaded_modules: {sorted(_loaded_modules)}')
