# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Native C++ XLA-FFI pipeline for CPU kernels (the reference's "kernix";
reference ``brainevent/_op/kernix_*.py``)."""

from .pipeline import (
    load_cpp_inline, load_cpp_file,
    load_cuda_inline, load_cuda_file, load_cuda_dir,
    set_cache_dir, get_cache_dir, clear_cache, print_diagnostics,
)
from .runtime import CompiledModule, register_ffi_target, list_registered_targets
from .compiler import CompilerBackend, CPPBackend, CUDABackend, HIPBackend
from .codegen import normalize_tokens, parse_annotations, FunctionSpec
from .toolchain import detect_cpp_toolchain, collect_toolchain_diagnostics

__all__ = [
    'load_cpp_inline', 'load_cpp_file',
    'load_cuda_inline', 'load_cuda_file', 'load_cuda_dir',
    'set_cache_dir', 'get_cache_dir', 'clear_cache', 'print_diagnostics',
    'CompiledModule', 'register_ffi_target', 'list_registered_targets',
    'CompilerBackend', 'CPPBackend', 'CUDABackend', 'HIPBackend',
    'normalize_tokens', 'parse_annotations', 'FunctionSpec',
    'detect_cpp_toolchain', 'collect_toolchain_diagnostics',
]
