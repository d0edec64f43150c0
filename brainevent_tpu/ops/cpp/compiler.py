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

"""Compiler backends (reference ``brainevent/_op/kernix_compiler.py``).

``CPPBackend`` is the live backend (g++/clang++ -> .so);
``CUDABackend``/``HIPBackend`` are API-parity stubs that raise with guidance
(runtime CUDA compilation is not built yet).
"""

import abc
import os
import subprocess
from pathlib import Path
from typing import List, Optional

from ..._error import CompilationError, CUDANotInstalledError

__all__ = ['CompilerBackend', 'CPPBackend', 'CUDABackend', 'HIPBackend']

_DEFAULT_TIMEOUT = int(os.environ.get('BRAINEVENT_COMPILE_TIMEOUT', 300))


class CompilerBackend(abc.ABC):
    """Abstract native compiler backend."""

    @abc.abstractmethod
    def compile_source(self, src_path: Path, out_path: Path,
                       extra_cflags: Optional[List[str]] = None) -> Path:
        """Compile *src_path* into the shared library *out_path*."""


class CPPBackend(CompilerBackend):
    """Host C++ -> shared library via the detected toolchain."""

    def __init__(self, toolchain=None):
        from .toolchain import detect_cpp_toolchain
        self.toolchain = toolchain or detect_cpp_toolchain()

    def compile_source(self, src_path: Path, out_path: Path,
                       extra_cflags: Optional[List[str]] = None) -> Path:
        cmd = self.toolchain.compile_command(src_path, out_path, extra_cflags)
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=_DEFAULT_TIMEOUT)
        except subprocess.TimeoutExpired as exc:
            raise CompilationError(
                f'C++ compilation timed out after {_DEFAULT_TIMEOUT}s: '
                f'{" ".join(cmd)}'
            ) from exc
        if proc.returncode != 0:
            raise CompilationError(
                f'C++ compilation failed (exit {proc.returncode}).\n'
                f'Command: {" ".join(cmd)}\n'
                f'--- stderr ---\n{proc.stderr[-4000:]}'
            )
        return out_path


class CUDABackend(CompilerBackend):
    """API-parity stub: CUDA runtime compilation is a GPU-only capability."""

    def compile_source(self, src_path, out_path, extra_cflags=None):
        raise CUDANotInstalledError(
            'Runtime CUDA compilation is not built yet. Device code runs '
            'through XLA (XLACustomKernel.def_jax_kernel); for native CPU '
            'kernels use load_cpp_inline/load_cpp_file.'
        )


class HIPBackend(CompilerBackend):
    """API-parity stub: HIP/ROCm compilation is a GPU-only capability."""

    def compile_source(self, src_path, out_path, extra_cflags=None):
        raise CUDANotInstalledError(
            'HIP/ROCm compilation is not available; see CUDABackend for '
            'the supported routes.'
        )
