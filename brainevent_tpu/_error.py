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

"""Exception taxonomy for brainevent-tpu.

Mirrors the reference error hierarchy (``brainevent/_error.py:43-405``,
20 classes) so downstream code that catches specific failure categories keeps
working.

Hierarchy::

    BrainEventError
    ├── MathError
    ├── UnsupportedOperationError
    ├── BenchmarkDataFnNotProvidedError
    └── KernelError
        ├── KernelNotAvailableError
        ├── KernelCompilationError
        │   └── CompilationError
        │       └── HostCompilerIncompatibleError
        ├── KernelFallbackExhaustedError
        ├── KernelExecutionError
        ├── CUDANotInstalledError
        ├── KernelToolchainError
        │   ├── NvccNotFoundError
        │   ├── HostCompilerNotFoundError
        │   ├── HeaderNotFoundError
        │   ├── GpuArchDetectionError
        │   └── UnsupportedArchError
        ├── KernelLoadError
        └── KernelRegistrationError
"""

__all__ = [
    'BrainEventError',
    'MathError',
    'UnsupportedOperationError',
    'KernelError',
    'KernelNotAvailableError',
    'KernelCompilationError',
    'CompilationError',
    'HostCompilerIncompatibleError',
    'KernelFallbackExhaustedError',
    'KernelExecutionError',
    'CUDANotInstalledError',
    'KernelToolchainError',
    'NvccNotFoundError',
    'HostCompilerNotFoundError',
    'HeaderNotFoundError',
    'GpuArchDetectionError',
    'UnsupportedArchError',
    'KernelLoadError',
    'KernelRegistrationError',
    'BenchmarkDataFnNotProvidedError',
]


class BrainEventError(Exception):
    """Base class for every error raised by brainevent-tpu."""


class MathError(BrainEventError):
    """Mathematically invalid operation (shape/dtype/value contract broken)."""


class UnsupportedOperationError(BrainEventError):
    """Operation not supported for the given operand types or layout."""


class BenchmarkDataFnNotProvidedError(BrainEventError):
    """``XLACustomKernel.benchmark`` called on a primitive that never
    registered benchmark data via ``def_benchmark_data``."""


class KernelError(BrainEventError):
    """Base class for kernel selection/compilation/execution failures."""


class KernelNotAvailableError(KernelError):
    """No kernel registered for the requested ``(platform, backend)``.

    The message lists the backends that *are* registered and how to switch
    (per-call ``backend=`` kwarg or ``config.set_backend``), mirroring the
    remediation style of the reference (``brainevent/_op/main.py:557-584``).
    """


class KernelCompilationError(KernelError):
    """A kernel failed to compile."""


class CompilationError(KernelCompilationError):
    """Native source compilation (g++/nvcc) returned a non-zero status."""


class HostCompilerIncompatibleError(CompilationError):
    """The detected host C++ compiler cannot build XLA FFI targets."""


class KernelFallbackExhaustedError(KernelError):
    """Every registered backend for a platform failed; lists each failure."""


class KernelExecutionError(KernelError):
    """A kernel compiled but failed at run time."""


class CUDANotInstalledError(KernelError):
    """A CUDA-only code path was requested on a machine without CUDA.

    brainevent-tpu keeps the reference's CUDA entry points
    (``load_cuda_inline`` etc., reference ``brainevent/_op/kernix_pipeline.py``)
    for API parity; they raise this error until the CUDA pipeline is built,
    with a pointer at the C++-FFI equivalents.
    """


class KernelToolchainError(KernelError):
    """Failure discovering or validating the native toolchain."""


class NvccNotFoundError(KernelToolchainError):
    """``nvcc`` not found (CUDA parity path only)."""


class HostCompilerNotFoundError(KernelToolchainError):
    """No usable host C++ compiler (g++/clang++) found."""


class HeaderNotFoundError(KernelToolchainError):
    """A required header (XLA FFI API headers) could not be located."""


class GpuArchDetectionError(KernelToolchainError):
    """GPU compute-capability detection failed (CUDA parity path only)."""


class UnsupportedArchError(KernelToolchainError):
    """The requested architecture is not supported by the toolchain."""


class KernelLoadError(KernelError):
    """A compiled shared library could not be loaded or is missing symbols.

    Messages carry an error code tag (e.g. ``E-LOAD-MISSING``) plus multi-line
    remediation, following reference ``brainevent/_op/kernix_runtime.py:31-50``.
    """


class KernelRegistrationError(KernelError):
    """FFI target name collision with different content, or invalid
    registration request (reference ``brainevent/_op/kernix_pipeline.py:198``)."""
