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

"""brainevent-tpu: an event-driven sparse operator framework for spiking
neural networks, in JAX.

A ground-up JAX/XLA re-design with the capability surface of
chaobrain/brainevent v0.2.0: event representations, sparse data structures
(CSR/CSC/Dense/ELL/implicit-JIT connectivity), multi-backend custom
primitives with autodiff/vmap support, an LFSR RNG subsystem, a native C++
XLA-FFI pipeline for CPU custom kernels, a benchmark harness, and a CLI —
plus multi-device sharding of the EI network and the sparse products.
"""

from ._version import __version__, __version_info__

from . import _deprecation
from . import config

from ._error import (
    BrainEventError,
    MathError,
    UnsupportedOperationError,
    KernelError,
    KernelNotAvailableError,
    KernelCompilationError,
    KernelFallbackExhaustedError,
    KernelExecutionError,
    KernelToolchainError,
    CompilationError,
    KernelRegistrationError,
    BenchmarkDataFnNotProvidedError,
    CUDANotInstalledError,
    NvccNotFoundError,
    HostCompilerNotFoundError,
    HeaderNotFoundError,
    GpuArchDetectionError,
    HostCompilerIncompatibleError,
    UnsupportedArchError,
    KernelLoadError,
)
from ._registry import (
    get_registry, get_primitives_by_tags, get_all_primitive_names,
)
from ._data import DataRepresentation, JITCMatrix
from .csr import (
    CSR, CSC,
    binary_csrmv, binary_csrmv_p,
    binary_csrmv_indexed, binary_csrmv_indexed_p,
    binary_csrmm, binary_csrmm_p,
    binary_csrmm_indexed, binary_csrmm_indexed_p,
    csrmv, csrmv_p,
    csrmm, csrmm_p,
    csrmv_dt2t, cscmv_dt2t, csrmv_dt2t_p,
    csrmm_dt2t, cscmm_dt2t, csrmm_dt2t_p,
    update_csr_on_binary_pre, update_csr_on_binary_pre_p,
    update_csr_on_binary_post, update_csr_on_binary_post_p,
    update_csc_on_binary_pre, update_csc_on_binary_post,
    csr_slice_rows, csr_slice_rows_p,
)
from ._misc import (
    csr_to_coo_index, coo_to_csc_index, csr_to_csc_index, csc_to_csr_index,
    coo2csr,
)
from ._sddmm import sddmm_indices, sddmm_coo_indices, sddmm_bcoo
from .events import (
    EventRepresentation,
    BinaryArray,
    BitPackedBinary,
    bitpack,
    CompactBinary,
    binary_1d_array_index_p,
    binary_2d_compact_only_p,
    binary_2d_array_index_p,
    binary_2d_pair_stream_encode_p,
    binary_2d_row_sparse_encode_p,
    binary_2d_csr_row_count_p,
    binary_2d_csr_fill_p,
    binary_2d_csc_encode_p,
)
from .dense import (
    Dense,
    binary_densemv, binary_densemv_p,
    binary_densemm, binary_densemm_p,
    update_dense_on_binary_pre, update_dense_on_binary_pre_p,
    update_dense_on_binary_post, update_dense_on_binary_post_p,
)
from .fcn import (
    FixedNumConn, FixedNumPerPost, FixedNumPerPre,
    binary_fcnmv, binary_fcnmv_p,
    binary_fcnmm, binary_fcnmm_p,
    fcnmv, fcnmm, fcnmv_dt2t, fcnmm_dt2t,
    update_fixed_post_conn_on_binary_pre,
    update_fixed_pre_conn_on_binary_post,
    fcn_plasticity_row_p,
)
from .rng import (
    PallasLFSR88RNG, PallasLFSR113RNG, PallasLFSR128RNG,
    PallasLFSRRNG, get_pallas_lfsr_rng_class,
)
from .jitc import (
    JITCScalarMatrix, JITCScalarR, JITCScalarC,
    jits, jits_p, jitsmv, jitsmv_p, jitsmm, jitsmm_p,
    binary_jitsmv, binary_jitsmv_p, binary_jitsmm, binary_jitsmm_p,
    jits_csr_count_p, jits_csr_fill_p, jits_to_csr, jitsmv_dt2t, jitsmv_dt2t_p,
    jitsmv_plan, jitsmv_plan_p, jitsmm_plan, jitsmm_plan_p,
    JITCNormalMatrix, JITCNormalR, JITCNormalC,
    jitn, jitn_p, jitnmv, jitnmv_p, jitnmm, jitnmm_p,
    binary_jitnmv, binary_jitnmv_p, binary_jitnmm, binary_jitnmm_p,
    jitn_csr_count_p, jitn_csr_fill_p, jitn_to_csr, jitnmv_dt2t, jitnmv_dt2t_p,
    jitnmv_plan, jitnmv_plan_p, jitnmm_plan, jitnmm_plan_p,
    JITCUniformMatrix, JITCUniformR, JITCUniformC,
    jitu, jitu_p, jitumv, jitumv_p, jitumm, jitumm_p,
    binary_jitumv, binary_jitumv_p, binary_jitumm, binary_jitumm_p,
    jitu_csr_count_p, jitu_csr_fill_p, jitu_to_csr, jitumv_dt2t, jitumv_dt2t_p,
    jitumv_plan, jitumv_plan_p, jitumm_plan, jitumm_plan_p,
)
from .ops import (
    XLACustomKernel, KernelEntry,
    BenchmarkConfig, BenchmarkRecord, BenchmarkResult, benchmark_function,
    defjvp, general_batching_rule,
    jaxtype_to_warptype, jaxinfo_to_warpinfo,
    numba_kernel, fnptr_kernel, numba_cfunc_address,
    ctypes_cfunc_address,
    numba_cuda_kernel, numba_cuda_callable,
)
from .ops.cpp import (
    load_cpp_inline, load_cpp_file,
    load_cuda_inline, load_cuda_file, load_cuda_dir,
    set_cache_dir, get_cache_dir, clear_cache, print_diagnostics,
    CompiledModule, register_ffi_target, list_registered_targets,
    normalize_tokens,
    CompilerBackend, CPPBackend, CUDABackend, HIPBackend,
)

# attach benchmark-data generators to the registry rows that do not define
# one next to their primitive (CLI full-registry sweeps + backend tests)
from ._benchdata import install_benchmark_data as _install_benchmark_data
from ._registry import _REGISTRY as _reg_map
_install_benchmark_data(_reg_map)
del _install_benchmark_data, _reg_map

__all__ = [
    '__version__',
    'config',
    # events
    'EventRepresentation', 'BinaryArray', 'BitPackedBinary', 'bitpack',
    'CompactBinary',
    'binary_1d_array_index_p', 'binary_2d_compact_only_p',
    'binary_2d_array_index_p', 'binary_2d_pair_stream_encode_p',
    'binary_2d_row_sparse_encode_p', 'binary_2d_csr_row_count_p',
    'binary_2d_csr_fill_p', 'binary_2d_csc_encode_p',
    # data bases
    'DataRepresentation', 'JITCMatrix',
    # CSR/CSC
    'CSR', 'CSC',
    'binary_csrmv', 'binary_csrmv_p',
    'binary_csrmv_indexed', 'binary_csrmv_indexed_p',
    'binary_csrmm', 'binary_csrmm_p',
    'binary_csrmm_indexed', 'binary_csrmm_indexed_p',
    'csrmv', 'csrmv_p', 'csrmm', 'csrmm_p',
    'csrmv_dt2t', 'cscmv_dt2t', 'csrmv_dt2t_p',
    'csrmm_dt2t', 'cscmm_dt2t', 'csrmm_dt2t_p',
    'update_csr_on_binary_pre', 'update_csr_on_binary_pre_p',
    'update_csr_on_binary_post', 'update_csr_on_binary_post_p',
    'update_csc_on_binary_pre', 'update_csc_on_binary_post',
    'csr_slice_rows', 'csr_slice_rows_p',
    # dense
    'Dense',
    'binary_densemv', 'binary_densemv_p',
    'binary_densemm', 'binary_densemm_p',
    'update_dense_on_binary_pre', 'update_dense_on_binary_pre_p',
    'update_dense_on_binary_post', 'update_dense_on_binary_post_p',
    # JIT connectivity
    'JITCScalarMatrix', 'JITCScalarR', 'JITCScalarC',
    'jits', 'jits_p', 'jitsmv', 'jitsmv_p', 'jitsmm', 'jitsmm_p',
    'binary_jitsmv', 'binary_jitsmv_p', 'binary_jitsmm', 'binary_jitsmm_p',
    'jits_csr_count_p', 'jits_csr_fill_p', 'jits_to_csr', 'jitsmv_dt2t', 'jitsmv_dt2t_p',
    'jitsmv_plan', 'jitsmv_plan_p', 'jitsmm_plan', 'jitsmm_plan_p',
    'JITCNormalMatrix', 'JITCNormalR', 'JITCNormalC',
    'jitn', 'jitn_p', 'jitnmv', 'jitnmv_p', 'jitnmm', 'jitnmm_p',
    'binary_jitnmv', 'binary_jitnmv_p', 'binary_jitnmm', 'binary_jitnmm_p',
    'jitn_csr_count_p', 'jitn_csr_fill_p', 'jitn_to_csr', 'jitnmv_dt2t', 'jitnmv_dt2t_p',
    'jitnmv_plan', 'jitnmv_plan_p', 'jitnmm_plan', 'jitnmm_plan_p',
    'JITCUniformMatrix', 'JITCUniformR', 'JITCUniformC',
    'jitu', 'jitu_p', 'jitumv', 'jitumv_p', 'jitumm', 'jitumm_p',
    'binary_jitumv', 'binary_jitumv_p', 'binary_jitumm', 'binary_jitumm_p',
    'jitu_csr_count_p', 'jitu_csr_fill_p', 'jitu_to_csr', 'jitumv_dt2t', 'jitumv_dt2t_p',
    'jitumv_plan', 'jitumv_plan_p', 'jitumm_plan', 'jitumm_plan_p',
    # fcn
    'FixedNumConn', 'FixedNumPerPost', 'FixedNumPerPre',
    'binary_fcnmv', 'binary_fcnmv_p',
    'binary_fcnmm', 'binary_fcnmm_p',
    'fcnmv', 'fcnmm', 'fcnmv_dt2t', 'fcnmm_dt2t',
    'update_fixed_post_conn_on_binary_pre',
    'update_fixed_pre_conn_on_binary_post',
    'fcn_plasticity_row_p',
    # rng
    'PallasLFSR88RNG', 'PallasLFSR113RNG', 'PallasLFSR128RNG',
    'PallasLFSRRNG', 'get_pallas_lfsr_rng_class',
    # conversions & sddmm
    'csr_to_coo_index', 'coo_to_csc_index', 'csr_to_csc_index',
    'csc_to_csr_index', 'coo2csr',
    'sddmm_indices', 'sddmm_coo_indices', 'sddmm_bcoo',
    # errors
    'BrainEventError', 'MathError', 'UnsupportedOperationError',
    'KernelError', 'KernelNotAvailableError', 'KernelCompilationError',
    'KernelFallbackExhaustedError', 'KernelExecutionError',
    'KernelToolchainError', 'CompilationError',
    'KernelRegistrationError', 'BenchmarkDataFnNotProvidedError',
    'CUDANotInstalledError', 'NvccNotFoundError', 'HostCompilerNotFoundError',
    'HeaderNotFoundError', 'GpuArchDetectionError',
    'HostCompilerIncompatibleError', 'UnsupportedArchError', 'KernelLoadError',
    # registry
    'get_registry', 'get_primitives_by_tags', 'get_all_primitive_names',
    # native compilation API
    'load_cpp_inline', 'load_cpp_file',
    'load_cuda_inline', 'load_cuda_file', 'load_cuda_dir',
    'set_cache_dir', 'get_cache_dir', 'clear_cache', 'print_diagnostics',
    'CompiledModule', 'register_ffi_target', 'list_registered_targets',
    'normalize_tokens',
    'CompilerBackend', 'CPPBackend', 'CUDABackend', 'HIPBackend',
    # op infra
    'XLACustomKernel', 'KernelEntry',
    'BenchmarkConfig', 'BenchmarkRecord', 'BenchmarkResult', 'benchmark_function',
    'defjvp', 'general_batching_rule',
    'jaxtype_to_warptype', 'jaxinfo_to_warpinfo',
    'numba_kernel', 'fnptr_kernel', 'numba_cfunc_address',
    'ctypes_cfunc_address',
    'numba_cuda_kernel', 'numba_cuda_callable',
]


# ---------------------------------------------------------------------------
# Backward-compatibility shim for public names retired in the reference
# between v0.0.7 and v0.1.0 (PEP 562 hooks; see _deprecation.py).
# ---------------------------------------------------------------------------

def __getattr__(name):
    """Resolve retired public names (PEP 562 module-level hook)."""
    return _deprecation.resolve(name, globals())


def __dir__():
    return _deprecation.public_dir(globals())
