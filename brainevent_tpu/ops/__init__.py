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

"""Operator infrastructure: primitive dispatch, AD utilities, benchmarking,
event scatter-add, and the native C++ FFI pipeline."""

from .core import XLACustomKernel, KernelEntry
from .util import (
    defjvp,
    general_batching_rule,
    abstract_arguments,
    dtype_suffix,
    spike_suffix,
    jaxtype_to_warptype,
    jaxinfo_to_warpinfo,
)
from .benchmark import (
    BenchmarkConfig,
    BenchmarkRecord,
    BenchmarkResult,
    benchmark_function,
    gpu_device_info,
)
from .scatter import event_scatter_add, event_scatter_add_multi, masked_gather
from .numba_bridge import (numba_kernel, fnptr_kernel, numba_cfunc_address,
    ctypes_cfunc_address,
                           numba_cuda_kernel, numba_cuda_callable)

__all__ = [
    'XLACustomKernel', 'KernelEntry',
    'defjvp', 'general_batching_rule', 'abstract_arguments',
    'dtype_suffix', 'spike_suffix',
    'jaxtype_to_warptype', 'jaxinfo_to_warpinfo',
    'BenchmarkConfig', 'BenchmarkRecord', 'BenchmarkResult', 'benchmark_function',
    'gpu_device_info',
    'event_scatter_add', 'event_scatter_add_multi', 'masked_gather',
    'numba_kernel', 'fnptr_kernel', 'numba_cfunc_address',
    'ctypes_cfunc_address',
    'numba_cuda_kernel', 'numba_cuda_callable',
]
