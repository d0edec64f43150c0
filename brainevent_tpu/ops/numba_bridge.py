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

"""Python/Numba CPU kernel bridge
(reference ``brainevent/_op/numba_ffi.py`` / ``numba_cuda_ffi.py``).

Two routes onto the CPU:

- :func:`fnptr_kernel` — a **registered XLA-FFI target**: one compiled C++
  trampoline handler receives the kernel's function-pointer address as an
  ``int64`` attribute and calls it with ``(void** inputs, void** outputs)``
  raw buffer pointers. No host round-trip through Python, real buffer
  donation via ``input_output_aliases``, and no callback lock — this is
  the counterpart of the reference's ctypes mirror of the XLA
  custom-call ABI (``numba_ffi.py``). Numba users obtain the address from
  ``numba.cfunc`` (:func:`numba_cfunc_address` builds the wrapper);
  native users take any ``extern "C"`` symbol with the same ABI.
- :func:`numba_kernel` — the convenience wrapper for the reference's
  Numba calling convention (``kernel(*inputs, *outputs)`` mutating the
  outputs). With Numba installed and ``ins=`` specs provided it lowers
  through the FFI trampoline; otherwise it runs through
  ``jax.pure_callback`` (njit-compiled when Numba is present).

``numba_cuda_kernel`` / ``numba_cuda_callable`` are GPU-only capabilities
kept as parity stubs.
"""

from typing import Callable, Optional

import jax
import numpy as np

from .._error import CUDANotInstalledError
from .util import abstract_arguments

__all__ = ['numba_kernel', 'fnptr_kernel', 'numba_cfunc_address',
           'ctypes_cfunc_address',
           'numba_cuda_kernel', 'numba_cuda_callable']


def _maybe_njit(fn: Callable) -> Callable:
    try:
        import numba
        return numba.njit(fn)
    except ImportError:
        return fn


# --------------------------------------------------------------------------
# Registered-FFI route: a single variadic C++ trampoline handler
# --------------------------------------------------------------------------

# The kernel ABI (shared with numba.cfunc wrappers and extern "C" symbols):
#     void kernel(void** inputs, void** outputs);
# Buffer shapes/dtypes are the registration-time contract (the wrapper
# bakes them; C kernels receive dynamic extents as scalar inputs).
_TRAMPOLINE_SRC = r'''
#include <cstdint>
#include <vector>

#include "xla/ffi/api/ffi.h"

static xla::ffi::Error be_fnptr_impl(int64_t fn,
                                     xla::ffi::RemainingArgs args,
                                     xla::ffi::RemainingRets rets) {
  std::vector<void*> ins(args.size());
  std::vector<void*> outs(rets.size());
  for (size_t i = 0; i < args.size(); ++i) {
    auto buf = args.get<xla::ffi::AnyBuffer>(i);
    if (!buf.has_value()) return buf.error();
    ins[i] = buf->untyped_data();
  }
  for (size_t i = 0; i < rets.size(); ++i) {
    auto buf = rets.get<xla::ffi::AnyBuffer>(i);
    if (!buf.has_value()) return buf.error();
    outs[i] = (*buf)->untyped_data();
  }
  reinterpret_cast<void (*)(void**, void**)>(
      static_cast<intptr_t>(fn))(ins.data(), outs.data());
  return xla::ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    be_handler_fnptr, be_fnptr_impl,
    xla::ffi::Ffi::Bind()
        .Attr<int64_t>("fn")
        .RemainingArgs()
        .RemainingRets());

extern "C" XLA_FFI_Handler* be_get_fnptr() { return be_handler_fnptr; }
'''

_trampoline = None


def _trampoline_target() -> str:
    """Compile (cached) + register the trampoline; return its target name."""
    global _trampoline
    if _trampoline is None:
        from .cpp.cache import CompilationCache
        from .cpp.compiler import CPPBackend
        from .cpp.runtime import CompiledModule
        from .cpp.toolchain import detect_cpp_toolchain

        toolchain = detect_cpp_toolchain()
        cache = CompilationCache('be_bridge', _TRAMPOLINE_SRC,
                                 f'{toolchain.cxx}:{toolchain.version}')
        so_path = cache.lookup()
        if so_path is None:
            src_path = cache.store_source(_TRAMPOLINE_SRC)
            so_path = CPPBackend(toolchain).compile_source(
                src_path, cache.so_path, None)
        _trampoline = CompiledModule('be_bridge', so_path, ['fnptr'],
                                     cache.key)
    return _trampoline.targets[0]


def fnptr_kernel(address: int, outs, *, input_output_aliases=None,
                 vmap_method: Optional[str] = None,
                 has_side_effect: bool = False) -> Callable:
    """Wrap a raw CPU function pointer as a registered XLA-FFI kernel.

    ``address`` must point to a function with the C ABI
    ``void kernel(void** inputs, void** outputs)`` that writes every
    output buffer (``numba.cfunc`` wrappers — see
    :func:`numba_cfunc_address` — or any ``extern "C"`` symbol, e.g. from
    :func:`brainevent_tpu.load_cpp_inline`'s module ``.so``). Unlike
    :func:`numba_kernel`'s callback route this lowers to a single XLA
    custom call on the registered trampoline target: no Python in the hot
    path, and ``input_output_aliases={in_idx: out_idx}`` donates the input
    buffer so the kernel updates it in place (the reference FFI path's
    aliasing semantics, ``brainevent/_op/numba_ffi.py``).

    The executable caches by call signature, so a given wrapped kernel
    must be called with a fixed set of shapes per ``address`` — shapes are
    part of the kernel's contract, exactly as in the reference's
    registration-time specialization. Dynamic extents should be passed as
    scalar inputs (they arrive as 0-d buffers).

    .. warning:: the address is executed as native code; callers are
       responsible for its validity and ABI.
    """
    out_specs = abstract_arguments(outs)
    aliases = dict(input_output_aliases or {})
    target = _trampoline_target()
    result_types = tuple(jax.ShapeDtypeStruct(s.shape, s.dtype)
                         for s in out_specs)

    def call(*args):
        fn = jax.ffi.ffi_call(
            target, result_types,
            input_output_aliases=aliases,
            has_side_effect=has_side_effect,
            **({'vmap_method': vmap_method} if vmap_method else {}))
        return fn(*args, fn=np.int64(address))

    return call


def numba_cfunc_address(kernel: Callable, ins, outs):
    """Compile ``kernel(*inputs, *outputs)`` to a ``numba.cfunc`` with the
    trampoline ABI; returns ``(cfunc, address)``.

    ``ins``/``outs`` fix the buffer shapes/dtypes (the generated wrapper
    views each ``void*`` through ``numba.carray`` with these static
    specs). Keep a reference to the returned ``cfunc`` alive for as long
    as the address is in use. Requires Numba.
    """
    import numba
    from numba import types, carray

    in_specs = abstract_arguments(ins)
    out_specs = abstract_arguments(outs)
    compiled = numba.njit(kernel)
    in_meta = tuple((tuple(s.shape), np.dtype(s.dtype)) for s in in_specs)
    out_meta = tuple((tuple(s.shape), np.dtype(s.dtype)) for s in out_specs)

    # address -> void* inside nopython code
    from numba.core import cgutils
    from numba.extending import intrinsic

    @intrinsic
    def _as_voidptr(typingctx, src):
        sig = types.voidptr(types.int64)

        def codegen(context, builder, signature, args):
            return builder.inttoptr(args[0], cgutils.voidptr_t)

        return sig, codegen

    n_in, n_out = len(in_meta), len(out_meta)
    src_lines = ['def _wrapper(in_ptrs, out_ptrs):']
    for i, (shape, dtype) in enumerate(in_meta):
        src_lines.append(
            f'    a{i} = carray(_as_voidptr(in_ptrs[{i}]), '
            f'{shape or (1,)}, dtype=np.{dtype.name})')
    for i, (shape, dtype) in enumerate(out_meta):
        src_lines.append(
            f'    o{i} = carray(_as_voidptr(out_ptrs[{i}]), '
            f'{shape or (1,)}, dtype=np.{dtype.name})')
    args = ', '.join([f'a{i}' for i in range(n_in)]
                     + [f'o{i}' for i in range(n_out)])
    src_lines.append(f'    compiled({args})')
    namespace = {'carray': carray, '_as_voidptr': _as_voidptr,
                 'np': np, 'compiled': compiled}
    exec('\n'.join(src_lines), namespace)  # noqa: S102 - static codegen
    sig = types.void(types.CPointer(types.int64),
                     types.CPointer(types.int64))
    wrapper = numba.cfunc(sig, nopython=True)(namespace['_wrapper'])
    return wrapper, wrapper.address


def ctypes_cfunc_address(kernel: Callable, ins, outs):
    """Numba-free stand-in for :func:`numba_cfunc_address`: wrap
    ``kernel(*inputs, *outputs)`` behind a REAL native function pointer
    built by ``ctypes.CFUNCTYPE`` with the trampoline ABI
    (``void (*)(void**, void**)``); returns ``(callback, address)``.

    The pointer is genuine native code (a ctypes closure thunk), so the
    registered FFI trampoline's pointer-calling path — XLA custom call →
    C++ handler → indirect call with raw buffer pointers, including true
    ``input_output_aliases`` donation — executes exactly as it does for a
    ``numba.cfunc``; only the final hop re-enters Python. That makes it
    the honest test double for environments without Numba (this image's
    CI), and a functional fallback for users who want FFI aliasing
    semantics without Numba. Keep the returned ``callback`` alive for as
    long as the address is in use.
    """
    import ctypes

    in_specs = abstract_arguments(ins)
    out_specs = abstract_arguments(outs)
    in_meta = tuple((tuple(s.shape), np.dtype(s.dtype)) for s in in_specs)
    out_meta = tuple((tuple(s.shape), np.dtype(s.dtype)) for s in out_specs)

    def _view(ptr, shape, dtype):
        n = int(np.prod(shape)) if shape else 1
        ctype = ctypes.POINTER(ctypes.c_char * (n * dtype.itemsize))
        raw = ctypes.cast(ptr, ctype).contents
        return np.frombuffer(raw, dtype=dtype).reshape(shape)

    cb_t = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_void_p))

    def _thunk(in_ptrs, out_ptrs):
        args = [_view(in_ptrs[i], shape, dtype)
                for i, (shape, dtype) in enumerate(in_meta)]
        outs_ = [_view(out_ptrs[i], shape, dtype)
                 for i, (shape, dtype) in enumerate(out_meta)]
        kernel(*args, *outs_)

    callback = cb_t(_thunk)
    address = ctypes.cast(callback, ctypes.c_void_p).value
    return callback, address


def numba_kernel(kernel: Callable, outs, *,
                 input_output_aliases=None, ins=None,
                 via: str = 'auto') -> Callable:
    """Wrap an in-place CPU kernel as a JAX-callable function.

    Parameters
    ----------
    kernel : Callable
        ``kernel(*inputs, *outputs)`` writing results into the output
        arrays (the reference's Numba kernel convention,
        ``brainevent/_op/numba_ffi.py:997``).
    outs
        Output spec(s) (``ShapeDtypeStruct``-like or a sequence).
    input_output_aliases : dict, optional
        ``{input_index: output_index}`` pairs whose outputs start as copies
        of the aliased inputs (donation semantics of the reference's FFI
        path; emulated by initialization on the callback route, true
        buffer donation on the FFI route).
    ins : optional
        Input spec(s). When provided (and Numba is installed) the kernel
        compiles to a ``numba.cfunc`` and dispatches through the
        registered FFI trampoline (:func:`fnptr_kernel`) — no host
        callback. Shapes are then fixed at wrap time.
    via : {'auto', 'ffi', 'callback'}
        Route selection. ``'auto'`` picks the FFI route when possible
        (Numba present and ``ins`` given), else the callback. ``'ffi'``
        always dispatches through the registered FFI trampoline; without
        Numba it warns and wraps the Python kernel behind a real native
        pointer via :func:`ctypes_cfunc_address` (same dispatch +
        donation semantics, kernel body at Python speed).

    Returns
    -------
    Callable mapping the JAX array inputs to a tuple of outputs.
    """
    if via not in ('auto', 'ffi', 'callback'):
        raise ValueError(f"via must be 'auto', 'ffi' or 'callback', "
                         f"got {via!r}")
    if via in ('auto', 'ffi'):
        have_numba = True
        try:
            import numba  # noqa: F401
        except ImportError:
            have_numba = False
        if via == 'ffi' and ins is None:
            raise ValueError(
                "numba_kernel(via='ffi') needs ins= specs: the FFI route "
                "bakes buffer shapes into the compiled wrapper.")
        if ins is not None and (have_numba or via == 'ffi'):
            if have_numba:
                holder, address = numba_cfunc_address(kernel, ins, outs)
            else:
                # Explicit via='ffi' without Numba: the ctypes cfunc
                # stand-in keeps the registered-FFI dispatch + true
                # buffer donation, at Python-callback speed for the
                # kernel body itself.
                import warnings
                warnings.warn(
                    "numba_kernel(via='ffi'): Numba is not installed; "
                    "using the ctypes cfunc stand-in (FFI dispatch and "
                    "aliasing semantics preserved, kernel body runs as "
                    "Python). Install numba for compiled-speed kernels.",
                    stacklevel=2)
                holder, address = ctypes_cfunc_address(kernel, ins, outs)
            wrapped = fnptr_kernel(
                address, outs, input_output_aliases=input_output_aliases)

            def call_ffi(*args):
                return wrapped(*args)

            call_ffi._keepalive = holder   # the cfunc owns the address
            return call_ffi

    out_specs = abstract_arguments(outs)
    compiled = _maybe_njit(kernel)
    aliases = dict(input_output_aliases or {})

    def host_fn(*np_inputs):
        outputs = []
        for i, spec in enumerate(out_specs):
            src = None
            for in_idx, out_idx in aliases.items():
                if out_idx == i:
                    src = np.array(np_inputs[in_idx], copy=True)
            outputs.append(
                src if src is not None
                else np.zeros(spec.shape, dtype=spec.dtype))
        compiled(*[np.asarray(x) for x in np_inputs], *outputs)
        return tuple(outputs)

    def call(*args):
        return jax.pure_callback(
            host_fn, tuple(jax.ShapeDtypeStruct(s.shape, s.dtype)
                           for s in out_specs),
            *args, vmap_method='sequential')

    return call


_CUDA_MSG = (
    '{fn} requires numba.cuda, which this package does not use. Device '
    'code runs through XLA (XLACustomKernel.def_jax_kernel).'
)


def numba_cuda_kernel(*args, **kwargs):
    """API-parity stub (reference ``brainevent/_op/numba_cuda_ffi.py:831``)."""
    raise CUDANotInstalledError(_CUDA_MSG.format(fn='numba_cuda_kernel'))


def numba_cuda_callable(*args, **kwargs):
    """API-parity stub (reference ``brainevent/_op/numba_cuda_ffi.py:1411``)."""
    raise CUDANotInstalledError(_CUDA_MSG.format(fn='numba_cuda_callable'))
