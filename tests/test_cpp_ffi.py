# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Native C++ XLA-FFI pipeline tests (mirrors reference
``brainevent/_op/kernix_*_test.py``): codegen parsing, compile-or-cache,
load, register, and end-to-end execution through ``jax.ffi.ffi_call``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brainevent_tpu as be
from brainevent_tpu.ops.cpp import (
    load_cpp_inline, load_cuda_inline,
    parse_annotations, normalize_tokens,
    detect_cpp_toolchain, list_registered_targets,
    get_cache_dir, set_cache_dir,
)
from brainevent_tpu.ops.cpp.codegen import parse_arg_spec
from brainevent_tpu._error import (
    CompilationError, CUDANotInstalledError, KernelCompilationError,
)

SRC_SCALE = r'''
#include "brainevent/tensor.h"

// @BE scale_by_two
void scale_by_two(const BE::Tensor& x, BE::Tensor& out) {
  const float* in = x.data<float>();
  float* o = out.data<float>();
  for (int64_t i = 0; i < x.numel(); ++i) o[i] = in[i] * 2.0f;
}

// @BE add_vectors
void add_vectors(const BE::Tensor& a, const BE::Tensor& b, BE::Tensor& out) {
  for (int64_t i = 0; i < a.numel(); ++i)
    out.data<float>()[i] = a.data<float>()[i] + b.data<float>()[i];
}
'''


class TestCodegen:
    def test_parse_annotations(self):
        specs = parse_annotations(SRC_SCALE)
        assert [s.name for s in specs] == ['scale_by_two', 'add_vectors']
        assert specs[0].n_in == 1 and specs[0].n_out == 1
        assert specs[1].n_in == 2 and specs[1].n_out == 1

    def test_parse_arg_spec_scalars(self):
        args = parse_arg_spec(
            'const BE::Tensor& x, BE::Tensor& y, float alpha, int64_t n')
        assert [a[0] for a in args] == ['in', 'out', 'attr', 'attr']

    def test_bad_param_raises(self):
        with pytest.raises(KernelCompilationError, match='arg spec'):
            parse_arg_spec('std::vector<int> xs')

    def test_no_annotations_raises(self):
        with pytest.raises(KernelCompilationError, match='@BE'):
            parse_annotations('void f(const BE::Tensor& x) {}')

    def test_normalize_tokens(self):
        assert normalize_tokens('  const\n BE::Tensor &x ') == \
            'const BE::Tensor &x'


class TestToolchain:
    def test_detect(self):
        tc = detect_cpp_toolchain()
        assert tc.cxx and tc.xla_include


@pytest.fixture(scope='module')
def cache_tmpdir(tmp_path_factory):
    d = tmp_path_factory.mktemp('cpp_cache')
    old = get_cache_dir()
    set_cache_dir(str(d))
    yield d
    set_cache_dir(old)


class TestEndToEnd:
    def test_compile_load_execute(self, cache_tmpdir):
        mod = load_cpp_inline(SRC_SCALE, name='be_test_scale')
        assert 'be_test_scale.scale_by_two' in mod.targets
        assert 'be_test_scale.scale_by_two' in list_registered_targets()

        x = jnp.arange(8.0, dtype=jnp.float32)
        out = jax.ffi.ffi_call(
            'be_test_scale.scale_by_two',
            jax.ShapeDtypeStruct(x.shape, x.dtype))(x)
        np.testing.assert_allclose(np.asarray(out), np.arange(8.0) * 2)

    def test_two_inputs(self, cache_tmpdir):
        load_cpp_inline(SRC_SCALE, name='be_test_scale')
        a = jnp.ones(5, jnp.float32)
        b = jnp.arange(5.0, dtype=jnp.float32)
        out = jax.ffi.ffi_call(
            'be_test_scale.add_vectors',
            jax.ShapeDtypeStruct(a.shape, a.dtype))(a, b)
        np.testing.assert_allclose(np.asarray(out), np.arange(5.0) + 1)

    def test_under_jit(self, cache_tmpdir):
        load_cpp_inline(SRC_SCALE, name='be_test_scale')
        f = jax.jit(lambda x: jax.ffi.ffi_call(
            'be_test_scale.scale_by_two',
            jax.ShapeDtypeStruct(x.shape, x.dtype))(x))
        np.testing.assert_allclose(np.asarray(f(jnp.ones(4))), 2.0)

    def test_cache_hit(self, cache_tmpdir):
        import brainevent_tpu.ops.cpp.pipeline as pipe
        pipe._loaded_modules.pop('be_test_cache', None)
        m1 = load_cpp_inline(SRC_SCALE, name='be_test_cache')
        so = m1.so_path
        pipe._loaded_modules.pop('be_test_cache', None)
        m2 = load_cpp_inline(SRC_SCALE, name='be_test_cache')
        assert m2.so_path == so  # second load reuses the artifact

    def test_compile_error_message(self, cache_tmpdir):
        bad = '''
// @BE broken
void broken(const BE::Tensor& x, BE::Tensor& out) { this is not C++ }
'''
        with pytest.raises(CompilationError, match='stderr'):
            load_cpp_inline(bad, name='be_test_broken')

    def test_xla_custom_kernel_cpp_backend(self, cache_tmpdir):
        """cpp_ffi as a backend of an XLACustomKernel."""
        from brainevent_tpu.ops.core import XLACustomKernel

        prim = XLACustomKernel('test_cpp_backed_op')

        def cpp_gen(**params):
            load_cpp_inline(SRC_SCALE, name='be_test_scale')
            def kernel(x):
                return (jax.ffi.ffi_call(
                    'be_test_scale.scale_by_two',
                    params['outs'][0])(x),)
            return kernel

        prim.def_cpp_kernel(cpp_gen, asdefault=True)
        prim.def_jax_kernel(lambda **p: (lambda x: (x * 2,)))
        x = jnp.arange(6.0, dtype=jnp.float32)
        (out,) = prim(x, outs=[jax.ShapeDtypeStruct(x.shape, x.dtype)],
                      backend='cpp_ffi')
        np.testing.assert_allclose(np.asarray(out), np.arange(6.0) * 2)


class TestCudaParityStubs:
    def test_load_cuda_raises_with_guidance(self):
        with pytest.raises(CUDANotInstalledError, match='def_jax_kernel'):
            load_cuda_inline('__global__ void k() {}', name='x')

    def test_backend_stubs(self):
        from brainevent_tpu.ops.cpp import CUDABackend, HIPBackend
        with pytest.raises(CUDANotInstalledError):
            CUDABackend().compile_source('a', 'b')
        with pytest.raises(CUDANotInstalledError):
            HIPBackend().compile_source('a', 'b')


RAW_SRC = r'''
#include <cstdint>
#include "brainevent/tensor.h"

// @BE raw_dummy
void raw_dummy(const BE::Tensor& x, BE::Tensor& out) {
  out.data<float>()[0] = x.data<float>()[0];
}

// trampoline-ABI kernels: void(void** inputs, void** outputs), extents
// arrive as scalar (0-d) input buffers
extern "C" void raw_axpy(void** ins, void** outs) {
  const float* x = static_cast<const float*>(ins[0]);
  const float* y = static_cast<const float*>(ins[1]);
  int32_t n = *static_cast<const int32_t*>(ins[2]);
  float* o = static_cast<float*>(outs[0]);
  for (int32_t i = 0; i < n; ++i) o[i] = 2.0f * x[i] + y[i];
}

extern "C" void raw_inc_inplace(void** ins, void** outs) {
  int32_t n = *static_cast<const int32_t*>(ins[1]);
  float* o = static_cast<float*>(outs[0]);
  for (int32_t i = 0; i < n; ++i) o[i] += 1.0f;
}
'''


def _raw_symbol_address(mod, symbol):
    import ctypes
    fn = getattr(mod._lib, symbol)
    return ctypes.cast(fn, ctypes.c_void_p).value


class TestFnptrTrampoline:
    """Registered-FFI function-pointer route (numba_bridge.fnptr_kernel):
    the C++ trampoline handler calls an arbitrary (void**, void**) kernel
    with raw XLA buffers — the reference Numba-FFI path
    (``brainevent/_op/numba_ffi.py``) redesigned onto jax.ffi."""

    def test_fnptr_kernel_executes(self, cache_tmpdir):
        mod = load_cpp_inline(RAW_SRC, name='be_test_raw')
        addr = _raw_symbol_address(mod, 'raw_axpy')
        k = be.fnptr_kernel(addr, jax.ShapeDtypeStruct((8,), jnp.float32))
        x = jnp.arange(8.0, dtype=jnp.float32)
        y = jnp.ones(8, jnp.float32)
        (out,) = k(x, y, jnp.int32(8))
        np.testing.assert_allclose(np.asarray(out), 2 * np.arange(8.0) + 1)

    def test_fnptr_kernel_under_jit(self, cache_tmpdir):
        mod = load_cpp_inline(RAW_SRC, name='be_test_raw')
        addr = _raw_symbol_address(mod, 'raw_axpy')
        k = be.fnptr_kernel(addr, jax.ShapeDtypeStruct((5,), jnp.float32))

        @jax.jit
        def f(x, y):
            (out,) = k(x, y, jnp.int32(5))
            return out * 10.0

        x = jnp.arange(5.0, dtype=jnp.float32)
        out = f(x, jnp.zeros(5, jnp.float32))
        np.testing.assert_allclose(np.asarray(out), 20 * np.arange(5.0))

    def test_fnptr_input_output_alias_in_place(self, cache_tmpdir):
        # aliased output arrives holding the donated input's contents, so
        # an in-place increment kernel observes them (true buffer
        # donation — the semantic the pure_callback route can only
        # emulate by copy)
        mod = load_cpp_inline(RAW_SRC, name='be_test_raw')
        addr = _raw_symbol_address(mod, 'raw_inc_inplace')
        k = be.fnptr_kernel(addr, jax.ShapeDtypeStruct((4,), jnp.float32),
                            input_output_aliases={0: 0})
        x = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)
        (out,) = k(x, jnp.int32(4))
        np.testing.assert_allclose(np.asarray(out), [2.0, 3.0, 4.0, 5.0])

    def test_trampoline_target_registered_once(self, cache_tmpdir):
        from brainevent_tpu.ops.numba_bridge import _trampoline_target
        t1 = _trampoline_target()
        t2 = _trampoline_target()
        assert t1 == t2 == 'be_bridge.fnptr'
        assert t1 in list_registered_targets()

    def test_numba_kernel_via_validation(self):
        def kern(x, o):
            o[:] = x
        with pytest.raises(ValueError, match="via"):
            be.numba_kernel(kern, jax.ShapeDtypeStruct((3,), jnp.float32),
                            via='bogus')
        # via='ffi' without ins= is a contract error with or without Numba
        # (the ctypes cfunc stand-in removed the ImportError branch)
        with pytest.raises(ValueError, match='ins'):
            be.numba_kernel(
                kern, jax.ShapeDtypeStruct((3,), jnp.float32),
                via='ffi')

    def test_numba_kernel_ffi_route(self, cache_tmpdir):
        # Executes EVERYWHERE: with Numba the wrapper is a numba.cfunc;
        # without, the ctypes cfunc stand-in keeps the same registered-FFI
        # dispatch (and warns once).
        import warnings

        def kern(x, y, o):
            for i in range(o.shape[0]):
                o[i] = x[i] * y[i]
        spec = jax.ShapeDtypeStruct((6,), jnp.float32)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)
            k = be.numba_kernel(kern, spec, ins=(spec, spec), via='ffi')
        x = jnp.arange(6.0, dtype=jnp.float32)
        (out,) = k(x, x)
        np.testing.assert_allclose(np.asarray(out), np.arange(6.0) ** 2)

    def test_numba_kernel_ffi_route_under_jit(self, cache_tmpdir):
        import warnings

        def kern(x, o):
            for i in range(o.shape[0]):
                o[i] = 3.0 * x[i]
        spec = jax.ShapeDtypeStruct((4,), jnp.float32)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)
            k = be.numba_kernel(kern, spec, ins=spec, via='ffi')

        @jax.jit
        def f(x):
            (o,) = k(x)
            return o + 1.0

        np.testing.assert_allclose(np.asarray(f(jnp.arange(4.0))),
                                   3 * np.arange(4.0) + 1)

    def test_ctypes_cfunc_alias_donation(self, cache_tmpdir):
        # the stand-in must preserve TRUE input_output_aliases donation:
        # the aliased output buffer arrives holding the input's contents
        def kern(x, o):
            o += 1.0  # in-place increment of the DONATED buffer
        spec = jax.ShapeDtypeStruct((4,), jnp.float32)
        holder, addr = be.ctypes_cfunc_address(
            kern, ins=spec, outs=spec)
        k = be.fnptr_kernel(addr, spec, input_output_aliases={0: 0})
        x = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)
        (out,) = k(x)
        del holder
        np.testing.assert_allclose(np.asarray(out), [2.0, 3.0, 4.0, 5.0])

    def test_ctypes_cfunc_scalar_and_2d(self, cache_tmpdir):
        # 0-d scalar inputs + 2-D buffers through the raw-pointer views
        def kern(a, s, o):
            o[:] = a * s[()]
        a_spec = jax.ShapeDtypeStruct((2, 3), jnp.float32)
        s_spec = jax.ShapeDtypeStruct((), jnp.float32)
        holder, addr = be.ctypes_cfunc_address(
            kern, ins=(a_spec, s_spec), outs=a_spec)
        k = be.fnptr_kernel(addr, a_spec)
        a = jnp.arange(6.0, dtype=jnp.float32).reshape(2, 3)
        (out,) = k(a, jnp.float32(2.5))
        del holder
        np.testing.assert_allclose(np.asarray(out), 2.5 * np.arange(6.0).reshape(2, 3))
