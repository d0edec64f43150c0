# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Registering custom host kernels — the counterpart of the reference's
``examples/numba_cuda_example.py`` / ``numba_cuda_callable_example.py``
for native CPU kernels (C++ XLA-FFI or Numba-cfunc FFI).

Two routes:

  1. **C++ XLA-FFI** (``load_cpp_inline``): annotate exports with
     ``// @BE``, get content-hash-cached ``.so`` + registered FFI
     targets (the reference's kernix pipeline, ``kernix_pipeline.py``).
  2. **Numba cfunc FFI** (``numba_kernel(..., ins=...)``): an in-place
     ``kernel(*inputs, *outputs)`` CPU function compiled to a cfunc and
     dispatched through the registered FFI trampoline — no host
     callback (reference ``brainevent/_op/numba_ffi.py:997``).

A full multi-backend primitive registers a ``jax_raw`` kernel with
``XLACustomKernel.def_jax_kernel`` (see ``docs/howto/custom-operators.md``).

Run from the project root:
    python examples/custom_kernel.py
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax
import jax.numpy as jnp
import numpy as np


def demo_cpp_ffi():
    from brainevent_tpu.ops.cpp import load_cpp_inline

    load_cpp_inline(r'''
#include "brainevent/tensor.h"

// @BE leaky_relu
void leaky_relu(const BE::Tensor& x, BE::Tensor& out) {
  const float* in = x.data<float>();
  float* o = out.data<float>();
  for (int64_t i = 0; i < x.numel(); ++i)
    o[i] = in[i] > 0.0f ? in[i] : 0.01f * in[i];
}
''', name='example_ops')

    x = jnp.asarray([-2.0, -0.5, 0.0, 1.5], jnp.float32)
    with jax.default_device(jax.devices('cpu')[0]):
        y = jax.ffi.ffi_call(
            'example_ops.leaky_relu',
            jax.ShapeDtypeStruct(x.shape, x.dtype))(x)
    print('C++ FFI leaky_relu:', np.asarray(y))


def demo_numba_ffi():
    from brainevent_tpu.ops.numba_bridge import numba_kernel

    def ewma(x, alpha, out):          # in-place kernel convention
        acc = 0.0
        for i in range(x.shape[0]):
            acc = alpha[0] * x[i] + (1.0 - alpha[0]) * acc
            out[i] = acc

    spec = jax.ShapeDtypeStruct((6,), jnp.float32)
    alpha_spec = jax.ShapeDtypeStruct((1,), jnp.float32)
    fn = numba_kernel(ewma, spec, ins=(spec, alpha_spec))
    x = jnp.arange(6.0, dtype=jnp.float32)
    with jax.default_device(jax.devices('cpu')[0]):
        (y,) = fn(x, jnp.asarray([0.5], jnp.float32))
    print('Numba FFI ewma:    ', np.asarray(y))


if __name__ == '__main__':
    demo_cpp_ffi()
    demo_numba_ffi()
