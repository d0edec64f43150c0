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

"""AD, batching, and naming utilities for custom primitives.

Capability parity with reference ``brainevent/_op/util.py``: multi-result JVP
registration (``defjvp``), the generic loop/stack vmap fallback
(``general_batching_rule``), output-spec normalization
(``abstract_arguments``), and dtype suffix helpers used for kernel-name
mangling — re-implemented for a JAX stack.
"""

import functools
from typing import Any, Callable, Optional, Protocol, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .._compat import Primitive, ShapedArray, ad

__all__ = [
    'defjvp',
    'general_batching_rule',
    'abstract_arguments',
    'dtype_suffix',
    'spike_suffix',
    'ShapeDtype',
    'jaxtype_to_warptype',
    'jaxinfo_to_warpinfo',
]


class ShapeDtype(Protocol):
    """Anything with ``.shape`` and ``.dtype`` (reference ``_op/util.py:577``)."""

    @property
    def shape(self) -> Tuple[int, ...]:
        ...

    @property
    def dtype(self) -> np.dtype:
        ...


def abstract_arguments(outs) -> Tuple[jax.ShapeDtypeStruct, ...]:
    """Normalize an output spec into a hashable tuple of ``ShapeDtypeStruct``.

    Accepts a single spec or a sequence of specs; every spec only needs
    ``.shape`` and ``.dtype`` (reference ``brainevent/_op/util.py:648``).
    """
    if isinstance(outs, (jax.ShapeDtypeStruct, ShapedArray)) or hasattr(outs, 'shape'):
        outs = [outs]
    return tuple(
        jax.ShapeDtypeStruct(tuple(o.shape), jnp.dtype(o.dtype)) for o in outs
    )


# ----------------------------------------------------------------------------
# Multi-result JVP (reference brainevent/_op/util.py:220).
# ----------------------------------------------------------------------------

def defjvp(primitive: Union[Primitive, Any], *jvp_rules: Optional[Callable]) -> None:
    """Register per-operand JVP rules for a multiple-results primitive.

    ``jax.interpreters.ad.defjvp`` assumes a single result;  this version
    supports ``multiple_results=True`` primitives. Each rule in *jvp_rules*
    corresponds to one positional operand and has signature::

        rule(operand_tangent, *primals, **params) -> Sequence[output_tangents]

    A rule of ``None`` marks the operand as non-differentiable (its tangent
    must be symbolically zero at trace time, else an error is raised).
    """
    if hasattr(primitive, 'primitive'):  # XLACustomKernel passthrough
        primitive = primitive.primitive
    assert isinstance(primitive, Primitive), f'Expected a Primitive, got {primitive}'
    assert primitive.multiple_results, 'defjvp is for multiple-results primitives.'
    ad.primitive_jvps[primitive] = functools.partial(_standard_jvp, jvp_rules, primitive)


def _standard_jvp(jvp_rules, primitive: Primitive, primals, tangents, **params):
    val_out = tuple(primitive.bind(*primals, **params))
    tangents_out = []
    for rule, tangent in zip(jvp_rules, tangents):
        if type(tangent) is ad.Zero:
            continue
        if rule is None:
            raise NotImplementedError(
                f'JVP for operand of {primitive.name} is not implemented '
                f'(got a non-zero tangent for a non-differentiable operand).'
            )
        tangents_out.append(tuple(rule(tangent, *primals, **params)))
    if len(tangents_out) == 0:
        return val_out, tuple(ad.Zero.from_primal_value(v) for v in val_out)
    summed = tangents_out[0]
    for extra in tangents_out[1:]:
        summed = tuple(jnp.add(a, b) for a, b in zip(summed, extra))
    # Pad with symbolic zeros if a rule only returns tangents for a prefix of
    # the outputs (e.g. workspace pass-through outputs).
    if len(summed) < len(val_out):
        summed = tuple(summed) + tuple(
            ad.Zero.from_primal_value(v) for v in val_out[len(summed):]
        )
    return val_out, summed


# ----------------------------------------------------------------------------
# Generic batching fallback (reference brainevent/_op/util.py:458).
# ----------------------------------------------------------------------------

def general_batching_rule(prim, args, axes, **kwargs):
    """Loop-based vmap fallback for any custom primitive.

    Moves every batched operand's batch axis to the front, broadcasts
    non-batched operands, and scans the primitive over the batch with
    ``jax.lax.scan``. Works for any primitive at the cost of serializing the
    batch — hand-written batching rules (e.g. rerouting mv to mm) should be
    preferred on hot paths.
    """
    if hasattr(prim, 'primitive'):
        prim = prim.primitive
    batch_axes, batch_args, non_batch_args = [], {}, {}
    sizes = set()
    for i, (arg, axis) in enumerate(zip(args, axes)):
        if axis is None:
            non_batch_args[f'ax{i}'] = arg
        else:
            batch_args[f'ax{i}'] = jnp.moveaxis(arg, axis, 0) if axis != 0 else arg
            sizes.add(batch_args[f'ax{i}'].shape[0])
        batch_axes.append(axis)
    if len(sizes) != 1:
        raise ValueError(
            f'Inconsistent batch sizes {sizes} for primitive {prim.name}.'
        )

    def _body(_, x):
        pars = tuple(
            x[f'ax{i}'] if f'ax{i}' in x else non_batch_args[f'ax{i}']
            for i in range(len(args))
        )
        return 0, prim.bind(*pars, **kwargs)

    _, outs = jax.lax.scan(_body, 0, batch_args)
    return outs, tuple(0 for _ in outs)


# ----------------------------------------------------------------------------
# dtype suffix helpers for kernel-name mangling
# (reference brainevent/_op/util.py:56,103).
# ----------------------------------------------------------------------------

_DTYPE_SUFFIXES = {
    np.dtype('float16'): '_f16',
    np.dtype(jnp.bfloat16): '_bf16',
    np.dtype('float32'): '_f32',
    np.dtype('float64'): '_f64',
    np.dtype('int8'): '_i8',
    np.dtype('int16'): '_i16',
    np.dtype('int32'): '_i32',
    np.dtype('int64'): '_i64',
    np.dtype('uint8'): '_u8',
    np.dtype('uint16'): '_u16',
    np.dtype('uint32'): '_u32',
    np.dtype('uint64'): '_u64',
    np.dtype('bool'): '_bool',
}


def dtype_suffix(dtype) -> str:
    """Return the kernel-name suffix for *dtype* (e.g. ``'_f32'``)."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.bfloat16:
        return '_bf16'
    try:
        return _DTYPE_SUFFIXES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f'No kernel-name suffix for dtype {dtype}.') from None


def spike_suffix(dtype) -> str:
    """Return the event-dtype suffix: ``'_bool'`` for booleans else float suffix."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.bool_:
        return '_bool'
    return dtype_suffix(dtype)


# ----------------------------------------------------------------------------
# NVIDIA Warp interop (API parity; requires the optional `warp-lang` package,
# reference brainevent/_op/util.py:695,799).
# ----------------------------------------------------------------------------

def _import_warp():
    try:
        import warp  # type: ignore
        return warp
    except ImportError:
        raise ImportError(
            'NVIDIA Warp is not installed. The warp backend is a GPU-only '
            'integration kept for API parity; the jax_raw backend serves '
            'every platform.'
        ) from None


def jaxtype_to_warptype(dtype) -> Any:
    """Map a JAX/numpy dtype to the corresponding ``warp`` scalar type."""
    warp = _import_warp()
    dtype = np.dtype(jnp.dtype(dtype))
    table = {
        np.dtype('float16'): warp.float16,
        np.dtype('float32'): warp.float32,
        np.dtype('float64'): warp.float64,
        np.dtype('int8'): warp.int8,
        np.dtype('int16'): warp.int16,
        np.dtype('int32'): warp.int32,
        np.dtype('int64'): warp.int64,
        np.dtype('uint8'): warp.uint8,
        np.dtype('uint16'): warp.uint16,
        np.dtype('uint32'): warp.uint32,
        np.dtype('uint64'): warp.uint64,
        np.dtype('bool'): warp.bool,
    }
    try:
        return table[dtype]
    except KeyError:
        raise ValueError(f'No warp type for dtype {dtype}.') from None


def jaxinfo_to_warpinfo(jax_info: jax.ShapeDtypeStruct) -> Any:
    """Map a ``ShapeDtypeStruct`` to a ``warp.array`` type annotation."""
    warp = _import_warp()
    dtype = jaxtype_to_warptype(jax_info.dtype)
    return warp.array(dtype=dtype, ndim=len(jax_info.shape))
