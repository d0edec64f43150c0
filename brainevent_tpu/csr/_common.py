# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Shared helpers for the CSR operator package."""

import jax.numpy as jnp

from .._error import MathError

__all__ = ['row_ids_from_indptr', 'event_gate', 'is_homo', 'csr_checks']


def row_ids_from_indptr(indptr, nse: int):
    """Expand CSR ``indptr`` into the per-nse row-id array (COO rows).

    Formulated as a cumsum over scattered row-start markers instead of
    ``jnp.repeat``: the marker scatter touches only ``m`` elements and
    the cumsum is one pass over ``nse``. Empty rows stack markers at one position (the
    ``.add``), trailing empty rows drop at position nse — both give the
    same ids as the repeat formulation.
    """
    if nse == 0:
        return jnp.zeros((0,), indptr.dtype)
    markers = jnp.zeros((nse,), indptr.dtype).at[indptr[1:-1]].add(
        1, mode='drop')
    return jnp.cumsum(markers)


def event_gate(v, out_dtype):
    """Event gating of a spike vector: bool casts, floats gate at ``> 0``
    (matches reference ``brainevent/_csr/binary.py:492-531``)."""
    if v.dtype == jnp.bool_:
        return v.astype(out_dtype)
    return (v > 0).astype(out_dtype)


def is_homo(weights) -> bool:
    """Homogeneous (single shared) weight? Transpose rules see the weights
    as an ``UndefinedPrimal``, whose shape lives on its ``aval``."""
    weights = getattr(weights, 'aval', weights)
    return weights.size == 1 if hasattr(weights, 'size') else False


def csr_checks(weights, indices, indptr, shape):
    if len(shape) != 2:
        raise MathError(f'shape must be (m, k), got {shape}.')
    if indices.dtype != indptr.dtype:
        raise MathError(
            f'indices dtype ({indices.dtype}) must match indptr dtype '
            f'({indptr.dtype}).')
    if indptr.shape[0] != shape[0] + 1:
        raise MathError(
            f'indptr length {indptr.shape[0]} != shape[0]+1 = {shape[0] + 1}.')
    if weights.ndim != 1 or weights.shape[0] not in (1, indices.shape[0]):
        raise MathError(
            f'weights must be (1,) or ({indices.shape[0]},), got {weights.shape}.')
