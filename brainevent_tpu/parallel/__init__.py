# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Multi-device parallelism over device meshes (an extension; the reference
has no distributed layer, SURVEY §2.9)."""

from .sharding import (ShardedEINet, ShardedEINetState, neuron_mesh,
                       host_chip_mesh)

__all__ = ['ShardedEINet', 'ShardedEINetState', 'neuron_mesh',
           'host_chip_mesh']

from .ops import (
    sharded_binary_fcnmv, sharded_fcnmv,
    sharded_binary_fcnmm, sharded_fcnmm,
    sharded_binary_csrmv, sharded_csrmv,
    sharded_binary_csrmm, sharded_csrmm,
    CsrShardPlan, balance_csr_shards,
    sharded_jitmv,
)

__all__ += [
    'sharded_jitmv',
    'sharded_binary_fcnmv', 'sharded_fcnmv',
    'sharded_binary_fcnmm', 'sharded_fcnmm',
    'sharded_binary_csrmv', 'sharded_csrmv',
    'sharded_binary_csrmm', 'sharded_csrmm',
    'CsrShardPlan', 'balance_csr_shards',
]
