# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Self-contained SNN model components for the acceptance workloads
(CUBA/COBA EI networks, surrogate-gradient training)."""

from .training import SurrogateSNN, SNNParams, snn_loss, train_step
from .neurons import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
)
from .networks import EINet, EINetState
from .jitc_net import JITCNet, JITCNetState

__all__ = [
    'LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
    'surrogate_spike', 'EINet', 'EINetState',
    'JITCNet', 'JITCNetState',
    'SurrogateSNN', 'SNNParams', 'snn_loss', 'train_step',
]
