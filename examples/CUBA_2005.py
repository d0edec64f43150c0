# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.
#
# Current-based (CUBA) EI network benchmark, after:
#
# - Vogels, T. P. and Abbott, L. F. (2005), Signal propagation and logic
#   gating in networks of integrate-and-fire neurons. J. Neurosci., 25,
#   10786-95.
#
# Counterpart of the reference benchmark examples/CUBA_2005.py.
# 10 s of biological time at dt = 0.1 ms, event-driven fixed-probability
# connectivity (~80 synapses/neuron), one jitted step loop (EINet.run).
#
# Run: python examples/CUBA_2005.py

import os
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, _ROOT)

import jax

from brainevent_tpu import config
from brainevent_tpu.models import EINet

DURATION_MS = 10_000.0
DT_MS = 0.1
N_STEPS = int(DURATION_MS / DT_MS)


def run(scale: float):
    net = EINet(scale=scale, coba=False)
    state0 = net.init_state()
    run_fn = jax.jit(lambda s: net.run(N_STEPS, state=s))
    jax.block_until_ready(run_fn(state0))  # compile + warm up
    t0 = time.perf_counter()
    final = jax.block_until_ready(run_fn(state0))
    elapsed = time.perf_counter() - t0
    rate = float(net.firing_rate_hz(final, N_STEPS))
    return net.num, elapsed, rate


if __name__ == '__main__':
    config.entry_point_cache(os.path.join(_ROOT, '.jax_cache'))
    for s in [1, 2, 4, 10]:
        n, t, rate = run(s)
        print(f'scale={s}, size={n}, time = {t:.3f} s, '
              f'firing rate = {rate:.2f} Hz')
