# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.
#
# EI network over just-in-time regenerated connectivity — the implicit
# counterpart of COBA_2005.py and the "80k-neuron JITC net" acceptance
# workload (BASELINE.json): no weight matrix is ever stored; both
# projections are JITCNormalR generative matrices whose structure and
# weights are redrawn from the seed inside every product (reference
# brainevent/_jit_normal/main.py).
#
# Each projection binds a walk plan once (build_walk_plan), and spike
# propagation runs the event-compacted scatter (jitc/event_route.py): only
# the spiking rows' streams walk, candidates scatter-add into the output,
# and bursts fall back — exactly — to the full product.
#
# Run: python examples/JITC_network.py [scale] [normal|uniform]

import os
import sys
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax

from brainevent_tpu.models import JITCNet

DURATION_MS = 2_000.0
DT_MS = 0.1
N_STEPS = int(DURATION_MS / DT_MS)


def run(scale: float, weight_law: str = 'normal'):
    net = JITCNet(scale=scale, weight_law=weight_law)
    run_fn = jax.jit(lambda s: net.run(N_STEPS, state=s))
    state0 = net.init_state()
    jax.block_until_ready(run_fn(state0))     # compile + warm up
    t0 = time.time()
    final = jax.block_until_ready(run_fn(net.init_state(
        jax.random.PRNGKey(1))))
    dt = time.time() - t0
    rate = float(net.firing_rate_hz(final, N_STEPS))
    print(f'n={net.num:>7d} [{weight_law}]: {dt:.3f} s / {N_STEPS} steps '
          f'= {dt / N_STEPS * 1e6:.1f} us/step, {rate:.1f} Hz '
          f'(weights implicit: 0 bytes stored)')


if __name__ == '__main__':
    from brainevent_tpu import config
    config.entry_point_cache(os.path.abspath(
        os.path.join(os.path.dirname(__file__), '..', '.jax_cache')))
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    law = sys.argv[2] if len(sys.argv) > 2 else 'normal'
    run(scale, law)
