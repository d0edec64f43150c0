# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.
#
# Multi-device EI-network simulation over a jax.sharding.Mesh (an
# extension; the reference is single-GPU). On one host with several GPUs it
# uses every card; without a GPU, run on a virtual CPU mesh:
#
#   XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
#   python examples/sharded_simulation.py

import os
import sys
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax

from brainevent_tpu.parallel import ShardedEINet, neuron_mesh


def main():
    n_dev = len(jax.devices())
    on_gpu = jax.devices()[0].platform == 'gpu'
    mesh = neuron_mesh(n_dev)
    per_dev = 4096 if on_gpu else 512       # CPU: smoke-scale
    net = ShardedEINet(mesh=mesh, num=per_dev * n_dev, n_conn=80)
    state = net.init_state()
    n_steps = 1000 if on_gpu else 100

    run = jax.jit(lambda s: net.run(n_steps, state=s))
    jax.block_until_ready(run(state))      # compile + warm
    t0 = time.time()
    final = jax.block_until_ready(run(state))
    dt = time.time() - t0
    rate = float(final.spike_count.mean()) / (n_steps * 0.1e-3)
    print(f'{net.num} neurons over {n_dev} devices: '
          f'{dt / n_steps * 1e6:.1f} us/step, {rate:.1f} Hz')
    print('state sharding:', final.v.sharding)


if __name__ == '__main__':
    main()
