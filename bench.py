# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Headline benchmark: the COBA EI network (Brette et al. 2007) at dt = 0.1 ms
through ``EINet.run``, at the reference's two sizes — 4,000 neurons for
100k steps (reference ``examples/COBA_2005.py``) and 400,000 neurons
(reference ``examples/CUBA_2005.py``, scale=100).

Each size is timed as the median of 3 fused runs on the host clock, each
ending in ``block_until_ready``. Needs a GPU: without one it exits non-zero.

Prints ONE JSON line with the device (platform, kind, count, card name and
power limit) and the µs/step of each size.

Run: ``python bench.py``
"""

import json
import os
import statistics
import time

import jax

from brainevent_tpu import config
from brainevent_tpu.models import EINet
from brainevent_tpu.ops import gpu_device_info

# (scale, steps): 100k steps at 4k as in the reference; 10k at 400k keeps a
# run near a second
_SIZES = ((1.0, 100_000), (100.0, 10_000))


def time_einet(scale: float, n_steps: int, repeats: int = 3) -> dict:
    net = EINet(scale=scale, coba=True)
    state = net.init_state()
    t0 = time.perf_counter()
    run = jax.jit(lambda s: net.run(n_steps, state=s)).lower(state).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(run(state))              # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        final = jax.block_until_ready(run(state))
        times.append(time.perf_counter() - t0)
    return {
        'n_neurons': net.num,
        'n_steps': n_steps,
        'us_per_step': statistics.median(times) / n_steps * 1e6,
        'us_per_step_runs': [t / n_steps * 1e6 for t in times],
        'compile_s': compile_s,
        'firing_rate_hz': float(net.firing_rate_hz(final, n_steps)),
    }


def main():
    result = {'device': gpu_device_info()}       # raises without a GPU
    config.entry_point_cache(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), '.jax_cache'))
    for scale, n_steps in _SIZES:
        result[f'coba_{int(4000 * scale)}'] = time_einet(scale, n_steps)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
