# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Tour of the benchmark harness (reference
``examples/benchmark_example.py`` + ``benchmark_print_examples.py``,
redesigned).

Demonstrates:

  1. ``XLACustomKernel.benchmark()`` — every registered backend over the
     primitive's registered data grid
  2. ``benchmark_function`` — time any callable, with fused
     ``iterations`` (many applications in one device call)
  3. Accessing raw ``BenchmarkRecord``s programmatically
  4. Saving / reloading results (JSON and CSV)
  5. The CLI equivalent, in-process

Run from the project root (CPU or GPU):
    python examples/benchmark_primitives.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax.numpy as jnp
import numpy as np

from brainevent_tpu.csr.binary import binary_csrmv_p
from brainevent_tpu.ops.benchmark import benchmark_function, BenchmarkResult


def main():
    # -- 1. primitive-level benchmark over the registered data grid -----
    # (each primitive registers a data generator with def_benchmark_data;
    # the CLI and this method share it)
    result = binary_csrmv_p.benchmark(n_warmup=1, n_runs=3, max_configs=1,
                                      verbose=True)

    # -- 2. ad-hoc callable timing with fused iterations ----------------
    x = jnp.asarray(np.random.default_rng(0).random((8, 512)),
                    dtype=jnp.float32)
    r2 = benchmark_function(
        lambda a: jnp.tanh(a) @ a.T,
        x,
        name='tanh-gram',
        n_warmup=1, n_runs=3,
        iterations=50,   # 50 applications fused into ONE device call
        loop_arg=0,      # which argument carries the loop dependence
    )

    # -- 3. raw records --------------------------------------------------
    best = min(result.records, key=lambda r: r.us_per_call)
    print(f'\nfastest grid cell: {best.name} at {best.us_per_call:.2f} '
          f'us/call over {best.n_runs} runs')

    # -- 4. save / reload -------------------------------------------------
    import json
    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, 'bench.json')
        cpath = os.path.join(d, 'bench.csv')
        result.to_json(jpath)
        result.to_csv(cpath)
        with open(jpath) as f:
            rows = json.load(f)
        assert len(rows) == len(result.records)
        print(f'round-tripped {len(rows)} records through JSON; '
              f'CSV at {os.path.getsize(cpath)} bytes')

    # grouping and baseline comparison on the harness result
    by_backend = result.group_by(lambda r: r.name.rsplit("[", 1)[-1])
    print('backends measured:', sorted(by_backend))

    # -- 5. the CLI equivalent, in-process --------------------------------
    from brainevent_tpu._cli import main as cli_main
    cli_main(['list-primitives', '--data', 'csr'])
    print('\n(benchmark CLI: python -m brainevent_tpu._cli '
          'benchmark-performance --data csr binary --n-runs 3)')
    del r2


if __name__ == '__main__':
    main()
