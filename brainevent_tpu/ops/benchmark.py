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

"""Benchmark harness (capability parity with ``brainevent/_op/benchmark.py``).

Times jitted callables with warmup + ``block_until_ready``, groups records by
fixed/vary keys, computes baseline speedups, and exports CSV/JSON/pickle.
Plotting (matplotlib/seaborn) is optional and gated.
"""

import dataclasses
import json
import pickle
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax

__all__ = [
    'BenchmarkConfig',
    'BenchmarkRecord',
    'BenchmarkResult',
    'benchmark_function',
    'gpu_device_info',
]


def gpu_device_info() -> Dict[str, Any]:
    """The GPU this process measures on, or ``RuntimeError`` without one.

    Returns JAX's view (``platform``, ``kind``, ``count``) and the first
    card's name and power limit as ``nvidia-smi`` reports them
    (``card``). A card set below its maximum power runs slower under
    load, so every timing is reported beside it.
    """
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise RuntimeError(
            f'no GPU: JAX reports platform {dev.platform!r} '
            f'({dev.device_kind}); measurements need the card.')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices()),
            'card': smi.stdout.strip().splitlines()[0]}


@dataclasses.dataclass
class BenchmarkConfig:
    """One benchmark point: a name, positional args, and static kwargs
    (reference ``brainevent/_op/benchmark.py:42``).

    ``loop_arg`` names the positional argument that carries the fused-loop
    dependence when benchmarking with ``iterations > 1`` (see
    :func:`benchmark_function`); it should be the op's dense operand.
    """
    name: str
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loop_arg: int = -1


@dataclasses.dataclass
class BenchmarkRecord:
    """Timing record for one (function, config) pair
    (reference ``brainevent/_op/benchmark.py:79``)."""
    name: str
    mean_ms: float
    std_ms: float
    min_ms: float
    max_ms: float
    n_runs: int
    throughput: Optional[float] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    iterations: int = 1

    @property
    def us_per_call(self) -> float:
        """Time per op application in microseconds (mean total time of a
        device call divided by the fused ``iterations``)."""
        return self.mean_ms * 1e3 / max(1, self.iterations)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d['us_per_call'] = self.us_per_call
        return d


class BenchmarkResult:
    """A collection of :class:`BenchmarkRecord` with grouping, baseline
    comparison, pretty-printing, and export
    (reference ``brainevent/_op/benchmark.py:125``)."""

    def __init__(self, records: Sequence[BenchmarkRecord]):
        self.records: List[BenchmarkRecord] = list(records)

    # -- analysis ------------------------------------------------------

    def group_by(self, key_fn: Callable[[BenchmarkRecord], Any]) -> Dict[Any, 'BenchmarkResult']:
        groups: Dict[Any, List[BenchmarkRecord]] = {}
        for rec in self.records:
            groups.setdefault(key_fn(rec), []).append(rec)
        return {k: BenchmarkResult(v) for k, v in groups.items()}

    def compare_by(self, baseline_name: str) -> Dict[str, float]:
        """Speedup of every record relative to the record named *baseline_name*."""
        base = next((r for r in self.records if r.name == baseline_name), None)
        if base is None:
            raise KeyError(
                f'No record named {baseline_name!r}; have '
                f'{[r.name for r in self.records]}.'
            )
        return {r.name: base.mean_ms / r.mean_ms for r in self.records}

    def best(self) -> BenchmarkRecord:
        return min(self.records, key=lambda r: r.mean_ms)

    # -- export --------------------------------------------------------

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps([r.to_dict() for r in self.records], indent=2)
        if path:
            with open(path, 'w') as f:
                f.write(payload)
        return payload

    def to_csv(self, path: Optional[str] = None) -> str:
        header = 'name,mean_ms,std_ms,min_ms,max_ms,n_runs,throughput'
        lines = [header] + [
            f'{r.name},{r.mean_ms},{r.std_ms},{r.min_ms},{r.max_ms},'
            f'{r.n_runs},{r.throughput if r.throughput is not None else ""}'
            for r in self.records
        ]
        payload = '\n'.join(lines)
        if path:
            with open(path, 'w') as f:
                f.write(payload)
        return payload

    def to_pickle(self, path: str) -> None:
        with open(path, 'wb') as f:
            pickle.dump(self.records, f)

    def plot(self, **kwargs):  # pragma: no cover - optional dependency
        """Bar plot of mean times; requires matplotlib."""
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            raise ImportError('Plotting requires matplotlib.') from None
        names = [r.name for r in self.records]
        means = [r.mean_ms for r in self.records]
        stds = [r.std_ms for r in self.records]
        fig, ax = plt.subplots(figsize=kwargs.pop('figsize', (10, 4)))
        ax.barh(names, means, xerr=stds)
        ax.set_xlabel('mean time (ms)')
        fig.tight_layout()
        return fig

    def __repr__(self):
        lines = [f'BenchmarkResult({len(self.records)} records)']
        for r in sorted(self.records, key=lambda r: r.mean_ms):
            lines.append(
                f'  {r.name:<60s} {r.mean_ms:10.4f} ms '
                f'(±{r.std_ms:.4f}, min {r.min_ms:.4f})'
            )
        return '\n'.join(lines)


def _looped(fn, iterations: int, loop_arg: int, kwargs):
    """Wrap *fn* in a ``fori_loop`` applying it *iterations* times inside ONE
    jitted computation.

    Timing a microsecond-scale op one device call at a time measures the
    per-call dispatch, not the op. The loop injects a loop-carried dependence through
    ``args[loop_arg]`` (adding/xoring a runtime-false perturbation derived
    from the previous output) so XLA can neither hoist the loop-invariant op
    out of the loop nor CSE the iterations away; the injected term is exact
    zero for bool/int operands and below f32 resolution for floats.
    """
    import jax.numpy as jnp

    def call(*a):
        la = loop_arg % len(a)
        x0 = a[la]

        def body(_, acc):
            gate = acc < jnp.float32(-1e30)            # runtime-false
            if x0.dtype == jnp.bool_:
                x = x0 ^ gate
            elif jnp.issubdtype(x0.dtype, jnp.integer):
                x = x0 + gate.astype(x0.dtype)
            else:
                x = x0 + (acc * jnp.asarray(1e-38, x0.dtype)
                          ).astype(x0.dtype)
            out = fn(*a[:la], x, *a[la + 1:], **kwargs)
            first = out[0] if isinstance(out, (tuple, list)) else out
            # depend on EVERY output element: a single-element carry lets
            # XLA dead-code the rest of the iteration's work
            return jnp.sum(first).astype(jnp.float32)

        return jax.lax.fori_loop(0, iterations, body, jnp.float32(0))

    return call


def benchmark_function(
    fn: Callable,
    *args,
    name: Optional[str] = None,
    n_warmup: int = 3,
    n_runs: int = 10,
    verbose: bool = True,
    jit: bool = True,
    iterations: int = 1,
    loop_arg: int = -1,
    **kwargs,
) -> BenchmarkResult:
    """Time ``fn(*args, **kwargs)`` with warmup and ``block_until_ready``
    (reference ``brainevent/_op/benchmark.py:1514``).

    The callable is jitted once (unless ``jit=False``), warmed up
    *n_warmup* times, then timed *n_runs* times on the host clock around a
    call that ends in ``block_until_ready``. With ``iterations > 1`` the op
    is applied that many times inside one fused loop per device call (see
    :func:`_looped`) and recorded times stay TOTAL —
    ``BenchmarkRecord.us_per_call`` divides them out.
    """
    name = name or getattr(fn, '__name__', 'fn')
    if iterations > 1:
        call = jax.jit(_looped(fn, iterations, loop_arg, kwargs))
    else:
        call = jax.jit(lambda *a: fn(*a, **kwargs)) if jit else (lambda *a: fn(*a, **kwargs))

    def timed():
        """Milliseconds for one device call."""
        t0 = time.perf_counter()
        jax.block_until_ready(call(*args))
        return (time.perf_counter() - t0) * 1e3

    for _ in range(max(0, n_warmup)):
        timed()
    times_ms = [timed() for _ in range(max(1, n_runs))]
    rec = BenchmarkRecord(
        name=name,
        mean_ms=statistics.fmean(times_ms),
        std_ms=statistics.stdev(times_ms) if len(times_ms) > 1 else 0.0,
        min_ms=min(times_ms),
        max_ms=max(times_ms),
        n_runs=len(times_ms),
        iterations=max(1, iterations),
    )
    if verbose:
        print(f'{rec.name}: {rec.mean_ms:.4f} ms (±{rec.std_ms:.4f}, '
              f'min {rec.min_ms:.4f}, {rec.us_per_call:.3f} us/call)',
              flush=True)
    return BenchmarkResult([rec])
