# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The user entry points (``bench.py``, the COBA/CUBA examples) at tiny
sizes on the CPU: they drive ``EINet.run`` directly, and ``bench.py``
refuses to measure without a GPU."""

import importlib.util
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        rel.replace('/', '_').replace('.py', ''), os.path.join(_REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('rel', ['examples/COBA_2005.py',
                                 'examples/CUBA_2005.py'])
def test_example_run_at_tiny_scale(rel, monkeypatch):
    mod = _load(rel)
    monkeypatch.setattr(mod, 'N_STEPS', 200)
    n, elapsed, rate = mod.run(0.1)
    assert n == 400 and elapsed > 0 and rate > 0


def test_bench_time_einet_at_tiny_scale():
    bench = _load('bench.py')
    rec = bench.time_einet(0.1, 200, repeats=2)
    assert rec['n_neurons'] == 400 and rec['n_steps'] == 200
    assert len(rec['us_per_step_runs']) == 2
    assert rec['firing_rate_hz'] > 0


def test_bench_without_gpu_fails():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env['PYTHONPATH'] = _REPO
    r = subprocess.run([sys.executable, 'bench.py'], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert 'no GPU' in r.stderr and not r.stdout.strip()
