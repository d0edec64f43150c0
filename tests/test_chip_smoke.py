# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The comparison functions of ``chip_smoke.py`` at tiny sizes on the CPU,
its refusal to run without a GPU, and one full-size phase on the card
(marked ``gpu``)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from brainevent_tpu.models import EINet, SurrogateSNN, snn_loss

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_INFO = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'card': 'none'}


@pytest.mark.parametrize('coba', [True, False])
def test_einet_reference_matches_run(coba):
    net = EINet(scale=0.25, coba=coba)
    got = jax.jit(lambda s: net.run(300, state=s))(net.init_state())
    found = cs.compare_einet_states(got, cs.einet_reference_run(net, 300))
    assert found['spikes'] > 0 and found['max_abs_dv'] == 0.0


def test_compare_rejects_spike_mismatch():
    net = EINet(scale=0.1)
    want = cs.einet_reference_run(net, 100)
    got = want._replace(spike_count=want.spike_count.at[3].add(1))
    with pytest.raises(AssertionError, match='spike counts'):
        cs.compare_einet_states(got, want)


def test_compare_rejects_state_drift():
    net = EINet(scale=0.1)
    want = cs.einet_reference_run(net, 100)
    got = want._replace(g_e=want.g_e + 1e-3)
    with pytest.raises(AssertionError, match='g_e'):
        cs.compare_einet_states(got, want)


def test_snn_reference_loss_equals_library_loss():
    # dyadic parameters and inputs make both forwards exact: same loss
    model = SurrogateSNN(n_in=8, n_hidden=64, n_out=4, n_conn=8, seed=1)
    params = jax.tree.map(cs.dyadic, model.init_params())
    x = cs.snn_inputs(model, 12)[2]
    with jax.default_matmul_precision('highest'):
        a = float(snn_loss(model, params, x, jnp.asarray(2)))
        b = float(cs.snn_reference_loss(model, params, x, jnp.asarray(2)))
    assert a == b


@pytest.mark.parametrize('n_hidden', [64, 300])
def test_snn_grad_check(n_hidden):
    model = SurrogateSNN(n_in=8, n_hidden=n_hidden, n_out=4, n_conn=16,
                         seed=1)
    found = cs.check_snn_grad(model, cs.snn_inputs(model, 15)[1],
                              jnp.asarray(1))
    assert set(found) == {'w_in', 'w_rec', 'w_out'}
    assert all(v <= cs.GRAD_RTOL for v in found.values())


@pytest.mark.parametrize('n,prob', [(300, 0.05), (600, 0.02)])
def test_check_jitc(n, prob):
    found = cs.check_jitc(n, prob)
    assert set(found) == {'M @ v', 'v @ M', 'M @ events', 'events @ M'}


def test_phase_sharded_on_virtual_devices(capsys):
    cs.phase_sharded(_INFO, n_devices=4, scale=0.5, n_steps=100)
    out = capsys.readouterr().out
    assert "compiled collectives {'reduce-scatter': 2}" in out
    assert 'match single-card EINet.run' in out


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['JAX_PLATFORMS'] = 'cpu'
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_without_gpu_exits_nonzero_and_prints_no_result():
    r = _run(['chip_smoke.py'], cwd=_REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert 'no GPU' in r.stderr


def test_alone_outside_the_repo_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, 'chip_smoke.py'), tmp_path)
    r = _run(['chip_smoke.py'], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_einet_4k_exact_on_gpu(gpu_device):
    for coba in (True, False):
        net = EINet(scale=1.0, coba=coba)
        with jax.default_device(gpu_device):
            got = jax.jit(lambda s: net.run(2000, state=s))(net.init_state())
            want = cs.einet_reference_run(net, 2000)
        found = cs.compare_einet_states(got, want)
        assert found['spikes'] > 0
