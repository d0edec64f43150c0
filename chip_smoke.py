# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Smoke test of brainevent-tpu on an NVIDIA GPU, through the public API.

One process. Each phase prints what it found; a phase that fails is
reported and makes the script exit non-zero without the result line.

Single-card phases (``python chip_smoke.py``):

1. device: JAX's platform must be ``gpu``; the card's name and power limit.
2. EINet COBA and CUBA at 4,000 neurons (reference ``COBA_2005.py``):
   2,000 steps of ``EINet.run`` against a plain reference loop, then one
   100k-step timed run.
3. EINet COBA at 400,000 neurons / 32M synapses (reference
   ``CUBA_2005.py``, scale=100): 500 steps against the reference, with
   the compiled program's memory analysis and the peak device memory.
4. Surrogate-gradient training (``SurrogateSNN``, 2,000 hidden): 5
   ``train_step`` s with a falling loss, and one gradient against
   ``jax.grad`` of a plain dense formulation.
5. Implicit connectivity: ``JITCNormalR`` at 10,000 x 10,000, both
   orientations and the event form, against ``todense() @ v``.

Four-card phase (``python chip_smoke.py --chips 4``, and nothing else):
``ShardedEINet`` at 400,000 neurons over 4 cards for 500 steps against
single-card ``EINet.run``, with the collectives its step compiled to.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import math
import os
import re
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from brainevent_tpu import config
from brainevent_tpu.events import BinaryArray
from brainevent_tpu.jitc import JITCNormalR
from brainevent_tpu.models import EINet, EINetState, SurrogateSNN, train_step
from brainevent_tpu.models.neurons import lifref_step, surrogate_spike
from brainevent_tpu.ops import gpu_device_info

# spike counts are integer hit counts in f32 on both sides, so they must
# match exactly; the state tolerance covers summation order only
STATE_ATOL = 1e-4
GRAD_RTOL = 1e-4
JITC_RTOL = 2e-4
JITC_ATOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# plain references
# ---------------------------------------------------------------------------

def einet_reference_run(net: EINet, n_steps: int, inp: float = 20.0,
                        state: EINetState = None) -> EINetState:
    """``EINet.run`` without compaction, capacity or overflow branch: every
    spiking neuron adds its whole ``conn_all`` row with ``.at[].add``. The
    neuron update is the library's ``lifref_step``."""
    state = net.init_state() if state is None else state
    decay_e = jnp.float32(math.exp(-net.dt / net.tau_e))
    decay_i = jnp.float32(math.exp(-net.dt / net.tau_i))
    is_exc = jnp.arange(net.num) < net.n_exc
    conn = net.conn_all

    def hits(gate):
        vals = jnp.broadcast_to(gate.astype(jnp.float32)[:, None], conn.shape)
        return jnp.zeros(net.num, jnp.float32).at[conn].add(vals)

    def body(i, s):
        g_e = s.g_e * decay_e
        g_i = s.g_i * decay_i
        v = s.neurons.v
        if net.coba:
            current = g_e * (net.e_e - v) + g_i * (net.e_i - v) + inp
        else:
            current = g_e - g_i + inp
        neurons, spike = lifref_step(s.neurons, current, i * net.dt, net.dt,
                                     net.params)
        return EINetState(
            neurons=neurons,
            g_e=g_e + net.w_e * hits(spike & is_exc),
            g_i=g_i + net.w_i * hits(spike & ~is_exc),
            spike_count=s.spike_count + spike.astype(jnp.int32))

    with jax.default_matmul_precision('highest'):
        return jax.lax.fori_loop(0, n_steps, body, state)


def compare_einet_states(got, want) -> dict:
    """Spike counts exactly, ``v``/``g_e``/``g_i`` to ``STATE_ATOL``.
    Accepts ``EINetState`` or ``ShardedEINetState`` for *got*."""
    def fields(s):
        if isinstance(s, EINetState):
            return s.neurons.v, s.g_e, s.g_i, s.spike_count
        return s.v, s.g_e, s.g_i, s.spike_count

    gv, ge, gi, gc = (np.asarray(a) for a in fields(got))
    wv, we, wi, wc = (np.asarray(a) for a in fields(want))
    np.testing.assert_array_equal(gc, wc, err_msg='spike counts differ')
    for name, g, w in (('v', gv, wv), ('g_e', ge, we), ('g_i', gi, wi)):
        np.testing.assert_allclose(g, w, rtol=0, atol=STATE_ATOL,
                                   err_msg=f'{name} differs')
    return {'spikes': int(wc.sum()),
            'max_abs_dv': float(np.max(np.abs(gv - wv))),
            'max_abs_dg_e': float(np.max(np.abs(ge - we))),
            'max_abs_dg_i': float(np.max(np.abs(gi - wi)))}


def snn_reference_loss(model: SurrogateSNN, params, inputs, label):
    """``snn_loss`` as plain jax.numpy: dense input and readout, and the
    recurrent ELL table densified into ``W[i, idx[i, j]] += w[i, j]``."""
    n = model.n_hidden
    rows = jnp.repeat(jnp.arange(n), model.n_conn)
    w_rec = jnp.zeros((n, n), params.w_rec.dtype).at[
        rows, model.rec_indices.reshape(-1)].add(params.w_rec.reshape(-1))
    decay = jnp.float32(jnp.exp(-model.dt / model.tau))

    def step(carry, x_t):
        v, spk = carry
        v = v * decay + (x_t @ params.w_in + spk @ w_rec)
        spk = surrogate_spike(v - model.v_th)
        return (v - spk * model.v_th, spk), spk

    zeros = jnp.zeros(n)
    _, spikes = jax.lax.scan(step, (zeros, zeros), inputs)
    logits = spikes.mean(axis=0) @ params.w_out
    return -jax.nn.log_softmax(logits)[label]


def dyadic(x, bits: int = 10):
    """Round to multiples of ``2**-bits``: products and sums of such values
    stay exact in f32, so both formulations spike identically."""
    return jnp.round(x * 2.0 ** bits) / 2.0 ** bits


def snn_inputs(model: SurrogateSNN, n_steps: int, seed: int = 0):
    """Class-templated inputs (class ``c`` drives input block ``c``), as in
    ``examples/surrogate_training.py``, on a 1/16 grid."""
    rng = np.random.default_rng(seed)
    x = 0.2 * rng.random((model.n_out, n_steps, model.n_in))
    block = model.n_in // model.n_out
    for c in range(model.n_out):
        x[c, :, block * c:block * (c + 1)] += 1.0
    return jnp.asarray(np.round(x * 16) / 16, jnp.float32)


def check_snn_grad(model: SurrogateSNN, inputs, label) -> dict:
    """Gradient of one step through the library's custom VJP against
    ``jax.grad`` of :func:`snn_reference_loss`, both at ``highest``."""
    from brainevent_tpu.models import snn_loss
    params = jax.tree.map(dyadic, model.init_params())
    with jax.default_matmul_precision('highest'):
        got = jax.jit(jax.grad(
            lambda p: snn_loss(model, p, inputs, label)))(params)
        want = jax.jit(jax.grad(
            lambda p: snn_reference_loss(model, p, inputs, label)))(params)
    out = {}
    for name in ('w_in', 'w_rec', 'w_out'):
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f'grad {name} differs')
        out[name] = float(np.max(np.abs(g - w))) / max(scale, 1e-30)
    return out


def check_jitc(n: int, prob: float, seed: int = 7) -> dict:
    """``JITCNormalR`` products in both orientations and in event form
    against the materialized matrix, all at ``highest``."""
    rng = np.random.default_rng(seed)
    M = JITCNormalR((0.5, 0.2, prob, seed), shape=(n, n))
    v = jnp.asarray(rng.normal(size=n), jnp.float32)
    spk = jnp.asarray(rng.random(n) < 0.05)
    out = {}
    with jax.default_matmul_precision('highest'):
        dense = M.todense()
        cases = {
            'M @ v': (M @ v, dense @ v),
            'v @ M': (v @ M, v @ dense),
            'M @ events': (M @ BinaryArray(spk),
                           dense @ spk.astype(jnp.float32)),
            'events @ M': (BinaryArray(spk) @ M,
                           spk.astype(jnp.float32) @ dense),
        }
        for name, (got, want) in cases.items():
            got, want = np.asarray(got), np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=JITC_RTOL,
                                       atol=JITC_ATOL, err_msg=name)
            out[name] = float(np.max(np.abs(got - want)))
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(info: dict) -> None:
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    log(f"card: {info['card']}")


def phase_einet_4k(info: dict, n_compare: int = 2000,
                   n_timed: int = 100_000, scale: float = 1.0) -> None:
    for coba in (True, False):
        net = EINet(scale=scale, coba=coba)
        name = f"{'COBA' if coba else 'CUBA'} {net.num}"
        got = jax.block_until_ready(
            jax.jit(lambda s: net.run(n_compare, state=s))(net.init_state()))
        want = einet_reference_run(net, n_compare)
        log(f'einet {name}: {n_compare} steps match the reference: '
            f'{compare_einet_states(got, want)}')
        run = jax.jit(lambda s: net.run(n_timed, state=s))
        state = net.init_state()
        jax.block_until_ready(run(state))
        t0 = time.perf_counter()
        final = jax.block_until_ready(run(state))
        us = (time.perf_counter() - t0) / n_timed * 1e6
        log(f'einet {name}: {us:.3f} us/step over {n_timed} steps, '
            f'{float(net.firing_rate_hz(final, n_timed)):.2f} Hz '
            f"({info['card']})")


def phase_einet_400k(info: dict, n_compare: int = 500,
                     scale: float = 100.0) -> None:
    net = EINet(scale=scale, coba=True)
    state = net.init_state()
    compiled = jax.jit(lambda s: net.run(n_compare, state=s)).lower(
        state).compile()
    log(f'einet COBA {net.num}: memory analysis: '
        f'{compiled.memory_analysis()}')
    got = jax.block_until_ready(compiled(state))
    want = einet_reference_run(net, n_compare)
    log(f'einet COBA {net.num}: {n_compare} steps match the reference: '
        f'{compare_einet_states(got, want)}')
    stats = jax.devices()[0].memory_stats() or {}
    log(f'einet COBA {net.num}: peak_bytes_in_use='
        f"{stats.get('peak_bytes_in_use')}")


def phase_training(info: dict, n_hidden: int = 2000, n_steps: int = 50,
                   n_train: int = 5) -> None:
    model = SurrogateSNN(n_in=40, n_hidden=n_hidden, n_out=4, n_conn=32,
                         seed=1)
    x = snn_inputs(model, n_steps)
    grads = check_snn_grad(model, x[1], jnp.asarray(1))
    log(f'training: gradient matches jax.grad of the plain formulation '
        f'(max abs diff / max abs grad): {grads}')
    step = jax.jit(lambda p, xs, y: train_step(model, p, xs, y, lr=0.5))
    params = model.init_params()
    losses = []
    t0 = time.perf_counter()
    for k in range(n_train):
        # samples 0, 1, 2, 3, 0: the last loss is sample 0's after training
        params, loss = step(params, x[k % 4], jnp.asarray(k % 4))
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    # default precision: f32 dense projections may use TF32 on the card
    log(f'training: {n_train} train_steps at default matmul precision '
        f'(TF32 allowed): losses {losses}; '
        f'{dt / n_train * 1e3:.3f} ms/step including the first compile')
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'non-finite loss: {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(
            f'loss on sample 0 did not fall: {losses[0]} -> {losses[-1]}')


def phase_jitc(info: dict, n: int = 10_000, prob: float = 0.01) -> None:
    log(f'jitc JITCNormalR ({n}, {n}) p={prob}: max abs diff vs '
        f'todense() @ v: {check_jitc(n, prob)}')


def phase_sharded(info: dict, n_devices: int = 4, scale: float = 100.0,
                  n_steps: int = 500) -> None:
    from brainevent_tpu.parallel import ShardedEINet, neuron_mesh
    net = EINet(scale=scale, coba=True)
    sharded = ShardedEINet.from_einet(net, neuron_mesh(n_devices))
    state = net.init_state()
    want = jax.block_until_ready(
        jax.jit(lambda s: net.run(n_steps, state=s))(state))
    sstate = sharded.init_state_from(state)
    run = jax.jit(lambda s: sharded.run(n_steps, state=s)).lower(
        sstate).compile()
    hlo = run.as_text()
    collectives = re.findall(
        r'\b(reduce-scatter|all-reduce|all-gather|all-to-all|'
        r'collective-permute)(?:-start)?\(', hlo)
    counts = {c: collectives.count(c) for c in sorted(set(collectives))}
    log(f'sharded EINet {net.num} over {n_devices} devices: compiled '
        f'collectives {counts}')
    for line in hlo.splitlines():
        if re.search(r'reduce-scatter(?:-start)?\(', line):
            log(f'  {line.strip()[:240]}')
    got = jax.block_until_ready(run(sstate))
    log(f'sharded EINet {net.num}: {n_steps} steps match single-card '
        f'EINet.run: {compare_einet_states(got, want)}')


SINGLE_PHASES = (phase_device, phase_einet_4k, phase_einet_400k,
                 phase_training, phase_jitc)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--chips', type=int, default=1, choices=(1, 4),
                        help='4 runs only the four-card sharded phase')
    args = parser.parse_args(argv)
    info = gpu_device_info()            # raises without a GPU
    config.entry_point_cache(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), '.jax_cache'))
    if info['count'] < args.chips:
        raise RuntimeError(f"--chips {args.chips} needs {args.chips} "
                           f"devices, JAX sees {info['count']}")
    phases = ((phase_device, phase_sharded) if args.chips == 4
              else SINGLE_PHASES)
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase(info)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(phase.__name__)
            log(f'{phase.__name__}: FAILED')
        else:
            log(f'{phase.__name__}: ok ({time.perf_counter() - t0:.1f} s)')
    if failed:
        log(f'failed phases: {failed}')
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': info['platform'], 'kind': info['kind'],
        'count': info['count']}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
