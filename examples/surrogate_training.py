# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.
#
# Surrogate-gradient SNN training on fixed-number recurrent
# connectivity (BASELINE.md acceptance workload). The recurrent ELL
# product is one custom VJP (models/training.py): binary forward, float
# cotangents — the surrogate-linear contract of the reference's binary
# primitives (brainevent/_csr/binary.py:656).
#
# Run: python examples/surrogate_training.py

import os
import sys
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..')))

import jax
import jax.numpy as jnp
import numpy as np

from brainevent_tpu.models.training import SurrogateSNN, snn_loss, train_step


def main():
    on_gpu = jax.devices()[0].platform == 'gpu'
    n_hidden = 2000 if on_gpu else 400      # CPU: smoke-scale
    model = SurrogateSNN(n_in=40, n_hidden=n_hidden, n_out=4, n_conn=32,
                         seed=1)
    params = model.init_params()
    rng = np.random.default_rng(0)
    # class-templated inputs: class c drives input block [10c, 10c+10) —
    # separable by construction, so the loss target tests LEARNING, not
    # the luck of random projections
    Xn = 0.2 * rng.random((4, 50, 40)).astype(np.float32)
    for c in range(4):
        Xn[c, :, 10 * c:10 * c + 10] += 1.0
    X = jnp.asarray(Xn)
    Y = jnp.asarray([0, 1, 2, 3])

    @jax.jit
    def epoch(params):
        def one(p, xy):
            x, y = xy
            return train_step(model, p, x, y, lr=0.5)
        return jax.lax.scan(one, params, (X, Y))

    mean_loss = jax.jit(lambda p: jnp.mean(jax.vmap(
        lambda x, y: snn_loss(model, p, x, y))(X, Y)))
    print(f'initial loss: {float(mean_loss(params)):.3f}')
    t0 = time.time()
    for ep in range(30):
        params, losses = epoch(params)
    params = jax.block_until_ready(params)
    print(f'loss after 30 epochs: {float(mean_loss(params)):.3f} '
          f'({time.time() - t0:.1f} s)')


if __name__ == '__main__':
    main()
