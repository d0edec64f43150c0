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

"""Sparse linear solve for CSR matrices
(reference ``brainevent/_csr/spsolve.py:26``).

The reference delegates to ``jax.experimental.sparse.linalg.spsolve``
(cuSolver QR). This module dispatches by size instead, with the same code
on every platform:

- **direct** (``n <= dense_limit``, default 4096): densify and
  ``jnp.linalg.solve`` — fast and robust for the moderate
  conductance systems SNN models solve, but O(n^2) memory.
- **iterative** (above the limit, or ``method='iterative'``): matrix-free
  BiCGSTAB (``jax.scipy.sparse.linalg.bicgstab``) whose matvec is this
  library's own :func:`~brainevent_tpu.csrmv` primitive — O(nnz) memory
  per iteration at any scale, for large systems.
"""

import jax
import jax.numpy as jnp

from ._common import row_ids_from_indptr

__all__ = ['csr_solve']

# n above which the O(n^2) dense materialization is refused for 'auto'
_DENSE_LIMIT = 4096


def csr_solve(data, indices, indptr, b, tol=1e-6, reorder=1, *,
              method: str = 'auto', dense_limit: int = _DENSE_LIMIT,
              maxiter=None):
    """Solve ``A x = b`` with square ``A`` in CSR form.

    Parameters mirror the reference (``tol``/``reorder`` feed cuSolver on
    CUDA backends). ``method`` selects the path: ``'direct'``
    (dense solve, O(n^2) memory), ``'iterative'`` (matrix-free
    BiCGSTAB over :func:`csrmv`, O(nnz)), or ``'auto'`` — direct up to
    ``dense_limit`` unknowns, iterative beyond.
    """
    data = jnp.atleast_1d(jnp.asarray(data))
    n = indptr.shape[0] - 1
    if jax.default_backend() == 'gpu':  # pragma: no cover - CUDA only
        from jax.experimental.sparse.linalg import spsolve as _spsolve
        return _spsolve(data, indices, indptr, b, tol=tol, reorder=reorder)
    if method == 'auto':
        method = 'direct' if n <= dense_limit else 'iterative'
    if method == 'direct':
        if n > dense_limit:
            raise ValueError(
                f'csr_solve(method="direct") would materialize a dense '
                f'({n}, {n}) matrix ({n * n * 4 / 1e9:.1f} GB at f32); pass '
                f'method="iterative" (matrix-free BiCGSTAB) or raise '
                f'dense_limit explicitly.')
        nse = indices.shape[0]
        rows = row_ids_from_indptr(indptr, nse)
        d = jnp.broadcast_to(data, (nse,)) if data.shape[0] == 1 else data
        dense = jnp.zeros((n, n), dtype=d.dtype).at[rows, indices].add(d)
        return jnp.linalg.solve(dense, b)
    if method != 'iterative':
        raise ValueError(f"method must be 'auto', 'direct' or 'iterative', "
                         f"got {method!r}")
    from .float import csrmv

    def matvec(x):
        return csrmv(data, indices, indptr, x, shape=(n, n))

    x, _ = jax.scipy.sparse.linalg.bicgstab(
        matvec, b, tol=tol, maxiter=maxiter)
    return x
