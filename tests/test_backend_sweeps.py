# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""GPU-route audit: every registered primitive, every benchmark config.

For each primitive and each configuration its benchmark-data generator
yields for ``platform='gpu'``, the backend the GPU resolves to with no
request must be a real kernel registered for the GPU, and that same kernel
(the generator the CPU registration shares), run here on the CPU, must
match a plain reference: the sparse, implicit or event operand is turned
into a dense matrix (or, for the large sizes, its COO triplets) and a 0/1
mask in NumPy, and the product is taken in float64. Implicit (JITC)
matrices are densified by their materializer, which is itself checked
against the separately generated CSR form.

The case list is built from the registry alone; nothing here asks JAX
which device it runs on while the module is imported.
"""

import functools

import jax
import numpy as np
import pytest

import brainevent_tpu as be

_PLATFORM = 'gpu'


@functools.lru_cache(maxsize=None)
def _configs(name):
    return tuple(be.get_registry()[name]._benchmark_data_fn(
        platform=_PLATFORM))


def _cases():
    cases = []
    for name, prim in sorted(be.get_registry().items()):
        if prim._benchmark_data_fn is None or prim._call_fn is None:
            continue
        for ci, cfg in enumerate(_configs(name)):
            cases.append(pytest.param(name, ci, id=f'{name}-{cfg.name}'))
    return cases


# ---------------------------------------------------------------------------
# dense helpers (NumPy, float64)
# ---------------------------------------------------------------------------

def _np(x):
    return np.asarray(x)


def _gate(x):
    x = _np(x)
    return (x > 0).astype(np.float64)


def _csr_rows(indptr):
    indptr = _np(indptr)
    return np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))


def _csr_dense(w, indices, indptr, shape):
    rows = _csr_rows(indptr)
    w = _np(w).astype(np.float64)
    w = np.broadcast_to(w, rows.shape) if w.size == 1 else w
    dense = np.zeros(shape)
    np.add.at(dense, (rows, _np(indices)), w)
    return dense


def _product(dense, x, transpose):
    return (dense.T if transpose else dense) @ x


def _coo_product(rows, cols, w, x, shape, transpose):
    """``A @ x`` (or ``A.T @ x``) for ``A[rows, cols] += w`` without
    materializing ``A`` (the 40k-square rows would not fit)."""
    w = _np(w).astype(np.float64).reshape(-1)
    w = np.broadcast_to(w, rows.shape) if w.size == 1 else w
    src, dst, n_out = (rows, cols, shape[1]) if transpose else \
        (cols, rows, shape[0])
    x = _np(x).astype(np.float64)
    out = np.zeros((n_out,) + x.shape[1:])
    contrib = w.reshape((-1,) + (1,) * (x.ndim - 1)) * x[src]
    np.add.at(out, dst, contrib)
    return out


# ---------------------------------------------------------------------------
# references: name -> (args, kwargs) -> tuple of expected outputs, or a
# callable check(got) for encoders whose padding is unspecified
# ---------------------------------------------------------------------------

def _ref_csr(name, args, kw):
    shape, tr = kw.get('shape'), kw.get('transpose', False)
    if name in ('binary_csrmv', 'binary_csrmm', 'csrmv', 'csrmm'):
        w, idx, ptr, x = args
        x = _gate(x) if name.startswith('binary') else _np(x)
        return (_coo_product(_csr_rows(ptr), _np(idx), w, x, shape, tr),)
    if name in ('binary_csrmv_indexed', 'binary_csrmm_indexed'):
        w, idx, ptr, perm, x = args
        w_eff = _np(w)[_np(perm)]
        return (_coo_product(_csr_rows(ptr), _np(idx), w_eff, _gate(x),
                             shape, tr),)
    if name in ('csrmv_dt2t', 'csrmm_dt2t'):
        y, w, idx, ptr = args
        pos = _np(idx) if tr else _csr_rows(ptr)
        w = _np(w).astype(np.float64)
        w = np.broadcast_to(w, pos.shape) if w.size == 1 else w
        y = _np(y)
        return ((w[:, None] * y[pos]) if y.ndim == 2 else w * y[pos],)
    if name == 'update_csr_on_binary_pre':
        w, idx, ptr, pre, post_trace = args
        rows = _csr_rows(ptr)
        return (_np(w) + _gate(pre)[rows] * _np(post_trace)[_np(idx)],)
    if name == 'update_csr_on_binary_post':
        w, idx, ptr, _, pre_trace, post = args
        rows = _csr_rows(ptr)
        return (_np(w) + _np(pre_trace)[rows] * _gate(post)[_np(idx)],)
    if name == 'csr_slice_rows':
        w, idx, ptr, sel = args
        return (_csr_dense(w, idx, ptr, shape)[_np(sel)],)
    if name == 'csr_slice_rows_grad':
        ct, idx, ptr, sel = args
        rows, cols = _csr_rows(ptr), _np(idx)
        ct = _np(ct)
        grad = np.zeros(kw['data_len'])
        for r, row in enumerate(_np(sel)):
            hit = rows == row
            grad[hit] += ct[r, cols[hit]]
        return (grad,)
    raise KeyError(name)


def _ref_dense(name, args, kw):
    if name in ('binary_densemv', 'binary_densemm'):
        w, s = args
        return (_product(_np(w), _gate(s), kw['transpose']),)
    if name == 'update_dense_on_binary_pre':
        w, pre, post_trace = args
        return (_np(w) + np.outer(_gate(pre), _np(post_trace)),)
    if name == 'update_dense_on_binary_post':
        w, pre_trace, post = args
        return (_np(w) + np.outer(_np(pre_trace), _gate(post)),)
    raise KeyError(name)


def _ref_fcn(name, args, kw):
    if name == 'fcn_plasticity_row':
        w, idx, spk, trace = args
        return (_np(w) + _gate(spk)[:, None] * _np(trace)[_np(idx)],)
    w, idx, x = args
    idx = _np(idx)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
    x = _gate(x) if name.startswith('binary') else _np(x)
    return (_coo_product(rows, idx.reshape(-1), w, x, kw['shape'],
                         kw.get('transpose', False)),)


def _jitc_dense(tag, params, clen, seed, shape, transpose=False,
                corder=True, matrix_mode='mv'):
    dense_p = be.get_registry()[f'jit{tag}']
    (dense,) = dense_p._call_fn(*params, clen, seed, shape=shape,
                                transpose=transpose, corder=corder,
                                matrix_mode=matrix_mode, backend='jax_raw')
    return _np(dense).astype(np.float64)


def _jitc_csr(tag, params, clen, seed, shape, corder=True,
              matrix_mode='mv'):
    reg = be.get_registry()
    (counts,) = reg[f'jit{tag}_csr_count']._call_fn(
        *params, clen, seed, shape=shape, corder=corder,
        matrix_mode=matrix_mode, backend='jax_raw')
    nse = int(_np(counts).sum())
    data, indices, indptr = reg[f'jit{tag}_csr_fill']._call_fn(
        *params, clen, seed, shape=shape, nse=nse, corder=corder,
        matrix_mode=matrix_mode, backend='jax_raw')
    return _np(data)[:nse], _np(indices)[:nse], _np(indptr)


def _ref_jitc(name, args, kw):
    binary = name.startswith('binary_')
    base = name[len('binary_'):] if binary else name
    tag = base[3]
    npar = 1 if tag == 's' else 2
    params, clen = args[:npar], args[npar]
    shape = kw['shape']
    tr, corder = kw.get('transpose', False), kw.get('corder', True)
    if base == f'jit{tag}':
        data, indices, indptr = _jitc_csr(tag, params, clen, args[npar + 1],
                                          shape)
        return (_csr_dense(data, indices, indptr, shape),)
    if base == f'jit{tag}_csr_count':
        dense = _jitc_dense(tag, params, clen, args[npar + 1], shape)
        return ((dense != 0).sum(axis=1),)
    if base == f'jit{tag}_csr_fill':
        dense = _jitc_dense(tag, params, clen, args[npar + 1], shape)
        rows, cols = np.nonzero(dense)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows, minlength=shape[0]))])
        return (dense[rows, cols], cols, indptr)
    operand, seed = args[npar + 1], args[npar + 2]
    if base == f'jit{tag}mv_dt2t':
        data, indices, indptr = _jitc_csr(tag, params, clen, seed, shape)
        pos = indices if tr else _csr_rows(indptr)
        return (data * _np(operand)[pos],)
    x = _gate(operand) if binary else _np(operand)
    if base in (f'jit{tag}mv', f'jit{tag}mv_plan', f'jit{tag}mm_plan'):
        mode = 'mv'
    elif base == f'jit{tag}mm':
        mode = 'mm'
    else:
        raise KeyError(name)
    dense = _jitc_dense(tag, params, clen, seed, shape, transpose=tr,
                        corder=corder, matrix_mode=mode)
    return (dense @ x,)


def _check_encoder(name, args, got):
    spk = _np(args[0]).astype(bool)
    if name == 'binary_1d_array_index':
        ids, cnt = got
        np.testing.assert_array_equal(_np(ids)[:int(cnt[0])],
                                      np.flatnonzero(spk))
        return
    if name in ('binary_2d_compact_only', 'binary_2d_array_index'):
        *packed, ids, cnt = got
        np.testing.assert_array_equal(_np(ids)[:int(cnt[0])],
                                      np.flatnonzero(spk.any(axis=1)))
        if packed:
            bits = (_np(packed[0])[:, :, None]
                    >> np.arange(32, dtype=np.uint32)) & 1
            np.testing.assert_array_equal(
                bits.reshape(spk.shape[0], -1)[:, :spk.shape[1]], spk)
        return
    if name == 'binary_2d_pair_stream_encode':
        pairs, cnt = got
        np.testing.assert_array_equal(_np(pairs)[:int(cnt[0])],
                                      np.argwhere(spk))
        return
    if name == 'binary_2d_row_sparse_encode':
        (table,) = got
        want = np.zeros(spk.shape, np.int64)
        for r in range(spk.shape[0]):
            cols = np.flatnonzero(spk[r]) + 1
            want[r, :cols.size] = cols
        np.testing.assert_array_equal(_np(table), want)
        return
    if name == 'binary_2d_csr_row_count':
        np.testing.assert_array_equal(_np(got[0]), spk.sum(axis=1))
        return
    if name == 'binary_2d_csr_fill':
        (indices,) = got
        nnz = int(spk.sum())
        np.testing.assert_array_equal(_np(indices)[:nnz],
                                      np.nonzero(spk)[1])
        return
    if name == 'binary_2d_csc_encode':
        indices, indptr = got
        cols, rows = np.nonzero(spk.T)
        np.testing.assert_array_equal(_np(indices)[:rows.size], rows)
        np.testing.assert_array_equal(
            _np(indptr), np.concatenate([[0], np.cumsum(spk.sum(axis=0))]))
        return
    raise KeyError(name)


def _reference(name, args, kw):
    if 'jit' in name:
        return _ref_jitc(name, args, kw)
    if 'dense' in name:
        return _ref_dense(name, args, kw)
    if 'fcn' in name:
        return _ref_fcn(name, args, kw)
    return _ref_csr(name, args, kw)


@pytest.mark.parametrize('name,ci', _cases())
def test_gpu_route_matches_dense_reference(name, ci):
    prim = be.get_registry()[name]
    backend = prim._resolve_backend(_PLATFORM, None)
    assert backend in prim.available_backends(_PLATFORM)
    # the GPU's kernel is the generator the CPU registration runs here
    assert (prim._kernels[_PLATFORM][backend].generator
            is prim._kernels['cpu'][backend].generator)
    cfg = _configs(name)[ci]
    with jax.default_matmul_precision('highest'):
        got = prim._call_fn(*cfg.args, backend=backend, **cfg.kwargs)
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    if name.startswith('binary_') and name[len('binary_'):].startswith(
            ('1d', '2d')):
        _check_encoder(name, cfg.args, got)
        return
    want = _reference(name, cfg.args, cfg.kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, f'{name}: {g.shape} != {w.shape}'
        if np.issubdtype(g.dtype, np.floating):
            scale = max(1.0, float(np.max(np.abs(w))) if w.size else 1.0)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('name', sorted(
    n for n, p in be.get_registry().items()
    if p._benchmark_data_fn is not None))
def test_benchmark_data_well_formed(name):
    """Every generator yields configs whose args run under the call fn."""
    prim = be.get_registry()[name]
    cfg = _configs(name)[0]
    out = prim._call_fn(*cfg.args, **cfg.kwargs)
    out = out if isinstance(out, (tuple, list)) else (out,)
    assert out
    if cfg.loop_arg >= 0:
        assert cfg.loop_arg < len(cfg.args)


def test_registry_covers_reference_primitive_list():
    """All 51 reference primitive names are registered (SURVEY 2.10)."""
    reg = set(be.get_registry())
    reference_names = [
        'binary_csrmv', 'binary_csrmm', 'binary_csrmv_indexed',
        'binary_csrmm_indexed', 'csrmv', 'csrmm', 'csrmv_dt2t',
        'csrmm_dt2t', 'update_csr_on_binary_pre',
        'update_csr_on_binary_post', 'csr_slice_rows',
        'csr_slice_rows_grad', 'binary_densemv', 'binary_densemm',
        'update_dense_on_binary_pre', 'update_dense_on_binary_post',
        'binary_1d_array_index', 'binary_2d_array_index',
        'binary_2d_compact_only', 'binary_2d_csc_encode',
        'binary_2d_csr_fill', 'binary_2d_csr_row_count',
        'binary_2d_pair_stream_encode', 'binary_2d_row_sparse_encode',
        'binary_fcnmv', 'binary_fcnmm', 'fcn_plasticity_row',
    ] + [f'jit{t}{s}' for t in 'snu'
         for s in ('', 'mv', 'mm', '_csr_count', '_csr_fill', 'mv_dt2t')] \
      + [f'binary_jit{t}{s}' for t in 'snu' for s in ('mv', 'mm')]
    missing = [n for n in reference_names if n not in reg]
    assert not missing, f'missing from registry: {missing}'
    assert len(reference_names) == 51


def test_every_primitive_has_a_gpu_kernel():
    """No primitive leaves the GPU without a kernel."""
    for name, prim in be.get_registry().items():
        assert prim.available_backends(_PLATFORM), name
