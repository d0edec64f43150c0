# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""CSR/CSC sparse operator package (reference ``brainevent/_csr/``)."""

from .main import CompressedSparseData, CSR, CSC
from .binary import (
    binary_csrmv, binary_csrmv_p, binary_csrmv_p_call,
    binary_csrmm, binary_csrmm_p, binary_csrmm_p_call,
    binary_csrmv_indexed, binary_csrmv_indexed_p, binary_csrmv_indexed_p_call,
    binary_csrmm_indexed, binary_csrmm_indexed_p, binary_csrmm_indexed_p_call,
)
from .float import (
    csrmv, csrmv_p, csrmv_p_call,
    csrmm, csrmm_p, csrmm_p_call,
)
from .dt2t import (
    csrmv_dt2t, cscmv_dt2t, csrmv_dt2t_p, csrmv_dt2t_p_call,
    csrmm_dt2t, cscmm_dt2t, csrmm_dt2t_p, csrmm_dt2t_p_call,
)
from .plasticity import (
    update_csr_on_binary_pre, update_csr_on_binary_pre_p,
    update_csr_on_binary_post, update_csr_on_binary_post_p,
    update_csc_on_binary_pre, update_csc_on_binary_post,
)
from .slice import (
    csr_slice_rows, csr_slice_rows_p,
    csr_slice_rows_grad, csr_slice_rows_grad_p,
)
from .diag_add import csr_diag_position, csr_diag_add
from .spsolve import csr_solve

__all__ = [
    'CompressedSparseData', 'CSR', 'CSC',
    'binary_csrmv', 'binary_csrmv_p',
    'binary_csrmm', 'binary_csrmm_p',
    'binary_csrmv_indexed', 'binary_csrmv_indexed_p',
    'binary_csrmm_indexed', 'binary_csrmm_indexed_p',
    'csrmv', 'csrmv_p', 'csrmm', 'csrmm_p',
    'csrmv_dt2t', 'cscmv_dt2t', 'csrmv_dt2t_p',
    'csrmm_dt2t', 'cscmm_dt2t', 'csrmm_dt2t_p',
    'update_csr_on_binary_pre', 'update_csr_on_binary_pre_p',
    'update_csr_on_binary_post', 'update_csr_on_binary_post_p',
    'update_csc_on_binary_pre', 'update_csc_on_binary_post',
    'csr_slice_rows', 'csr_slice_rows_p',
    'csr_slice_rows_grad', 'csr_slice_rows_grad_p',
    'csr_diag_position', 'csr_diag_add', 'csr_solve',
]
