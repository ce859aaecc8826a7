"""Linear-algebra ops — the PyTorch twin of ``mxnet_tpu/ops/linalg.py``
(reference src/operator/tensor/la_op.*): _linalg_{gemm, gemm2, potrf,
potri, trmm, trsm, syrk, gelqf, sumlogdiag} and khatri_rao, batched over
leading axes by torch's matmul broadcasting.

``gelqf`` is the QR of Aᵀ (LAPACK Householder on the CPU, cuSOLVER on
the card): Q and L are unique only up to the signs of Q's rows.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


@register("_linalg_gemm", arg_names=("A", "B", "C"), aliases=("linalg_gemm",),
          defaults={"transpose_a": False, "transpose_b": False,
                    "alpha": 1.0, "beta": 1.0})
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, **_):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) + \
        beta * C


@register("_linalg_gemm2", arg_names=("A", "B"), aliases=("linalg_gemm2",),
          defaults={"transpose_a": False, "transpose_b": False,
                    "alpha": 1.0})
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **_):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("_linalg_potrf", arg_names=("A",), aliases=("linalg_potrf",))
def _potrf(A, **_):
    return torch.linalg.cholesky(A)


@register("_linalg_potri", arg_names=("A",), aliases=("linalg_potri",))
def _potri(A, **_):
    """Inverse of a SPD matrix given its Cholesky factor A (lower)."""
    ident = torch.eye(A.shape[-1], dtype=A.dtype,
                      device=A.device).expand(A.shape)
    linv = torch.linalg.solve_triangular(A, ident, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("_linalg_trmm", arg_names=("A", "B"), aliases=("linalg_trmm",),
          defaults={"transpose": False, "rightside": False, "alpha": 1.0})
def _trmm(A, B, transpose=False, rightside=False, alpha=1.0, **_):
    tri = _t(torch.tril(A), transpose)  # A assumed lower-triangular
    if rightside:
        return alpha * torch.matmul(B, tri)
    return alpha * torch.matmul(tri, B)


@register("_linalg_trsm", arg_names=("A", "B"), aliases=("linalg_trsm",),
          defaults={"transpose": False, "rightside": False, "alpha": 1.0})
def _trsm(A, B, transpose=False, rightside=False, alpha=1.0, **_):
    """Solves op(tril(A)) X = alpha B (or X op(tril(A)) = alpha B with
    ``rightside``), op the transpose when ``transpose``."""
    tri = torch.tril(A)
    if transpose:
        tri = tri.transpose(-1, -2)
    return torch.linalg.solve_triangular(tri, alpha * B,
                                         upper=bool(transpose),
                                         left=not rightside)


@register("_linalg_syrk", arg_names=("A",), aliases=("linalg_syrk",),
          defaults={"transpose": False, "alpha": 1.0})
def _syrk(A, transpose=False, alpha=1.0, **_):
    At = A.transpose(-1, -2)
    if transpose:
        return alpha * torch.matmul(At, A)
    return alpha * torch.matmul(A, At)


@register("_linalg_gelqf", arg_names=("A",), aliases=("linalg_gelqf",))
def _gelqf(A, **_):
    """LQ factorization: A = L Q with Q orthonormal rows. Returns (Q, L)
    in the reference's output order (la_op.cc:508 `Q, L = gelqf(A)`)."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return q.transpose(-1, -2), r.transpose(-1, -2)


@register("_linalg_sumlogdiag", arg_names=("A",),
          aliases=("linalg_sumlogdiag",))
def _sumlogdiag(A, **_):
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    return torch.sum(torch.log(diag), dim=-1)


@register("khatri_rao", arg_names=None,
          aliases=("_khatri_rao", "_contrib_krprod"))
def _khatri_rao(*args, **_):
    """Column-wise Khatri-Rao product (reference contrib krprod.h)."""
    out = args[0]
    for b in args[1:]:
        out = (out[:, None, :] * b[None, :, :]).reshape(-1, out.shape[-1])
    return out
