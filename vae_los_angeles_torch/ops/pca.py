"""Standardization and Gram-matrix PCA on the device (counterpart of the
single-device part of ``vae_los_angeles_tpu/ops/pca.py``).

With n samples ≪ d features, the economy SVD of the centred matrix is the
eigendecomposition of its n × n Gram matrix: one fp32 product (TF32 off,
``vae_los_angeles_torch.device``) and ``torch.linalg.eigh``, whose cost does
not grow with the feature width. Scores = U_k·S_k; the explained variance
ratio is λ_k / trace(G); the feature-space components are never formed.

Sign rule (the JAX package's, not sklearn's ``svd_flip``): each score column
is flipped so that its largest-magnitude entry is positive.

Every function takes (n, d) or a leading member axis (M, n, d): the
population functions (`standardize_members`, `pca_scores_members`) are the
same code over M same-shaped feature spaces, one batched product for the
Gram matrices and one batched ``torch.linalg.eigh``.

Several devices (`PCA` under a process group of two or more ranks,
``ops.knn._eval_mesh``'s policy): the feature columns split over the ranks,
zero-padded to a multiple of their count (a zero column adds nothing to the
Gram matrix or its trace), each rank centres its columns and forms its
partial n × n Gram matrix, and one all-reduce sums them; every rank then
takes the same eigendecomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device  # importing it turns TF32 off
from vae_los_angeles_torch.ops.knn import _eval_mesh, _to_device


def standardize(x: torch.Tensor) -> torch.Tensor:
    """sklearn-StandardScaler semantics over the rows of each (n, d)
    matrix: per-feature zero mean, population std (ddof = 0); zero-variance
    features get scale 1."""
    x = x.to(torch.float32)
    centered = x - torch.mean(x, dim=-2, keepdim=True)
    std = torch.sqrt(torch.mean(centered * centered, dim=-2, keepdim=True))
    return centered / torch.where(std == 0.0, 1.0, std)


def _gram(x: torch.Tensor) -> torch.Tensor:
    """The n × n Gram matrix of each (n, d) matrix's centred columns."""
    x = x.to(torch.float32)
    x_c = x - torch.mean(x, dim=-2, keepdim=True)
    return torch.matmul(x_c, x_c.transpose(-1, -2))


def _pca_gram(x: torch.Tensor, n_components: int):
    """(scores (..., n, k), explained variance ratio (..., k)) through each
    n × n Gram matrix's eigendecomposition, with the sign rule above."""
    return _pca_from_gram(_gram(x), n_components)


def _column_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``x``'s columns, zero-padded to ceil(d / ranks)."""
    d = x.shape[-1]
    per = -(-d // mesh.size)
    block = x[..., mesh.data_index * per:(mesh.data_index + 1) * per]
    return torch.nn.functional.pad(block, (0, per - block.shape[-1]))


def _pca_from_gram(gram: torch.Tensor, n_components: int):
    eigval, eigvec = torch.linalg.eigh(gram)  # ascending
    lam = torch.clamp_min(eigval.flip(-1)[..., :n_components], 0.0)
    scores = eigvec.flip(-1)[..., :n_components] * torch.sqrt(lam).unsqueeze(-2)
    flip_idx = torch.argmax(torch.abs(scores), dim=-2, keepdim=True)
    signs = torch.sign(torch.gather(scores, -2, flip_idx))
    scores = scores * torch.where(signs == 0.0, 1.0, signs)
    trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    return scores, lam / torch.clamp_min(trace, torch.finfo(torch.float32).tiny)


def standardize_members(x_members: torch.Tensor) -> torch.Tensor:
    """`standardize` of M feature spaces (M, n, d) at once (the JAX
    package's ``standardize_members``)."""
    return standardize(x_members)


def pca_scores_members(x_members: torch.Tensor, n_components: int):
    """`_pca_gram` of M feature spaces (M, n, d) at once: ((M, n, k),
    (M, k)), one batched Gram product and one batched eigh (the JAX
    package's ``pca_scores_members``)."""
    return _pca_gram(x_members, n_components)


class PCA:
    """sklearn-``PCA`` surface for ``fit_transform`` (the way the scripts use
    it); ``random_state`` is accepted (the Gram path is deterministic). Runs
    on ``device`` (`resolve_device`: the card unless the CPU is asked for);
    a tensor already there is not copied. ``shard`` as the kNN estimators'
    (module docstring)."""

    def __init__(self, n_components: int = 2, random_state=None, device=None, shard=None):
        self.n_components = n_components
        self.random_state = random_state
        self.device = device
        self.shard = shard
        self.explained_variance_ratio_ = None

    def fit_transform(self, X) -> np.ndarray:
        mesh = _eval_mesh(self.shard)
        x = _to_device(X, resolve_device(self.device))
        k = min(self.n_components, x.shape[0], x.shape[1])
        if mesh is None:
            scores, evr = _pca_gram(x, k)
        else:
            scores, evr = _pca_from_gram(mesh.psum(_gram(_column_block(x, mesh)), "data"), k)
        self.explained_variance_ratio_ = evr.cpu().numpy()
        return scores.cpu().numpy()
