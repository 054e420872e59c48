"""Exact t-SNE on one device for the evaluation scripts' embedding plots
(counterpart of the single-device path of ``vae_los_angeles_tpu/ops/tsne.py``).

sklearn's default is Barnes-Hut, a host quadtree. At evaluation-cohort sizes
(hundreds to a few thousand samples) the exact O(n²) form is a few dense
(n × n) reductions a step, which the card does well:

  * input affinities: the squared-distance matrix through the product
    identity (fp32, TF32 off), then sklearn's per-point perplexity binary
    search vectorized over all rows (100 halving/doubling steps, rows frozen
    once within 1e-5 of the target entropy);
  * the descent: ``max_iter`` gradient steps, a Python loop on the device.
    Each builds the Student-t kernel from the embedding's distances and the
    gradient c·(diag(S·1) − S)·Y with S = (P−Q)∘W; adaptive gains (+0.2 /
    ×0.8, floor 0.01), momentum 0.5 → 0.8 and early exaggeration ×12 for the
    first 250 steps, the update and gains reset at that boundary, as
    sklearn's ``_gradient_descent`` runs its two phases.

As in the JAX package: no early exit (``min_grad_norm``), a Gram-PCA init
(`ops.pca`) rescaled so that the first component's σ is 1e-4, P and Q floored
at the float64 machine epsilon even in fp32 (as sklearn does), and the KL
reported against the un-exaggerated P.

Every stage takes (n, ·) or a leading member axis (M, n, ·):
`tsne_fit_transform_members` embeds M same-shaped feature spaces of one
cohort (the clustering flow's imputation methods) with one set of launches
a step for all of them, each member's arithmetic that of `TSNE`.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops.knn import _check_shard, _to_device
from vae_los_angeles_torch.ops.pca import _pca_gram

# sklearn floors P and Q at double-precision machine epsilon even though the
# arrays are float32 (sklearn.manifold._t_sne.MACHINE_EPSILON).
MACHINE_EPSILON = float(np.finfo(np.double).eps)

_EXPLORATION_ITERS = 250  # sklearn _EXPLORATION_MAX_ITER
_PERPLEXITY_STEPS = 100  # sklearn _binary_search_perplexity n_steps
_PERPLEXITY_TOL = 1e-5  # sklearn PERPLEXITY_TOLERANCE


def _offdiag(n, like):
    return 1.0 - torch.eye(n, dtype=like.dtype, device=like.device)


def _sq_distances(x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances through the product identity,
    clamped at 0, with an exactly zero diagonal."""
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[..., :, None] - 2.0 * torch.matmul(x, x.transpose(-1, -2))
    d2 = torch.clamp_min(d2 + sq[..., None, :], 0.0)
    return d2 * _offdiag(x.shape[-2], x)


def _total(a):
    """The sum of each (n, n) matrix, kept as (..., 1, 1)."""
    return torch.sum(a, dim=(-2, -1), keepdim=True)


def _perplexity_search(d2, include, perplexity):
    """Per-row precision search: (β, Σp) a row.

    Vectorized sklearn ``_binary_search_perplexity``: per row, 100
    halving/doubling steps on β = 1/(2σ²) towards the entropy
    log(perplexity) in nats, a row frozen once within 1e-5; Σexp floored at
    the machine epsilon, no max-subtraction before the exp. ``include`` is
    the 0/1 mask of the columns in each row's distribution."""
    desired_entropy = torch.log(torch.tensor(perplexity, dtype=d2.dtype, device=d2.device))

    def row_quantities(beta):
        p = torch.exp(-d2 * beta[..., None]) * include
        sum_p = torch.clamp_min(torch.sum(p, dim=-1), MACHINE_EPSILON)
        entropy = torch.log(sum_p) + beta * torch.sum(d2 * p, dim=-1) / sum_p
        return sum_p, entropy

    beta = torch.ones(d2.shape[:-1], dtype=d2.dtype, device=d2.device)
    beta_min = torch.full_like(beta, -torch.inf)
    beta_max = torch.full_like(beta, torch.inf)
    done = torch.zeros(d2.shape[:-1], dtype=torch.bool, device=d2.device)
    for _ in range(_PERPLEXITY_STEPS):
        _, entropy = row_quantities(beta)
        diff = entropy - desired_entropy
        done_now = done | (torch.abs(diff) <= _PERPLEXITY_TOL)
        too_high = diff > 0.0  # entropy too high: raise β (narrow the kernel)
        up = torch.where(torch.isinf(beta_max), beta * 2.0, (beta + beta_max) / 2.0)
        down = torch.where(torch.isinf(beta_min), beta / 2.0, (beta + beta_min) / 2.0)
        # frozen rows keep their state (sklearn breaks out of its loop)
        beta_min = torch.where(done_now | ~too_high, beta_min, beta)
        beta_max = torch.where(done_now | too_high, beta_max, beta)
        beta = torch.where(done_now, beta, torch.where(too_high, up, down))
        done = done_now
    sum_p, _ = row_quantities(beta)
    return beta, sum_p


def _conditional_probabilities(d2, perplexity):
    """Row-conditional affinities P_{j|i} at the perplexity, diagonal 0."""
    offdiag = _offdiag(d2.shape[-1], d2)
    beta, sum_p = _perplexity_search(d2, offdiag, perplexity)
    p = torch.exp(-d2 * beta[..., None]) * offdiag
    return p / sum_p[..., None]


def _joint_probabilities(d2, perplexity):
    """Symmetrized, normalized joint P with a zero diagonal, sklearn's
    ``_joint_probabilities``: max((C + Cᵀ)/ΣΣ, eps) off the diagonal."""
    cond = _conditional_probabilities(d2, perplexity)
    p = cond + cond.transpose(-1, -2)
    p = p / torch.clamp_min(_total(p), MACHINE_EPSILON)
    return torch.clamp_min(p, MACHINE_EPSILON) * _offdiag(d2.shape[-1], d2)


def _apply_update(grad, update, gains, lr, i: int):
    """sklearn ``_gradient_descent``'s state rule at step ``i``: the update
    and gains reset at the phase boundary, adaptive gains, momentum 0.5 in
    the exaggerated phase, then 0.8."""
    if i == _EXPLORATION_ITERS:
        update, gains = torch.zeros_like(update), torch.ones_like(gains)
    inc = update * grad < 0.0
    gains = torch.clamp_min(torch.where(inc, gains + 0.2, gains * 0.8), 0.01)
    momentum = 0.5 if i < _EXPLORATION_ITERS else 0.8
    return momentum * update - lr * (gains * grad), gains


def _student_t(y, dof: float):
    """(Q, W) of the embedding: W = (1 + d²/dof)^(−(dof+1)/2) off the
    diagonal, Q = max(W/ΣW, eps) off the diagonal."""
    offdiag = _offdiag(y.shape[-2], y)
    w = (1.0 + _sq_distances(y) / dof) ** (-(dof + 1.0) / 2.0) * offdiag
    q = torch.clamp_min(w / torch.clamp_min(_total(w), MACHINE_EPSILON),
                        MACHINE_EPSILON) * offdiag
    return q, w


def _gradient(p_eff, y, dof: float):
    """c·(diag(S·1) − S)·Y with S = (P_eff − Q)∘W and c = 2(dof+1)/dof."""
    q, w = _student_t(y, dof)
    s = (p_eff - q) * w
    return 2.0 * (dof + 1.0) / dof * (y * torch.sum(s, dim=-1, keepdim=True)
                                      - torch.matmul(s, y))


def _step(p, y, update, gains, lr, early_exaggeration, i: int, dof: float):
    """Gradient step ``i`` of the descent: (Y, update, gains) after it."""
    p_eff = p * early_exaggeration if i < _EXPLORATION_ITERS else p
    update, gains = _apply_update(_gradient(p_eff, y, dof), update, gains, lr, i)
    return y + update, update, gains


def _optimize(p, y0, lr, early_exaggeration, max_iter: int, dof: float):
    """All ``max_iter`` steps from (y0, update 0, gains 1): (Y, KL), the KL
    (one a member) taken against the un-exaggerated P on the final
    embedding."""
    y, update, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    for i in range(max_iter):
        y, update, gains = _step(p, y, update, gains, lr, early_exaggeration, i, dof)
    q, _ = _student_t(y, dof)
    # the diagonal of q is 0: floor it for the ratio, so that it adds 0·log 1
    kl = torch.sum(p * torch.log(torch.clamp_min(p, MACHINE_EPSILON)
                                 / torch.clamp_min(q, MACHINE_EPSILON)), dim=(-2, -1))
    return y, kl


def _pca_init(x, n_components: int):
    """sklearn's PCA init: Gram-PCA scores (columns past the rank zero),
    rescaled so that the first component's σ is 1e-4."""
    scores, _ = _pca_gram(x, min(n_components, x.shape[-2]))
    scores = torch.nn.functional.pad(scores, (0, n_components - scores.shape[-1]))
    first = scores[..., 0]
    std0 = torch.sqrt(torch.mean((first - torch.mean(first, dim=-1, keepdim=True)) ** 2, dim=-1))
    return scores / torch.clamp_min(std0, torch.finfo(torch.float32).tiny)[..., None, None] * 1e-4


class TSNE:
    """sklearn-``TSNE`` surface for ``fit_transform``, the way the scripts
    call it: exact t-SNE on one device (``device``, `resolve_device`: the card
    unless the CPU is asked for). ``method``, ``angle`` and ``n_jobs`` are
    accepted and ignored; ``shard=True`` (multi-device) raises."""

    def __init__(self, n_components: int = 2, *, perplexity: float = 30.0,
                 early_exaggeration: float = 12.0, learning_rate="auto", max_iter: int = 1000,
                 init="pca", random_state=None, metric: str = "euclidean",
                 method: str = "exact", angle: float = 0.5, n_jobs=None, verbose: int = 0,
                 shard=None, device=None):
        if metric != "euclidean":
            raise ValueError(f"TSNE supports metric='euclidean' only, got {metric!r} "
                             "(the reference call sites use the default metric)")
        self.n_components = int(n_components)
        self.perplexity = float(perplexity)
        self.early_exaggeration = float(early_exaggeration)
        self.learning_rate = learning_rate
        self.max_iter = int(max_iter)
        self.init = init
        self.random_state = random_state
        self.verbose = verbose
        self.shard = shard
        self.device = device
        self.kl_divergence_ = None
        self.embedding_ = None

    def _initial_embedding(self, x):
        n = x.shape[0]
        if isinstance(self.init, np.ndarray):
            return _to_device(self.init, x.device)
        if isinstance(self.init, str) and self.init == "pca":
            return _pca_init(x, self.n_components)
        if isinstance(self.init, str) and self.init == "random":
            rs = np.random.RandomState(self.random_state)
            y = (1e-4 * rs.standard_normal((n, self.n_components))).astype(np.float32)
            return _to_device(y, x.device)
        raise ValueError(f"init must be 'pca', 'random' or an array, got {self.init!r}")

    def fit_transform(self, X, y=None) -> np.ndarray:
        _check_shard(self.shard)
        x = _to_device(X, resolve_device(self.device))
        lr = _learning_rate(x.shape[0], self.perplexity, self.early_exaggeration,
                            self.learning_rate)
        emb, kl = _embed(x, self._initial_embedding(x), self.n_components, self.perplexity,
                         self.early_exaggeration, lr, self.max_iter)
        self.kl_divergence_ = float(kl)
        self.embedding_ = emb.cpu().numpy()
        if self.verbose:
            print(f"[t-SNE] n={x.shape[0]} KL={self.kl_divergence_:.4f}")
        return self.embedding_


def _learning_rate(n: int, perplexity: float, early_exaggeration: float, learning_rate) -> float:
    """sklearn ``TSNE._fit``'s checks of ``n_samples`` and the perplexity,
    and its learning rate: max(n / early_exaggeration / 4, 50) for "auto"."""
    if n <= 1:
        raise ValueError("t-SNE requires at least 2 samples")
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    if learning_rate == "auto":
        return max(n / early_exaggeration / 4.0, 50.0)
    return float(learning_rate)


def _embed(x, y0, n_components, perplexity, early_exaggeration, lr, max_iter):
    """Affinities of ``x`` (..., n, d), then the descent from ``y0``."""
    dof = float(max(n_components - 1, 1))
    p = _joint_probabilities(_sq_distances(x), float(perplexity))
    return _optimize(p, y0, lr, float(early_exaggeration), int(max_iter), dof)


def tsne_fit_transform_members(x_members, *, n_components: int = 2, perplexity: float = 30.0,
                               early_exaggeration: float = 12.0, learning_rate="auto",
                               max_iter: int = 1000, device=None):
    """Exact t-SNE of M same-shaped feature spaces (M, n, d) at once, PCA
    init (the JAX package's ``tsne_fit_transform_members``): one set of
    launches a step for all members, each member's arithmetic that of
    `TSNE` (the same checks, learning rate, dof and ``max_iter``). The
    descent is chaotic, so a member matches its single run statistically,
    not bit for bit. Returns (embeddings (M, n, n_components), KL (M,)) as
    numpy."""
    x = _to_device(x_members, resolve_device(device))
    lr = _learning_rate(x.shape[1], float(perplexity), float(early_exaggeration), learning_rate)
    emb, kl = _embed(x, _pca_init(x, n_components), n_components, perplexity,
                     early_exaggeration, lr, max_iter)
    return emb.cpu().numpy(), kl.cpu().numpy()


def resolve_tsne(n_rows=None):
    """The t-SNE class the scripts instantiate: always `TSNE` (the port has
    no host route; ``n_rows`` is accepted for the JAX package's call
    sites)."""
    return TSNE
