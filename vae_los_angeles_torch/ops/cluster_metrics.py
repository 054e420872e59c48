"""Clustering-quality metrics on the device: silhouette and neighbourhood
hit (counterpart of the single-device part of
``vae_los_angeles_tpu/ops/cluster_metrics.py``).

The reference scores a clustering with host sklearn on the full-width
scaled matrix: an O(n²·dim) distance pass that at methylome width is the
slowest step of the clustering scripts. Both metrics reduce the distance
matrix, so here it is built a chunk of ``CHUNK`` query rows at a time (the
n × n matrix never exists) through the product identity
‖q − x‖² = ‖q‖² − 2 q·xᵀ + ‖x‖² in true fp32 (TF32 off, ``device``):

  * silhouette: the chunk's distances times the label one-hot give each
    row's distance sum to every cluster; a(i), b(i) and s(i) follow in
    float64 on the host (`_silhouette_from_sums`), singletons scoring 0;
  * neighbourhood hit: ``torch.topk`` over the self-masked squared
    distances, then the neighbours' label agreement.

The self column is forced to 0 (in the sums) or +inf (in the top-k): the
identity leaves a cancellation residue of ~eps·‖x‖² on the diagonal.
Euclidean only, as the reference.

Wide widths: at ``dim >= COMPENSATED_MIN_DIM`` (or ``compensated=True``) the
distances are summed over 8,192-wide feature blocks instead
(`_d2_blocked`): each block's partial distance clamped at 0 (a cancellation
bounded by the block's norms, not the whole row's), the partials
Kahan-summed across blocks. The JAX package's contract for that path is a
silhouette within 5e-4 of a float64 computation at dim ≥ 100k; it measured
its drift on a TPU, where most of it came from bf16 product passes, which
this port does not make.

`cluster_scores` computes both metrics from one distance block a chunk;
`cluster_scores_members` scores M feature spaces of one cohort (a leading
member axis), one batched product a chunk for all of them. The functions
run on ``device`` (`resolve_device`: the card unless the CPU is asked for);
``shard=True`` (multi-device) raises. There is no row bucketing: the JAX
package pads rows to share compiled programs, which the port does not
compile.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops.knn import _check_shard, _to_device

CHUNK = 1024  # query rows a distance block
# Widths at or above this sum the distances block by block (methylome-scale
# matrices); the CV-width cohorts stay on the plain identity.
COMPENSATED_MIN_DIM = 16384
_FEATURE_BLOCK = 8192


def _d2_blocked(queries, x, block: int = _FEATURE_BLOCK):
    """Squared distances (..., m, n) summed over ``block``-wide feature
    slices: each slice's partial distance through the product identity,
    clamped at 0, the partials Kahan-summed (the JAX package's
    ``_d2_blocked``)."""
    total = comp = None
    for s in range(0, queries.shape[-1], block):
        qc, xc = queries[..., s:s + block], x[..., s:s + block]
        q_sq = torch.sum(qc * qc, dim=-1, keepdim=True)
        x_sq = torch.sum(xc * xc, dim=-1).unsqueeze(-2)
        part = torch.clamp_min(q_sq - 2.0 * torch.matmul(qc, xc.transpose(-1, -2)) + x_sq, 0.0)
        if total is None:
            total, comp = part, torch.zeros_like(part)
            continue
        y = part - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total


def _resolve_compensated(compensated, dim: int) -> bool:
    if compensated is None:
        return dim >= COMPENSATED_MIN_DIM
    return bool(compensated)


def _chunk_d2(x, x_sq, block, compensated: bool):
    """One query chunk's squared distances (..., m, n): the plain identity
    or the compensated wide-width path."""
    if compensated:
        return _d2_blocked(block, x)
    q_sq = torch.sum(block * block, dim=-1, keepdim=True)
    cross = torch.matmul(block, x.transpose(-1, -2))
    return torch.clamp_min(q_sq - 2.0 * cross + x_sq.unsqueeze(-2), 0.0)


def _preamble(labels, n: int, dim: int, compensated, check_count: bool = True):
    """(label indices, label count, per-label counts, compensated) with the
    silhouette's label-count rule (sklearn's: 2..n-1 labels)."""
    uniq, lab_idx = np.unique(np.asarray(labels), return_inverse=True)
    n_labels = len(uniq)
    if check_count and not 1 < n_labels < n:
        raise ValueError(f"Number of labels is {n_labels}; valid values are 2..{n - 1}")
    counts = np.bincount(lab_idx, minlength=n_labels).astype(np.float64)
    return lab_idx, n_labels, counts, _resolve_compensated(compensated, dim)


def _sweep(x, lab_idx, n_labels, chunk_size, compensated, k=None, sums=True):
    """Walk the query chunks of ``x`` (..., n, d): the per-cluster distance
    sums (..., n, L) when ``sums``, and the neighbourhood-hit fractions
    (..., n) of the k nearest when ``k`` is given, as float64 numpy."""
    n = x.shape[-2]
    x_sq = torch.sum(x * x, dim=-1)
    lab = torch.as_tensor(lab_idx, dtype=torch.int64, device=x.device)
    onehot = torch.nn.functional.one_hot(lab, n_labels).to(x.dtype) if sums else None
    cols = torch.arange(n, device=x.device)
    out_sums, out_fracs = [], []
    for start in range(0, n, chunk_size):
        block = x[..., start:start + chunk_size, :]
        m = block.shape[-2]
        self_mask = cols[None, :] == (start + torch.arange(m, device=x.device))[:, None]
        d2 = _chunk_d2(x, x_sq, block, compensated)
        if sums:
            d = torch.where(self_mask, 0.0, torch.sqrt(d2))
            out_sums.append(torch.matmul(d, onehot).cpu())
        if k is not None:
            idx = torch.topk(torch.where(self_mask, torch.inf, d2), k, dim=-1,
                             largest=False).indices
            hits = lab[idx] == lab[start:start + m, None]
            out_fracs.append(torch.mean(hits.to(torch.float32), dim=-1).cpu())
    return (torch.cat(out_sums, dim=-2).numpy().astype(np.float64) if sums else None,
            torch.cat(out_fracs, dim=-1).numpy().astype(np.float64) if k is not None else None)


def _silhouette_from_sums(sums, lab_idx, counts) -> float:
    """Per-cluster distance sums (n, L) → mean silhouette (host O(n·L))."""
    n = len(lab_idx)
    own = counts[lab_idx]
    a = sums[np.arange(n), lab_idx] / np.maximum(own - 1.0, 1.0)
    means = sums / counts[None, :]
    means[np.arange(n), lab_idx] = np.inf  # exclude own cluster from b
    b = means.min(axis=1)
    s = (b - a) / np.maximum(np.maximum(a, b), np.finfo(np.float64).tiny)
    s = np.where(own == 1, 0.0, s)  # sklearn: singleton clusters score 0
    return float(s.mean())


def _features(features, device):
    return _to_device(features, resolve_device(device))


def silhouette_score(features, labels, chunk_size: int = CHUNK, shard=None, compensated=None,
                     device=None) -> float:
    """Mean silhouette coefficient, euclidean, as sklearn's
    ``silhouette_score`` (the JAX package's ``silhouette_score_tpu``):
    s(i) = (b − a)/max(a, b), a the mean distance to the own cluster (self
    excluded), b the smallest mean distance to another; singletons score 0;
    2..n-1 labels or a ValueError. ``compensated``: None picks the blocked
    path at ``dim >= COMPENSATED_MIN_DIM``, True/False force it."""
    _check_shard(shard)
    x = _features(features, device)
    lab_idx, n_labels, counts, comp = _preamble(labels, x.shape[0], x.shape[1], compensated)
    sums, _ = _sweep(x, lab_idx, n_labels, chunk_size, comp)
    return _silhouette_from_sums(sums, lab_idx, counts)


def neighborhood_hit(features, labels, k: int = 5, chunk_size: int = CHUNK, shard=None,
                     compensated=None, device=None) -> float:
    """Mean fraction of each row's k nearest neighbours (self excluded)
    sharing its label (the JAX package's ``neighborhood_hit_tpu``, the
    reference's ``metrics_utils`` semantics); 0.0 below k + 1 rows."""
    _check_shard(shard)
    if len(features) < k + 1:
        return 0.0
    x = _features(features, device)
    lab_idx, n_labels, _, comp = _preamble(labels, x.shape[0], x.shape[1], compensated,
                                           check_count=False)
    _, fracs = _sweep(x, lab_idx, n_labels, chunk_size, comp, k=k, sums=False)
    return float(fracs.mean())


def cluster_scores(features, labels, k: int = 5, chunk_size: int = CHUNK, shard=None,
                   compensated=None, device=None):
    """(silhouette, neighbourhood hit) from one distance block a chunk (the
    JAX package's ``cluster_scores_tpu``): the silhouette's label rule
    applies, the hit is 0.0 below k + 1 rows."""
    _check_shard(shard)
    x = _features(features, device)
    lab_idx, n_labels, counts, comp = _preamble(labels, x.shape[0], x.shape[1], compensated)
    k_or_none = k if x.shape[0] >= k + 1 else None
    sums, fracs = _sweep(x, lab_idx, n_labels, chunk_size, comp, k=k_or_none)
    nh = 0.0 if fracs is None else float(fracs.mean())
    return _silhouette_from_sums(sums, lab_idx, counts), nh


def cluster_scores_members(features_members, labels, k: int = 5, chunk_size: int = CHUNK,
                           compensated=None, device=None):
    """`cluster_scores` of M same-shaped feature spaces of one cohort (a
    list of (n, d) arrays or one (M, n, d) tensor): one batched distance
    block a chunk for all members (the JAX package's
    ``cluster_scores_tpu_members``). Returns [(silhouette, hit)] a member."""
    dev = resolve_device(device)
    if isinstance(features_members, torch.Tensor):
        x = _to_device(features_members, dev)
    else:
        x = torch.stack([_to_device(f, dev) for f in features_members])
    n, dim = x.shape[1], x.shape[2]
    lab_idx, n_labels, counts, comp = _preamble(labels, n, dim, compensated)
    k_or_none = k if n >= k + 1 else None
    sums, fracs = _sweep(x, lab_idx, n_labels, chunk_size, comp, k=k_or_none)
    return [(_silhouette_from_sums(sums[m], lab_idx, counts),
             0.0 if fracs is None else float(fracs[m].mean())) for m in range(x.shape[0])]
