"""Row-sharded evaluation programs over the ranks of a process group
(counterpart of ``vae_los_angeles_tpu/parallel/sharded_eval.py``).

`ops.knn`, `ops.cluster_metrics` and `ops.tsne` compute brute-force
neighbour statistics against a training or feature matrix that, at a full
cohort's methylome width, may not fit one device. Here each rank holds one
contiguous block of its rows (`row_block`: padded to a multiple of the rank
count; a padded row is at +inf distance, and a padded site row has site
-1), the queries are replicated, and two collective shapes reduce, both
O(queries·k) or O(queries·labels), never O(rows):

  * kNN and the neighbourhood hit: each rank takes a local top-k with
    ``k_local = min(k, n_local)``, the (m, ranks·k_local) candidate strip is
    all-gathered and its top k taken again, an exact merge (the true k
    nearest are in some rank's local top-k). The winners' true distances are
    computed again on the rank that owns them and summed in one all-reduce,
    so a query equal to a training row gets exactly 0 and the zero-distance
    rule fires. Payload rows never travel: each rank all-reduces the
    weighted sum of the winner rows it owns.
  * the silhouette: the per-cluster distance sums are an all-reduce of the
    local distance block times the local label one-hot (zero on padding).
  * the exact t-SNE: the affinity and descent state live as (n/ranks × n)
    row blocks; the transpose block of the conditional P comes from the
    local distances and the all-gathered per-row β and Σp (the distance
    block is symmetric), and each descent step needs one scalar all-reduce
    (ΣW) and one (n, 2) all-gather of the gradient rows. Padded rows get a
    zero include-mask, so the embedding does not depend on the padding.

The single-device helpers are reused, not copied: the selection distances,
top-k weights and slot sums of ``ops.knn``, the distance blocks of
``ops.cluster_metrics``, and the perplexity search and update rule of
``ops.tsne``. Results agree with the single-device programs up to the order
of their sums (and, for the t-SNE descent, its chaos).
"""

from __future__ import annotations

import torch

from vae_los_angeles_torch.ops import cluster_metrics as cm
from vae_los_angeles_torch.ops import knn
from vae_los_angeles_torch.ops import tsne as ts


def row_block(t: torch.Tensor, mesh, pad_value=0) -> torch.Tensor:
    """This rank's block of ``t``'s rows: ceil(n / ranks) rows, the last
    rank's padded with ``pad_value``."""
    n = t.shape[0]
    n_loc = -(-n // mesh.size)
    lo = mesh.data_index * n_loc
    block = t[lo:lo + n_loc]
    if block.shape[0] < n_loc:
        pad = torch.full((n_loc - block.shape[0],) + tuple(t.shape[1:]), pad_value,
                         dtype=t.dtype, device=t.device)
        block = torch.cat([block, pad])
    return block.contiguous()


def _geometry(n_local: int, n: int, mesh, device):
    """(offset, validity) of this rank's rows: rows past ``n`` are padding."""
    offset = mesh.data_index * n_local
    return offset, (offset + torch.arange(n_local, device=device)) < n


def _merge_topk(dist, payload, k: int, mesh):
    """All-gather every rank's (m, k_local) candidates with their payloads
    and take the k smallest again: (distances, payloads) of the global k."""
    dists = mesh.gather(dist, "data", 1)
    pays = mesh.gather(payload, "data", 1)
    top, pos = torch.topk(dists, k, dim=1, largest=False, sorted=True)
    return top, torch.gather(pays, 1, pos)


def _merge_candidates(x_local, n: int, queries, keep_extra, k: int, metric: str, mesh):
    """The candidate merge every neighbour program starts with: (validity
    (m, k), this rank owns the winner (m, k), its local row (m, k))."""
    n_local = x_local.shape[0]
    offset, valid = _geometry(n_local, n, mesh, x_local.device)
    d = knn._selection_dists(x_local, queries, metric)
    keep = valid[None, :] if keep_extra is None else valid[None, :] & keep_extra
    d = torch.where(keep, d, torch.inf)
    top, idx = torch.topk(d, min(k, n_local), dim=1, largest=False, sorted=True)
    top, win = _merge_topk(top, idx + offset, k, mesh)
    finite = torch.isfinite(top)
    local = win - offset
    mine = (local >= 0) & (local < n_local) & finite
    return finite, mine, local.clamp(0, n_local - 1)


def _winner_dists(x_local, queries, lp, mine, k: int, metric: str, mesh):
    """True distances of the k winners, each computed on the rank that owns
    it, summed in one all-reduce."""
    cols = []
    for j in range(k):
        diff = queries - x_local.index_select(0, lp[:, j])
        dj = torch.sum(diff.abs(), 1) if metric == "manhattan" else torch.sum(diff * diff, 1)
        cols.append(torch.where(mine[:, j], dj, 0.0))
    summed = mesh.psum(torch.stack(cols, 1), "data")
    return summed if metric == "manhattan" else torch.sqrt(summed)


def _keep(x_site, q_site):
    return None if x_site is None else q_site[:, None] == x_site[None, :]


def knn_chunk(x_local, y_local, n: int, queries, k: int, weights: str, metric: str, mesh,
              x_site=None, q_site=None):
    """Neighbour-mean predictions of one query chunk (``ops.knn._knn_chunk``
    over row blocks); with sites, cross-site pairs are +inf (the
    conditioned kNN: unseen sites sum to zero rows)."""
    finite, mine, lp = _merge_candidates(x_local, n, queries, _keep(x_site, q_site), k, metric,
                                         mesh)
    if weights == "uniform":
        w = finite.to(torch.float32)
    else:
        w = knn._distance_weights(_winner_dists(x_local, queries, lp, mine, k, metric, mesh),
                                  finite)
    w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), knn.TINY)
    return mesh.psum(knn._slot_sum(w * mine, lp, y_local), "data")


def prefix_chunk(x_local, y_local, n: int, queries, ks, modes, kmax: int, metric: str, mesh,
                 x_site=None, q_site=None) -> dict:
    """{(k, mode): (m, t) predictions} of every combination from one
    distance pass and one merge (``ops.knn._prefix_predictions``: each rank
    sums the winner rows it owns, the denominators are the replicated
    winners'; one all-reduce of the stacked predictions)."""
    finite, mine, lp = _merge_candidates(x_local, n, queries, _keep(x_site, q_site), kmax,
                                         metric, mesh)
    d = _winner_dists(x_local, queries, lp, mine, kmax, metric, mesh)
    parts = dict(knn._prefix_predictions(d, finite, lp, y_local, ks, modes, owned=mine))
    keys = list(parts)
    summed = mesh.psum(torch.stack([parts[key] for key in keys]), "data")
    return dict(zip(keys, summed))


def scores_chunk(x_local, x_sq_local, onehot_local, lab_local, n: int, block, q_lab, start: int,
                 k, compensated: bool, mesh):
    """One query chunk's (per-cluster distance sums (m, L) or None,
    neighbourhood-hit fractions (m,) or None) from one local distance
    block (``ops.cluster_metrics._sweep``): sums when ``onehot_local`` is
    given, the hit of the k nearest (self excluded) when ``k`` is."""
    n_local = x_local.shape[0]
    offset, valid = _geometry(n_local, n, mesh, x_local.device)
    d2 = cm._chunk_d2(x_local, x_sq_local, block, compensated)
    cols = offset + torch.arange(n_local, device=block.device)
    rows = start + torch.arange(block.shape[0], device=block.device)
    self_mask = cols[None, :] == rows[:, None]
    sums = fracs = None
    if onehot_local is not None:
        d = torch.where(self_mask, 0.0, torch.sqrt(d2))
        sums = mesh.psum(torch.matmul(d, onehot_local), "data")
    if k is not None:
        d2 = torch.where(valid[None, :] & ~self_mask, d2, torch.inf)
        top, idx = torch.topk(d2, min(k, n_local), dim=1, largest=False, sorted=True)
        _, win_lab = _merge_topk(top, lab_local[idx], k, mesh)
        fracs = torch.mean((win_lab == q_lab[:, None]).to(torch.float32), dim=1)
    return sums, fracs


def sweep(x, lab_idx, n_labels: int, chunk_size: int, compensated: bool, mesh, k=None,
          sums: bool = True):
    """``ops.cluster_metrics._sweep`` over row blocks: every rank holds the
    whole (n, d) ``x`` as the queries and its block as the rows."""
    n = x.shape[0]
    lab = torch.as_tensor(lab_idx, dtype=torch.int64, device=x.device)
    x_local = row_block(x, mesh)
    lab_local = row_block(lab, mesh, pad_value=-1)
    onehot = None
    if sums:
        onehot = torch.nn.functional.one_hot(lab_local.clamp_min(0), n_labels).to(x.dtype)
        onehot = onehot * (lab_local >= 0)[:, None].to(x.dtype)  # padding: a zero row
    x_sq = torch.sum(x_local * x_local, dim=-1)
    out_sums, out_fracs = [], []
    for start in range(0, n, chunk_size):
        block = x[start:start + chunk_size]
        s, f = scores_chunk(x_local, x_sq, onehot, lab_local, n, block,
                            lab[start:start + chunk_size], start, k, compensated, mesh)
        if s is not None:
            out_sums.append(s.cpu())
        if f is not None:
            out_fracs.append(f.cpu())
    return (torch.cat(out_sums).numpy().astype("float64") if sums else None,
            torch.cat(out_fracs).numpy().astype("float64") if k is not None else None)


def _block_d2(rows, full):
    r_sq = torch.sum(rows * rows, dim=1)
    c_sq = torch.sum(full * full, dim=1)
    return torch.clamp_min(r_sq[:, None] - 2.0 * torch.matmul(rows, full.T) + c_sq[None, :], 0.0)


def tsne(x, y0, perplexity: float, lr: float, early_exaggeration: float, max_iter: int,
         dof: float, mesh):
    """Exact t-SNE of the (n, d) rows ``x`` (on every rank) from the (n, c)
    ``y0`` with row-sharded affinities and descent (module docstring):
    ``ops.tsne._joint_probabilities`` and ``_optimize`` over row blocks.
    Returns (embedding (n, c), KL), replicated."""
    n = x.shape[0]
    n_loc = -(-n // mesh.size)
    n_pad = n_loc * mesh.size
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    offset = mesh.data_index * n_loc
    rows_gid = offset + torch.arange(n_loc, device=x.device)
    cols_gid = torch.arange(n_pad, device=x.device)
    include = ((rows_gid < n)[:, None] & (cols_gid < n)[None, :]
               & (rows_gid[:, None] != cols_gid[None, :])).to(x.dtype)
    d2 = _block_d2(x_pad[offset:offset + n_loc], x_pad)
    beta, sum_p = ts._perplexity_search(d2, include, perplexity)
    cond = torch.exp(-d2 * beta[:, None]) * include / sum_p[:, None]
    beta_all = mesh.gather(beta, "data")
    sum_all = mesh.gather(sum_p, "data")
    cond_t = torch.exp(-d2 * beta_all[None, :]) * include / sum_all[None, :]
    joint = cond + cond_t
    z = mesh.psum(torch.sum(joint).reshape(1), "data")[0]
    eps = ts.MACHINE_EPSILON
    p_local = torch.clamp_min(joint / torch.clamp_min(z, eps), eps) * include
    coef = 2.0 * (dof + 1.0) / dof

    def student_t(y):
        y_loc = y[offset:offset + n_loc]
        w = (1.0 + _block_d2(y_loc, y) / dof) ** (-(dof + 1.0) / 2.0) * include
        sum_w = mesh.psum(torch.sum(w).reshape(1), "data")[0]
        return torch.clamp_min(w / torch.clamp_min(sum_w, eps), eps) * include, w, y_loc

    y = torch.nn.functional.pad(y0.to(x.dtype), (0, 0, 0, n_pad - n))
    update, gains = torch.zeros_like(y), torch.ones_like(y)
    for i in range(max_iter):
        q, w, y_loc = student_t(y)
        p_eff = p_local * early_exaggeration if i < ts._EXPLORATION_ITERS else p_local
        s = (p_eff - q) * w
        grad_loc = coef * (y_loc * torch.sum(s, dim=1, keepdim=True) - torch.matmul(s, y))
        update, gains = ts._apply_update(mesh.gather(grad_loc, "data"), update, gains, lr, i)
        y = y + update
    q, _, _ = student_t(y)
    kl = mesh.psum(torch.sum(p_local * torch.log(torch.clamp_min(p_local, eps)
                                                 / torch.clamp_min(q, eps))).reshape(1), "data")
    return y[:n], kl[0]


__all__ = ["knn_chunk", "prefix_chunk", "row_block", "scores_chunk", "sweep", "tsne"]
