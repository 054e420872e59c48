"""The port's silhouette and neighbourhood hit (``ops/cluster_metrics.py``,
``evaluation/clustering/metrics_utils.py``) against the JAX package's
single-device functions (``shard=False``) and sklearn on the CPU.

Tolerances: the silhouette to 1e-5 (fp32 distance sums in two orders, the
a/b/s arithmetic in float64 on both sides); the neighbourhood hit exactly,
on planted clusters whose k-th and (k+1)-th neighbours are never near a
tie in float64 (checked, so a tie fails loudly rather than passing by
luck): at a tie two fp32 implementations may pick either row. The
compensated path (8,192-wide feature blocks, Kahan-summed) is forced on
both sides with ``compensated=True``, and once chosen by width at 16,400
features, just above ``COMPENSATED_MIN_DIM``.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import silhouette_score as sk_silhouette

from vae_los_angeles_torch.evaluation.clustering.metrics_utils import (
    calculate_neighborhood_hit)
from vae_los_angeles_torch.ops import cluster_metrics as port_cm
from vae_los_angeles_tpu.ops import cluster_metrics as jax_cm

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

SIL = dict(atol=1e-5, rtol=0.0)
K = 5


def planted(n, dim, n_labels=4, seed=0):
    """Rows around one centre a label, overlapping enough that the hit is
    not trivially 1 (the centres' scale shrinks as dim^-1/4, as the
    distances concentrate)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    centres = rng.normal(size=(n_labels, dim)) * (1.5 * dim ** -0.25)
    return (centres[labels] + rng.normal(size=(n, dim))).astype(np.float32), labels


def assert_no_near_ties(x, labels, k=K, rel=1e-4):
    """No row's k-th and (k+1)-th nearest (self excluded, float64) lie
    within ``rel`` of each other with different labels."""
    x = x.astype(np.float64)
    d2 = np.sum((x[:, None] - x[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1)
    rows = np.arange(len(x))
    kth, nxt = d2[rows, order[:, k - 1]], d2[rows, order[:, k]]
    near = (nxt - kth) <= rel * kth
    differ = labels[order[:, k - 1]] != labels[order[:, k]]
    assert not np.any(near & differ), "planted data has a near-tie at the k-th neighbour"


def nh_float64(x, labels, k=K):
    x = x.astype(np.float64)
    d2 = np.sum((x[:, None] - x[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    return float(np.mean(labels[idx] == labels[:, None]))


CASES = {
    # name: (n, dim, compensated)
    "plain n=120 d=37": (120, 37, None),
    "plain n=90 d=64": (90, 64, False),
    "compensated forced n=60 d=64": (60, 64, True),
    "compensated by width n=40 d=16400": (40, 16_400, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_silhouette_and_hit_match_jax(case):
    n, dim, comp = CASES[case]
    x, labels = planted(n, dim, seed=n + dim)
    assert port_cm._resolve_compensated(comp, dim) == jax_cm._resolve_compensated(comp, dim)
    got = port_cm.silhouette_score(x, labels, compensated=comp, device="cpu")
    want = jax_cm.silhouette_score_tpu(x, labels, shard=False, compensated=comp)
    np.testing.assert_allclose(got, want, **SIL)
    np.testing.assert_allclose(got, sk_silhouette(x.astype(np.float64), labels), **SIL)
    assert_no_near_ties(x, labels)
    nh = port_cm.neighborhood_hit(x, labels, k=K, compensated=comp, device="cpu")
    assert nh == jax_cm.neighborhood_hit_tpu(x, labels, k=K, shard=False, compensated=comp)
    # the same neighbour sets; each row's fraction is fp32, as in the JAX package
    assert nh == pytest.approx(nh_float64(x, labels), abs=1e-7)
    assert 0.0 < nh < 1.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_scores_match_jax_and_the_separate_metrics(case):
    n, dim, comp = CASES[case]
    x, labels = planted(n, dim, seed=n + dim)
    sil, nh = port_cm.cluster_scores(x, labels, compensated=comp, device="cpu")
    want = jax_cm.cluster_scores_tpu(x, labels, shard=False, compensated=comp)
    np.testing.assert_allclose(sil, want[0], **SIL)
    assert nh == want[1]
    assert sil == port_cm.silhouette_score(x, labels, compensated=comp, device="cpu")
    assert nh == port_cm.neighborhood_hit(x, labels, compensated=comp, device="cpu")


@pytest.mark.parametrize("comp", (None, True))
def test_members_match_jax_and_each_member_alone(comp):
    spaces = [planted(100, 24, seed=s)[0] for s in (1, 2, 3)]
    labels = planted(100, 24, seed=1)[1]
    got = port_cm.cluster_scores_members(spaces, labels, compensated=comp, device="cpu")
    want = jax_cm.cluster_scores_tpu_members(spaces, labels, compensated=comp)
    stacked = port_cm.cluster_scores_members(torch.tensor(np.stack(spaces)), labels,
                                             compensated=comp, device="cpu")
    assert stacked == got
    for m, ((sil, nh), (wsil, wnh)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(sil, wsil, **SIL)
        assert_no_near_ties(spaces[m], labels)
        assert nh == wnh
        alone = port_cm.cluster_scores(spaces[m], labels, compensated=comp, device="cpu")
        np.testing.assert_allclose(sil, alone[0], atol=1e-6, rtol=0.0)
        assert nh == alone[1]


def test_chunks_do_not_change_the_scores():
    x, labels = planted(75, 20, seed=5)
    whole = port_cm.cluster_scores(x, labels, device="cpu")
    chunked = port_cm.cluster_scores(x, labels, chunk_size=16, device="cpu")
    np.testing.assert_allclose(chunked[0], whole[0], atol=1e-6, rtol=0.0)
    assert chunked[1] == whole[1]
    want = jax_cm.cluster_scores_tpu(x, labels, chunk_size=16, shard=False)
    np.testing.assert_allclose(chunked[0], want[0], **SIL)
    assert chunked[1] == want[1]


def test_label_count_rule_and_singletons_match_jax():
    x, labels = planted(30, 8, seed=7)
    for bad in (np.zeros(30, int), np.arange(30)):
        with pytest.raises(ValueError, match="Number of labels is"):
            port_cm.silhouette_score(x, bad, device="cpu")
        with pytest.raises(ValueError, match="Number of labels is"):
            port_cm.cluster_scores(x, bad, device="cpu")
        with pytest.raises(ValueError, match="Number of labels is"):
            jax_cm.silhouette_score_tpu(x, bad, shard=False)
    single = labels.copy()
    single[0] = 99  # a singleton cluster scores 0 (sklearn's rule)
    got = port_cm.silhouette_score(x, single, device="cpu")
    np.testing.assert_allclose(got, jax_cm.silhouette_score_tpu(x, single, shard=False), **SIL)
    np.testing.assert_allclose(got, sk_silhouette(x.astype(np.float64), single), **SIL)
    # string labels, as the pickles' site names
    names = np.array(["Lung", "Brain", "Skin", "Colon"])[labels]
    np.testing.assert_allclose(port_cm.silhouette_score(x, names, device="cpu"),
                               port_cm.silhouette_score(x, labels, device="cpu"), atol=0, rtol=0)


def test_below_k_plus_one_rows_the_hit_is_zero():
    x, labels = planted(5, 6, seed=8)
    labels = np.array([0, 0, 1, 1, 2])
    assert port_cm.neighborhood_hit(x, labels, k=5, device="cpu") == 0.0
    assert calculate_neighborhood_hit(x, labels, k=5, device="cpu") == 0.0
    sil, nh = port_cm.cluster_scores(x, labels, k=5, device="cpu")
    want = jax_cm.cluster_scores_tpu(x, labels, k=5, shard=False)
    np.testing.assert_allclose(sil, want[0], **SIL)
    assert nh == want[1] == 0.0
    (msil, mnh), = port_cm.cluster_scores_members([x], labels, k=5, device="cpu")
    assert (msil, mnh) == (sil, 0.0)


def test_metrics_utils_hit_is_the_device_path_and_raises():
    x, labels = planted(50, 10, seed=9)
    assert calculate_neighborhood_hit(x, labels, device="cpu") == port_cm.neighborhood_hit(
        x, labels, device="cpu")
    # the JAX function prints a warning and scores 0.0 here; the port raises
    with pytest.raises(IndexError):
        calculate_neighborhood_hit(x, labels[:20], device="cpu")


def test_shard_raises_and_the_card_is_the_default(monkeypatch):
    x, labels = planted(20, 4, seed=10)
    with pytest.raises(NotImplementedError, match="A8"):
        port_cm.silhouette_score(x, labels, shard=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cm.cluster_scores(x, labels)


def test_chip_smoke_float64_references_match_sklearn():
    """``chip_smoke.py`` holds the card's scores against float64 numpy (the
    card's machine has no sklearn): its silhouette is sklearn's, its hit
    the reference's NearestNeighbors one."""
    import chip_smoke
    from sklearn.neighbors import NearestNeighbors

    x, labels = planted(90, 12, seed=11)
    labels[0] = 7  # a singleton
    d64 = chip_smoke.brute_force64(x, x, "euclidean")
    assert chip_smoke.silhouette64(d64, labels) == pytest.approx(
        sk_silhouette(x.astype(np.float64), labels), abs=1e-12)
    _, idx = NearestNeighbors(n_neighbors=K + 1).fit(x.astype(np.float64)).kneighbors(
        x.astype(np.float64))
    nh, ties = chip_smoke.nh64(d64, labels)
    assert nh == pytest.approx(float(np.mean(labels[idx[:, 1:]] == labels[:, None])), abs=1e-12)
    assert ties == 0
