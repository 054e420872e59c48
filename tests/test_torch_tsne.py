"""The port's exact t-SNE (``ops/tsne.py``) and Gram PCA (``ops/pca.py``)
against the JAX package on the CPU.

The deterministic stages are held tightly: the squared distances, the
affinities, the PCA scores and init, one state update and one gradient step
at the steps around the phase boundary (i = 250). The descent itself is
chaotic (two fp32 implementations part after a few hundred steps), so a
whole run is held by quality, as the JAX package's own tests hold it against
sklearn: trustworthiness within 0.02 and the KL within 10% of
``TSNETPU(shard=False)``'s (the JAX single-device program).

The affinities: the perplexity search stops a row once its entropy is within
1e-5 of the target. Two fp32 sums of a row's entropy can fall on either side
of that line at some step, and the row's β then stops one step apart (3.5e-5
relative at n = 150, perplexity 30, for 3 of 150 rows); each entry
exp(−d²β) of that row moves by d²β·Δβ/β of itself (up to 2.4e-5 of the
largest entry of P here). So P is held at rtol 1e-5 with an atol of 5e-5 of
its largest entry, and every row of both at the target perplexity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.manifold import trustworthiness

from vae_los_angeles_torch.ops import pca as port_pca
from vae_los_angeles_torch.ops import tsne as port_tsne
from vae_los_angeles_tpu.ops import pca as jax_pca
from vae_los_angeles_tpu.ops import tsne as jax_tsne

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)


def blobs(n, dim=16, n_labels=4, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    centers = rng.normal(size=(n_labels, dim)) * spread
    return (centers[labels] + rng.normal(size=(n, dim))).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def align_signs(got, want):
    """Flip each column of ``got`` to the sign of ``want``'s."""
    signs = np.sign(np.sum(got * want, axis=0))
    return got * np.where(signs == 0, 1, signs)


def test_sq_distances_match_jax():
    x = blobs(50, dim=33, seed=3)
    got = port_tsne._sq_distances(t(x)).numpy()
    want = np.asarray(jax_tsne._sq_distances(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
    assert np.all(np.diag(got) == 0.0)


@pytest.mark.parametrize("n, perplexity", [(60, 12.0), (150, 30.0), (40, 5.0)])
def test_affinities_match_jax(n, perplexity):
    d2 = np.asarray(jax_tsne._sq_distances(blobs(n, seed=n)))
    cond = port_tsne._conditional_probabilities(t(d2), perplexity).numpy()
    want_cond = np.asarray(jax_tsne._conditional_probabilities(d2, np.float32(perplexity)))
    np.testing.assert_allclose(cond, want_cond, rtol=1e-5, atol=5e-5 * want_cond.max())
    np.testing.assert_allclose(cond.sum(axis=1), 1.0, atol=1e-5)
    for rows in (cond, want_cond):  # the entropy of each row is log(perplexity)
        entropy = -np.sum(rows * np.log(np.where(rows > 0, rows, 1.0)), axis=1)
        np.testing.assert_allclose(entropy, np.log(perplexity), atol=1e-4)
    p = port_tsne._joint_probabilities(t(d2), perplexity).numpy()
    want = np.asarray(jax_tsne._joint_probabilities(d2, np.float32(perplexity)))
    np.testing.assert_allclose(p, want, rtol=1e-5, atol=5e-5 * want.max())
    assert np.all(np.diag(p) == 0.0) and p.min(initial=1.0, where=~np.eye(n, dtype=bool)) > 0


@pytest.mark.parametrize("n, dim, k", [(60, 20, 5), (24, 40, 3), (100, 8, 8)])
def test_pca_matches_jax(n, dim, k):
    """Scores of standardized rows (scaled to unit size: fp32 eigensolvers
    agree to ~1e-6 of the scores' magnitude), sign-aligned."""
    x = blobs(n, dim=dim, seed=k)
    xs = port_pca.standardize(t(x)).numpy()
    np.testing.assert_allclose(xs, np.asarray(jax_pca.standardize_tpu(x)), atol=1e-5)
    xs = xs / np.sqrt(n)
    pca = port_pca.PCA(n_components=k, device="cpu")
    got = pca.fit_transform(xs)
    want_pca = jax_pca.PCATPU(n_components=k)
    want = want_pca.fit_transform(xs)
    assert got.shape == want.shape == (n, k)
    np.testing.assert_allclose(align_signs(got, want), want, atol=1e-5)
    np.testing.assert_allclose(pca.explained_variance_ratio_,
                               want_pca.explained_variance_ratio_, atol=1e-5)
    # the sign rule: each column's largest-magnitude entry is positive
    assert np.all(got[np.argmax(np.abs(got), axis=0), np.arange(k)] > 0)


def test_pca_init_matches_jax():
    x = blobs(80, dim=12, seed=1)
    got = port_tsne._pca_init(t(x), 2).numpy()
    want = np.asarray(jax_tsne._pca_init(x, np.int32(80), 2, 2))
    np.testing.assert_allclose(align_signs(got, want), want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.std(got[:, 0]), 1e-4, rtol=1e-4)


STEPS = (0, 249, 250, 251)


def descent_state(seed, n=40):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    update = (0.1 * rng.normal(size=(n, 2))).astype(np.float32)
    gains = rng.uniform(0.05, 3.0, size=(n, 2)).astype(np.float32)
    d2 = np.asarray(jax_tsne._sq_distances(blobs(n, seed=seed)))
    p = np.asarray(jax_tsne._joint_probabilities(d2, np.float32(10.0)))
    return p, y, update, gains


@pytest.mark.parametrize("i", STEPS)
def test_apply_update_matches_jax(i):
    _, grad, update, gains = descent_state(i)
    got = port_tsne._apply_update(t(grad), t(update), t(gains), 50.0, i)
    want = jax_tsne._apply_update(grad, update, gains, jnp.float32(50.0), i)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def jax_step(p, y, update, gains, lr, early_exaggeration, i, dof=1.0):
    """One step of the JAX package's descent (``_optimize``'s scan body),
    from the given state, in its own functions."""
    n = y.shape[0]
    offdiag = 1.0 - jnp.eye(n, dtype=jnp.float32)
    w = (1.0 + jax_tsne._sq_distances(y) / dof) ** (-(dof + 1.0) / 2.0) * offdiag
    q = jnp.maximum(w / jnp.maximum(jnp.sum(w), jax_tsne.MACHINE_EPSILON),
                    jax_tsne.MACHINE_EPSILON) * offdiag
    p_eff = jnp.where(i < 250, p * early_exaggeration, p)
    s = (p_eff - q) * w
    grad = 2.0 * (dof + 1.0) / dof * (y * jnp.sum(s, axis=1, keepdims=True) - s @ y)
    update, gains = jax_tsne._apply_update(grad, update, gains, jnp.float32(lr), i)
    return y + update, update, gains


@pytest.mark.parametrize("i", STEPS)
def test_gradient_step_matches_jax(i):
    p, y, update, gains = descent_state(10 + i)
    got = port_tsne._step(t(p), t(y), t(update), t(gains), 50.0, 12.0, i, 1.0)
    want = jax_step(p, y, update, gains, 50.0, 12.0, i)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    if i == 0:  # the JAX package's own first step, from update 0 and gains 1
        y1, _ = jax_tsne._optimize(p, y, jnp.float32(50.0), jnp.float32(12.0), max_iter=1,
                                   dof=1.0)
        first, _, _ = port_tsne._step(t(p), t(y), torch.zeros(y.shape), torch.ones(y.shape),
                                      50.0, 12.0, 0, 1.0)
        np.testing.assert_allclose(first.numpy(), np.asarray(y1), rtol=1e-5, atol=1e-6)


def test_whole_run_quality_matches_jax():
    x = blobs(60, dim=20, seed=0)
    port = port_tsne.TSNE(random_state=42, perplexity=20.0, max_iter=300, device="cpu")
    got = port.fit_transform(x)
    ref = jax_tsne.TSNETPU(random_state=42, perplexity=20.0, max_iter=300, shard=False)
    want = ref.fit_transform(x)
    assert got.shape == (60, 2) and np.all(np.isfinite(got))
    assert abs(trustworthiness(x, got) - trustworthiness(x, want)) <= 0.02
    assert abs(port.kl_divergence_ - ref.kl_divergence_) <= 0.1 * ref.kl_divergence_
    again = port_tsne.TSNE(random_state=42, perplexity=20.0, max_iter=300, device="cpu")
    np.testing.assert_array_equal(again.fit_transform(x), got)


def test_inits_and_errors_match_jax():
    x = blobs(30, dim=6, seed=4)
    xt = t(x)
    rand = port_tsne.TSNE(init="random", random_state=3, device="cpu")._initial_embedding(xt)
    want = jax_tsne.TSNETPU(init="random", random_state=3, shard=False)._initial_embedding(
        jnp.asarray(x), 30)
    np.testing.assert_array_equal(rand.numpy(), np.asarray(want))
    init = np.full((30, 2), 1e-3, np.float32)
    arr = port_tsne.TSNE(init=init, device="cpu")._initial_embedding(xt)
    np.testing.assert_array_equal(arr.numpy(), init)
    auto = port_tsne.TSNE(perplexity=5.0, max_iter=10, init=init, learning_rate="auto",
                          device="cpu")
    fixed = port_tsne.TSNE(perplexity=5.0, max_iter=10, init=init, learning_rate=50.0,
                           device="cpu")
    np.testing.assert_array_equal(auto.fit_transform(x), fixed.fit_transform(x))  # max(n/48, 50)
    with pytest.raises(ValueError, match="perplexity"):
        port_tsne.TSNE(perplexity=30.0, device="cpu").fit_transform(x)
    with pytest.raises(ValueError, match="at least 2"):
        port_tsne.TSNE(device="cpu").fit_transform(x[:1])
    with pytest.raises(ValueError, match="init"):
        port_tsne.TSNE(init="spectral", perplexity=5.0, device="cpu").fit_transform(x)
    with pytest.raises(ValueError, match="euclidean"):
        port_tsne.TSNE(metric="cosine")
    assert port_tsne.resolve_tsne(10_000) is port_tsne.TSNE


def test_chip_smoke_trustworthiness_matches_sklearn():
    """``chip_smoke.py`` scores the card's embedding in numpy (the card's
    machine has no sklearn): its trustworthiness is sklearn's."""
    import chip_smoke

    x = blobs(70, dim=9, seed=8)
    emb = np.random.default_rng(8).normal(size=(70, 2)).astype(np.float32)
    for k in (5, 12):
        assert chip_smoke.trustworthiness(x, emb, k) == pytest.approx(
            trustworthiness(x, emb, n_neighbors=k), abs=1e-12)
