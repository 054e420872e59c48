"""The port's row-sharded evaluation programs (``parallel.sharded_eval``,
routed from ``ops.knn``, ``ops.cluster_metrics``, ``ops.pca`` and
``ops.tsne``) against the port's single-device programs and the JAX
package's sharded ones, on the CPU: gloo worlds of 2 and 3 ranks started by
``parallel.comm.spawn`` (``torch_parallel_ranks.eval_world``, once a
session), the JAX side on the conftest's virtual 8-device mesh
(``shard=True``).

Tolerances are the JAX package's own sharded tests' (``tests/test_sharded_eval.py``,
``test_sharded_pca.py``, ``test_sharded_tsne.py``): kNN predictions rtol
1e-5 / atol 1e-6 against the single-device program and rtol 2e-4 / atol
2e-5 across the packages; the silhouette within 1e-5, the neighbourhood hit
within 1e-9 (the JAX package's mean of the hit fractions is float32, so
1e-6 across the packages); PCA scores within 2e-3 and explained variance rtol 1e-4; the
t-SNE KL at its initial embedding rel 1e-5 and five descent steps within
1e-3 of the embedding's scale. The inputs cover n that do not divide by the
rank count, k above the local row count, queries equal to training rows
(the zero-distance rule) and a site never fitted (zero rows).
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vae_los_angeles_torch.ops import knn as port_knn
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_tpu.ops import cluster_metrics as jax_cm
from vae_los_angeles_tpu.ops import knn as jax_knn
from vae_los_angeles_tpu.ops.pca import PCATPU, device_scaled_features
from vae_los_angeles_tpu.ops.tsne import TSNETPU

torch.set_num_threads(1)
KNN_SELF = dict(rtol=1e-5, atol=1e-6)
KNN_CROSS = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", params=[2, 3])
def world(request, tmp_path_factory):
    n = request.param
    return n, ranks.shared_result(tmp_path_factory, f"sharded_eval_world{n}",
                                  lambda: comm.spawn(ranks.eval_world, n, "gloo", "cpu"))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return ranks.shared_result(tmp_path_factory, "sharded_eval_single",
                               lambda: ranks.eval_programs(False))


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    return ranks.shared_result(tmp_path_factory, "sharded_eval_jax", _jax_programs)


def _jax_programs():
    """The JAX package's sharded programs on the same inputs (``shard=True``
    over the conftest's 8 virtual devices)."""
    d = ranks.eval_inputs()
    x, y, q = d["x"], d["y"], d["q"]
    out = {}
    for w in ("uniform", "distance"):
        for m in ("euclidean", "manhattan"):
            out[f"knn/{w}/{m}"] = jax_knn.KNNRegressorTPU(7, weights=w, metric=m,
                                                          shard=True).fit(x, y).predict(q)
            out[f"cknn/{w}/{m}"] = jax_knn.ConditionedKNNRegressorTPU(
                7, weights=w, metric=m, shard=True).fit(d["xc"], y).predict(d["qc"])
    out["knn/k_over_local"] = jax_knn.KNNRegressorTPU(12, shard=True).fit(
        x[:20], y[:20]).predict(q)
    out["knn/zero_distance"] = jax_knn.KNNRegressorTPU(5, weights="distance", shard=True).fit(
        x, y).predict(x[[3, 40, 100]])
    est = jax_knn.KNNRegressorTPU(5, weights="distance", shard=True).fit(x, y)
    for k, v in est.predict_multi_k(q, (3, 5, 9)).items():
        out[f"multi/{k}"] = v
    modes = ("uniform", "distance")
    grid = jax_knn.knn_grid_mse_tpu(x, y, q, d["yv"], (3, 5, 9), modes, chunk_size=16,
                                    shard=True)
    cgrid = jax_knn.knn_grid_mse_tpu(d["xc"], y, d["qc"], d["yv"], (3, 5), modes,
                                     conditioned=True, shard=True)
    out["grid"] = np.array([grid[key] for key in sorted(grid, key=str)])
    out["cgrid"] = np.array([cgrid[key] for key in sorted(cgrid, key=str)])
    blobs, labels = d["blobs"], d["labels"]
    out["silhouette"] = jax_cm.silhouette_score_tpu(blobs, labels, chunk_size=64, shard=True)
    out["silhouette_compensated"] = jax_cm.silhouette_score_tpu(
        blobs, labels, chunk_size=64, shard=True, compensated=True)
    out["nh"] = jax_cm.neighborhood_hit_tpu(blobs[:77], labels[:77], k=11, chunk_size=50,
                                            shard=True)
    out["scores"] = np.array(jax_cm.cluster_scores_tpu(blobs, labels, k=5, chunk_size=50,
                                                       shard=True))
    for name, dim in (("pca", 93), ("pca_even", 96)):
        est = PCATPU(n_components=2)
        scaled = device_scaled_features(ranks.wide(blobs, dim), shard=True)
        out[name] = est.fit_transform(scaled)
        out[name + "_evr"] = np.asarray(est.explained_variance_ratio_)
    for it in (0, 5):
        est = TSNETPU(n_components=2, perplexity=20.0, max_iter=it, init=d["y0"], shard=True)
        out[f"tsne/{it}"] = est.fit_transform(d["tsne_x"])
        out[f"tsne_kl/{it}"] = est.kl_divergence_
    return {k: np.asarray(v) for k, v in out.items()}


KNN_KEYS = ([f"knn/{w}/{m}" for w in ("uniform", "distance") for m in ("euclidean", "manhattan")]
            + [f"cknn/{w}/{m}" for w in ("uniform", "distance")
               for m in ("euclidean", "manhattan")]
            + ["knn/k_over_local", "knn/zero_distance", "multi/3", "multi/5", "multi/9"])


@pytest.mark.parametrize("key", KNN_KEYS)
def test_knn_sharded_equals_single_device(world, single, key):
    n, outs = world
    for r in outs:
        np.testing.assert_allclose(r["out"][key], single[key], **KNN_SELF)
    if key.startswith("cknn"):
        assert np.all(outs[0]["out"][key][-1] == 0.0)  # the unseen site: a zero row


@pytest.mark.parametrize("key", KNN_KEYS)
def test_knn_sharded_equals_jax_sharded(world, jax_sharded, key):
    _, outs = world
    np.testing.assert_allclose(outs[0]["out"][key], jax_sharded[key], **KNN_CROSS)


@pytest.mark.parametrize("key", ["grid", "cgrid"])
def test_grid_sharded(world, single, jax_sharded, key):
    _, outs = world
    for r in outs:
        np.testing.assert_allclose(r["out"][key], single[key], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(outs[0]["out"][key], jax_sharded[key], rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("key", ["silhouette", "silhouette_compensated", "nh", "scores"])
def test_cluster_metrics_sharded(world, single, jax_sharded, key):
    _, outs = world
    abs_tol = 1e-9 if key == "nh" else 1e-5
    for r in outs:
        np.testing.assert_allclose(r["out"][key], single[key], rtol=0, atol=abs_tol)
        np.testing.assert_allclose(r["out"][key], jax_sharded[key], rtol=0,
                                   atol=1e-6 if key == "nh" else abs_tol)


def _align_signs(got, want):
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1.0
    return got * signs[None, :]


@pytest.mark.parametrize("key", ["pca", "pca_even"])
def test_pca_column_sharded(world, single, jax_sharded, key):
    """93 and 96 columns over 2 and 3 ranks: zero-padded column blocks, one
    all-reduced Gram matrix."""
    _, outs = world
    for r in outs:
        np.testing.assert_allclose(r["out"][key], single[key], atol=2e-3)
        np.testing.assert_allclose(r["out"][key + "_evr"], single[key + "_evr"], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(_align_signs(r["out"][key], jax_sharded[key]),
                                   jax_sharded[key], atol=2e-3)
        np.testing.assert_allclose(r["out"][key + "_evr"], jax_sharded[key + "_evr"],
                                   rtol=1e-4, atol=1e-7)


def test_tsne_row_sharded(world, single, jax_sharded):
    """83 rows (padded) at the initial embedding (the KL is a functional of
    every affinity) and after 5 descent steps."""
    _, outs = world
    for r in outs:
        for want in (single, jax_sharded):
            assert r["out"]["tsne_kl/0"] == pytest.approx(float(want["tsne_kl/0"]), rel=1e-5)
            scale = float(np.abs(want["tsne/5"]).max())
            np.testing.assert_allclose(r["out"]["tsne/5"], want["tsne/5"], atol=1e-3 * scale)
        np.testing.assert_array_equal(r["out"]["tsne/0"], outs[0]["out"]["tsne/0"])


def test_every_rank_returns_the_whole_result(world):
    _, outs = world
    for r in outs[1:]:
        for key, value in r["out"].items():
            np.testing.assert_array_equal(value, outs[0]["out"][key])


def test_shard_true_on_one_rank_raises():
    with pytest.raises(ValueError, match="shard=True requires more than one visible device"):
        port_knn._eval_mesh(True)
    assert port_knn._eval_mesh(None) is None and port_knn._eval_mesh(False) is None
