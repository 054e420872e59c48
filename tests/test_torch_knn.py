"""The port's kNN baselines (``ops/knn.py``, ``models/conditioned_knn.py``),
the kNN comparison (``evaluation/knn_comparison.py``) and the kNN records
of ``compare_directional_imputation`` against the JAX package on the CPU.

The JAX oracles are its device estimators, instantiated directly
(``KNNRegressorTPU``, ``ConditionedKNNRegressorTPU``, ``knn_grid_mse_tpu``)
with ``shard=False``, or, where its code picks the class itself, with
``EVAL_BACKEND=tpu`` and its mesh switched off, so that they run the
single-device XLA programs and not sklearn. Inputs are drawn from numpy
seeds; real-valued random rows have no exact distance ties, except the
zero-distance cases, which copy training rows on purpose. Predictions agree
within rtol 1e-5 + atol 1e-6 (fp32 on both sides, other summation orders)
and grid MSEs within rel 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.evaluation import compare_directional_imputation as port_compare
from vae_los_angeles_torch.evaluation import knn_comparison as port_kc
from vae_los_angeles_torch.models.conditioned_knn import (
    ConditionedKNeighborsRegressor as PortLoop,
)
from vae_los_angeles_torch.ops import knn as port_knn
from vae_los_angeles_tpu.config import Config
from vae_los_angeles_tpu.data.synthetic import write_synthetic_artifacts
from vae_los_angeles_tpu.evaluation import compare_directional_imputation as jax_compare
from vae_los_angeles_tpu.evaluation import knn_comparison as jax_kc
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.models.conditioned_knn import ConditionedKNeighborsRegressor as JaxLoop
from vae_los_angeles_tpu.ops import knn as jax_knn
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

PRED = dict(rtol=1e-5, atol=1e-6)
GRID_REL = 1e-5
METRICS = ("euclidean", "manhattan")
WEIGHTS = ("uniform", "distance")
KS, MODES = (5, 10, 20, 50), ("uniform", "distance")


def rows(seed, n=200, m=90, d=40, t=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d, t)) + 0.1 * rng.normal(size=(n, t))).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    yq = (q @ rng.normal(size=(d, t))).astype(np.float32)
    return x, y, q, yq


def with_sites(seed, x, q, n_sites=6, unseen=True):
    """x and q with a site column; the queries may name a site the training
    rows lack (zeros) and some groups are smaller than 20."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, n_sites, len(x))
    qs = rng.integers(0, n_sites + int(unseen), len(q))
    return np.column_stack([x, xs]).astype(np.float32), np.column_stack([q, qs]).astype(np.float32)


def brute_force_neighbours(x, q, k, metric):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    diff = q64[:, None, :] - x64[None, :, :]
    d = np.abs(diff).sum(-1) if metric == "manhattan" else (diff ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture
def jax_single_device(monkeypatch):
    """The JAX package's estimators on one device, and its scripts routed to
    them (not to sklearn)."""
    monkeypatch.setenv("EVAL_BACKEND", "tpu")
    monkeypatch.setattr(jax_knn, "_eval_mesh", lambda shard=None: None)


@pytest.mark.parametrize("k", (1, 5, 50))
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("metric", METRICS)
def test_knn_regressor_matches_jax(metric, weights, k):
    x, y, q, _ = rows(0)
    port = port_knn.KNNRegressor(k, weights, metric=metric, device="cpu").fit(x, y)
    got = port.predict(q)
    want = jax_knn.KNNRegressorTPU(k, weights, metric=metric, shard=False).fit(x, y).predict(q)
    np.testing.assert_allclose(got, want, **PRED)
    _, _, idx = port_knn._neighbours(port._x, torch.as_tensor(q), k,
                                     port_knn._check_metric(metric))
    want_idx = brute_force_neighbours(x, q, k, metric)
    assert [set(r) for r in idx.numpy()] == [set(r) for r in want_idx]


def test_knn_regressor_1d_y_k_above_n_and_tensors():
    x, y, q, _ = rows(1, n=30, m=11)
    y1 = y[:, 0]
    got = port_knn.KNNRegressor(50, "distance", device="cpu").fit(x, y1).predict(q)
    want = jax_knn.KNNRegressorTPU(50, "distance", shard=False).fit(x, y1).predict(q)
    assert got.shape == (11,)
    np.testing.assert_allclose(got, want, **PRED)  # k clamps to n = 30 on both sides
    from_tensors = port_knn.KNNRegressor(50, "distance", device="cpu").fit(
        torch.as_tensor(x), torch.as_tensor(y1)).predict(torch.as_tensor(q))
    np.testing.assert_array_equal(from_tensors, got)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_chunking_does_not_change_the_result(metric):
    x, y, q, _ = rows(2)
    whole = port_knn.KNNRegressor(20, "distance", metric=metric, device="cpu").fit(x, y)
    chunked = port_knn.KNNRegressor(20, "distance", metric=metric, chunk_size=7,
                                    device="cpu").fit(x, y)
    np.testing.assert_allclose(chunked.predict(q), whole.predict(q), rtol=1e-6, atol=1e-7)
    grid = port_knn.knn_grid_mse(x, y, q, y[:len(q)], KS, MODES, metric=metric, device="cpu")
    grid7 = port_knn.knn_grid_mse(x, y, q, y[:len(q)], KS, MODES, metric=metric, chunk_size=7,
                                  device="cpu")
    for combo, mse in grid.items():
        assert rel(grid7[combo], mse) < 1e-6, combo


@pytest.mark.parametrize("metric", METRICS)
def test_knn_zero_distance_rule(metric):
    """A query equal to a training row takes that row's target alone under
    distance weights (sklearn's rule): the winners' distances are exact."""
    x, y, q, _ = rows(3)
    q2 = np.concatenate([x[:10], q[:20]])
    got = port_knn.KNNRegressor(5, "distance", metric=metric, device="cpu").fit(x, y).predict(q2)
    np.testing.assert_array_equal(got[:10], y[:10])
    want = jax_knn.KNNRegressorTPU(5, "distance", metric=metric, shard=False).fit(x, y).predict(q2)
    np.testing.assert_allclose(got, want, **PRED)
    multi = port_knn.KNNRegressor(5, "distance", metric=metric, device="cpu").fit(
        x, y).predict_multi_k(q2, (5, 20))
    np.testing.assert_array_equal(multi[20][:10], y[:10])


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("metric", METRICS)
def test_conditioned_knn_matches_jax_and_the_site_loop(metric, weights):
    x, y, q, _ = rows(4, n=160, m=50, d=10, t=3)
    X, Q = with_sites(4, x, q)
    for k, yy in ((5, y), (20, y[:, 0])):
        got = port_knn.ConditionedKNNRegressor(k, weights, metric, device="cpu").fit(X, yy)
        pred = got.predict(Q)
        want = jax_knn.ConditionedKNNRegressorTPU(k, weights, metric, shard=False).fit(X, yy)
        np.testing.assert_allclose(pred, want.predict(Q), **PRED)
        np.testing.assert_allclose(pred, JaxLoop(k, weights, metric).fit(X, yy).predict(Q),
                                   **PRED)
        loop = PortLoop(k, weights, metric, device="cpu").fit(X, yy).predict(Q)
        np.testing.assert_allclose(pred, loop, **PRED)
        unseen = Q[:, -1] == 6
        assert unseen.any() and np.all(pred[unseen] == 0.0)
        assert pred.shape == (len(Q),) + yy.shape[1:]
        np.testing.assert_array_equal(got.unique_sites, want.unique_sites)


@pytest.mark.parametrize("conditioned", (False, True))
@pytest.mark.parametrize("metric", METRICS)
def test_knn_grid_mse_matches_jax(metric, conditioned):
    x, y, q, yq = rows(5, n=180, m=70, d=16, t=4)
    if conditioned:
        x, q = with_sites(5, x, q)
    got = port_knn.knn_grid_mse(x, y, q, yq, KS, MODES, conditioned=conditioned, metric=metric,
                                device="cpu")
    want = jax_knn.knn_grid_mse_tpu(x, y, q, yq, KS, MODES, conditioned=conditioned,
                                    metric=metric, shard=False)
    assert list(got) == list(want) and len(got) == 8
    for combo in want:
        assert rel(got[combo], want[combo]) < GRID_REL, combo


def test_knn_grid_mse_clamps_k_and_counts_zero_distances():
    x, y, q, yq = rows(6, n=12, m=9, d=6, t=2)
    q2, yq2 = np.concatenate([x[:4], q]), np.concatenate([y[:4], yq])
    got = port_knn.knn_grid_mse(x, y, q2, yq2, (5, 50), MODES, device="cpu")
    want = jax_knn.knn_grid_mse_tpu(x, y, q2, yq2, (5, 50), MODES, shard=False)
    assert set(got) == {(5, "uniform"), (12, "uniform"), (5, "distance"), (12, "distance")}
    for combo in want:
        assert rel(got[combo], want[combo]) < GRID_REL, combo


@pytest.mark.parametrize("weights", WEIGHTS)
def test_predict_multi_k_matches_predict(weights):
    x, y, q, _ = rows(7)
    q = np.concatenate([x[:5], q])
    multi = port_knn.KNNRegressor(weights=weights, device="cpu").fit(x, y).predict_multi_k(
        q, (5, 10, 50, 500))
    assert set(multi) == {5, 10, 50, 200}
    for k, pred in multi.items():
        want = port_knn.KNNRegressor(k, weights, device="cpu").fit(x, y).predict(q)
        np.testing.assert_allclose(pred, want, rtol=1e-5, atol=1e-6)
    one_d = port_knn.KNNRegressor(device="cpu").fit(x, y[:, 1]).predict_multi_k(q, (5,))
    assert one_d[5].shape == (len(q),)


def best_params(model):
    return {k: model.get_params()[k] for k in ("n_neighbors", "weights", "metric")}


@pytest.mark.parametrize("conditioned", (False, True))
def test_optimize_knn_matches_jax(conditioned, jax_single_device):
    x, y, q, yq = rows(8, n=150, m=60, d=12, t=3)
    classes = (port_knn.KNNRegressor, jax_knn.KNNRegressorTPU)
    if conditioned:
        x, q = with_sites(8, x, q, unseen=False)
        classes = (port_knn.ConditionedKNNRegressor, jax_knn.ConditionedKNNRegressorTPU)
    got = port_kc.optimize_knn(x, y, q, yq, model_class=classes[0], device="cpu")
    want = jax_kc.optimize_knn(x, y, q, yq, model_class=classes[1])
    assert isinstance(got, classes[0])
    assert best_params(got) == best_params(want)
    got_mse = np.mean((got.predict(q) - yq) ** 2, axis=1)
    want_mse = np.mean((want.predict(q) - yq) ** 2, axis=1)
    np.testing.assert_allclose(got_mse, want_mse, rtol=1e-5)
    with pytest.raises(ValueError, match="model_class"):
        port_kc.optimize_knn(x, y, q, yq, model_class=PortLoop, device="cpu")


def test_run_direction_matches_jax(tmp_path, jax_single_device):
    x, y, q, yq = rows(9, n=120, m=40, d=14, t=5)
    rng = np.random.default_rng(9)
    s_tr, s_va = rng.integers(0, 4, len(x)), rng.integers(0, 4, len(q))
    args = ("RNA_to_DNA", x, y, q, yq, s_tr, s_va, s_va)
    got = port_kc._run_direction(*args, None, "rna", str(tmp_path / "port"), make_tsne=False,
                                 device="cpu")
    want = jax_kc._run_direction(*args, None, "rna", str(tmp_path / "jax"), make_tsne=False)
    assert list(got) == list(want) == ["KNN (Base)", "KNN (Cond)"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)
    assert (tmp_path / "port" / "comparison" / "boxplot_RNA_to_DNA.png").exists()


def test_get_knn_predictions_matches_jax():
    rng = np.random.default_rng(10)
    tpm = rng.normal(size=(100, 20)).astype(np.float32)
    beta = rng.uniform(size=(100, 24)).astype(np.float32)
    got = port_compare.get_knn_predictions(tpm[:80], beta[:80], tpm[80:], beta[80:],
                                           device="cpu")
    want = jax_compare.get_knn_predictions(tpm[:80], beta[:80], tpm[80:], beta[80:])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PRED)


def test_estimators_run_on_the_card_unless_asked(monkeypatch):
    """Without a device they resolve to the card, which this machine lacks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, q, yq = rows(11, n=20, m=5, d=3, t=2)
    for call in (lambda: port_knn.KNNRegressor().fit(x, y),
                 lambda: port_knn.ConditionedKNNRegressor().fit(with_sites(11, x, q)[0], y),
                 lambda: port_knn.knn_grid_mse(x, y, q, yq, (5,), ("uniform",)),
                 lambda: port_kc.main(make_tsne=False, data=(x, x, np.zeros(20, int)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------- the entry points

DIM_A, DIM_B, N_SITES, LATENT = 24, 32, 4, 6


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A synthetic ``processed_data.pkl`` with its label encoder and both
    directional checkpoints (JAX-written), the run-id files in the working
    directory."""
    monkeypatch.chdir(tmp_path)
    write_synthetic_artifacts(str(tmp_path / "data"), n_samples=110, dim_a=DIM_A, dim_b=DIM_B,
                              n_sites=N_SITES, n_unmatched=4)
    run_id = "20260103_040506"
    for name, init, seed in (("rna2dna", jdv.rna2dna_vae_init, 0),
                             ("dna2rna", jdv.dna2rna_vae_init, 1)):
        params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
        jax_ckpt.save_best(name, run_id, params, state, str(tmp_path / "checkpoints"))
        jax_ckpt.write_run_id(name, run_id)
    return tmp_path


def cfg_for(cls, tmp_path, plots):
    return cls(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
               data_dir=str(tmp_path / "data"), checkpoint_dir=str(tmp_path / "checkpoints"),
               plots_dir=str(tmp_path / plots))


def test_knn_comparison_main_matches_jax_and_writes_its_plots(workdir, jax_single_device):
    want = jax_kc.main(cfg_for(Config, workdir, "plots_jax"), make_tsne=False)
    got = port_kc.main(cfg_for(PortConfig, workdir, "plots_port"), make_tsne=True,
                       root=str(workdir), device="cpu")
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["KNN (Base)", "KNN (Cond)", "VAE (Cond)"]
        for name in ("KNN (Base)", "KNN (Cond)"):
            np.testing.assert_allclose(g[name], w[name], rtol=1e-5, err_msg=name)
        # the VAEs sample z with their own generators: finite, of one shape
        assert g["VAE (Cond)"].shape == w["VAE (Cond)"].shape
        assert np.all(np.isfinite(g["VAE (Cond)"]))
    out = workdir / "plots_port" / "comparison"
    for direction, prefix in (("RNA_to_DNA", "rna2dna"), ("DNA_to_RNA", "dna2rna")):
        assert (out / f"boxplot_{direction}.png").exists()
        for tag in ("knn_base", "knn_cond", "vae_cond"):
            assert (out / f"tsne_{prefix}_{tag}.png").exists()


def test_chip_smoke_neighbour_ties():
    """``chip_smoke.py`` accepts a neighbour set that differs from the
    float64 brute force only at a tie within 1e-5 of the k-th distance."""
    import chip_smoke

    d64 = np.array([[0.1, 0.2, 0.3, 0.3000001, 0.5], [0.1, 0.2, 0.3, 0.4, 0.5]])
    idx = np.array([[0, 1, 3, 2, 4], [0, 1, 2, 3, 4]])
    ties = chip_smoke.neighbour_ties("tie", idx, d64, ks=(1, 3, 5))
    assert ties.tolist() == [True, False]
    with pytest.raises(AssertionError, match="differ from the float64"):
        chip_smoke.neighbour_ties("no tie", np.array([[0, 1, 4, 2, 3]]), d64[1:], ks=(3,))


def test_plots_without_matplotlib_say_so_and_go_on(tmp_path, monkeypatch, capsys):
    """The card's machine has no matplotlib or plotly: the plotting functions
    print a line and return (the t-SNE still computes its embedding)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "plotly", None)
    x = rows(12, n=20, m=5, d=3, t=2)[0]
    port_kc.create_boxplots({"KNN (Base)": np.ones(4)}, "RNA_to_DNA", str(tmp_path))
    emb = port_kc.compute_and_plot_tsne(x, np.zeros(20, int), "t", "p", str(tmp_path),
                                        device="cpu")
    assert emb.shape == (20, 2) and np.isfinite(emb).all()
    assert capsys.readouterr().out.count("matplotlib unavailable") == 2
    assert not (tmp_path / "comparison").exists()
