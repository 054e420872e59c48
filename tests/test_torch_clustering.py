"""The clustering evaluation of the port against the JAX package on the CPU:
the population PCA and t-SNE (``ops/pca.py``, ``ops/tsne.py``), the cohort
analysis and helpers (``evaluation/clustering/common.py``), the imputation
methods' clustering (``cluster_imputation_methods``), the EDA boxplots'
columns (``create_boxplots``) and the plots' file names.

Tolerances: the scaling, the PCA scores (sign-aligned) and the affinities
and PCA init of the t-SNE as ``test_torch_tsne.py`` holds the single
versions; the silhouette and hit of the original and PCA spaces to 1e-4
(fp32 on the device against the JAX package's, or its sklearn route's
float64). The t-SNE descent is chaotic (two fp32 implementations part after
a few hundred steps), so a t-SNE embedding is held by quality: its
trustworthiness within 0.02 and its KL within 10% of the JAX package's,
and the scores of the t-SNE space within 0.1 of the JAX package's (a
different embedding of the same quality scores differently). The JAX main
runs as it runs on a CPU host (its ``EVAL_BACKEND`` auto route: sklearn,
one method after another); the port always runs its population. Each JAX
main runs once (a module-scoped fixture); its plots are recorded, not
drawn. The t-SNE runs take their default 1,000 steps: at 300 the descent
has had only 50 steps past its exaggerated phase, and two correct runs' KL
differed by up to 25% there (under 8% from 600 steps on); the JAX device
program's 3-member run at n = 60 takes under a second here.
"""

import functools
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.manifold import trustworthiness
from sklearn.preprocessing import StandardScaler

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import unmatched_cohorts
from vae_los_angeles_torch.evaluation import create_boxplots as port_box
from vae_los_angeles_torch.evaluation.clustering import cluster_imputation_methods as port_cim
from vae_los_angeles_torch.evaluation.clustering import common as port_common
from vae_los_angeles_torch.ops import pca as port_pca
from vae_los_angeles_torch.ops import tsne as port_tsne
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.synthetic import write_synthetic_artifacts
from vae_los_angeles_tpu.evaluation import create_boxplots as jax_box
from vae_los_angeles_tpu.evaluation.clustering import cluster_imputation_methods as jax_cim
from vae_los_angeles_tpu.evaluation.clustering import common as jax_common
from vae_los_angeles_tpu.ops import pca as jax_pca
from vae_los_angeles_tpu.ops import tsne as jax_tsne

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, N, N_UNMATCHED = 40, 56, 5, 120, 60
SCORE = dict(atol=1e-4, rtol=0.0)
TSNE_SCORE = 0.1
STAMP = "20260102_030405"  # a run id: the recorded plots are keyed by the name before it


def blobs(m, n, dim, n_labels=4, seed=0, spread=3.0):
    """M feature spaces of one cohort: the same labels, other rows."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    out = []
    for _ in range(m):
        centres = rng.normal(size=(n_labels, dim)) * spread
        out.append((centres[labels] + rng.normal(size=(n, dim))).astype(np.float32))
    return out, labels


def align_signs(got, want):
    signs = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    return got * np.where(signs == 0, 1, signs)


def scaled(x):
    return StandardScaler().fit_transform(np.asarray(x, np.float64))


def assert_tsne_quality(x, got, want, what=""):
    t_got, t_want = trustworthiness(x, got, n_neighbors=5), trustworthiness(x, want, n_neighbors=5)
    assert abs(t_got - t_want) <= 0.02, f"{what}: trustworthiness {t_got:.4f} vs {t_want:.4f}"


def assert_scores(got, want, what=""):
    for space in ("orig", "pca"):
        for metric in ("silhouette", "nh"):
            key = f"{space}_{metric}"
            np.testing.assert_allclose(got[key], want[key], err_msg=f"{what} {key}", **SCORE)
    for metric in ("silhouette", "nh"):
        key = f"tsne_{metric}"
        assert abs(got[key] - want[key]) <= TSNE_SCORE, f"{what} {key}: {got[key]} {want[key]}"


# --- the population reductions ------------------------------------------------

def test_standardize_and_pca_members_match_jax():
    spaces, _ = blobs(3, 50, 30, seed=1)
    x = np.stack(spaces)
    got = port_pca.standardize_members(torch.tensor(x)).numpy()
    want = np.asarray(jax_pca.standardize_members(x, np.int32(50)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    for m in range(3):
        np.testing.assert_array_equal(got[m], port_pca.standardize(torch.tensor(x[m])).numpy())
    unit = got / np.sqrt(50)  # unit-size rows: fp32 eigensolvers agree to ~1e-6 of the scores
    scores, evr = port_pca.pca_scores_members(torch.tensor(unit), 5)
    want_scores, want_evr = jax_pca.pca_scores_members(unit, np.int32(50), 5)
    assert scores.shape == (3, 50, 5) and evr.shape == (3, 5)
    np.testing.assert_allclose(align_signs(scores.numpy(), np.asarray(want_scores)),
                               np.asarray(want_scores), atol=1e-5)
    np.testing.assert_allclose(evr.numpy(), np.asarray(want_evr), atol=1e-5)
    for m in range(3):  # each member is its single PCA
        alone = port_pca.PCA(5, device="cpu")
        single = alone.fit_transform(unit[m])
        np.testing.assert_allclose(scores[m].numpy(), single, atol=1e-6)
        np.testing.assert_allclose(evr[m].numpy(), alone.explained_variance_ratio_, atol=1e-7)


def test_tsne_members_deterministic_stages_match_jax():
    spaces, _ = blobs(3, 60, 12, seed=2)
    x = np.stack(spaces)
    p = port_tsne._joint_probabilities(port_tsne._sq_distances(torch.tensor(x)), 12.0).numpy()
    y0 = port_tsne._pca_init(torch.tensor(x), 2).numpy()
    for m in range(3):
        want = np.asarray(jax_tsne._joint_probabilities(jax_tsne._sq_distances(x[m]),
                                                        np.float32(12.0)))
        np.testing.assert_allclose(p[m], want, rtol=1e-5, atol=5e-5 * want.max())
        want0 = np.asarray(jax_tsne._pca_init(x[m], np.int32(60), 2, 2))
        np.testing.assert_allclose(align_signs(y0[m], want0), want0,
                                   atol=1e-5 * np.abs(want0).max())
        np.testing.assert_allclose(np.std(y0[m][:, 0]), 1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tsne_population():
    spaces, labels = blobs(3, 60, 20, seed=3, spread=2.0)
    x = np.stack(spaces)
    got = port_tsne.tsne_fit_transform_members(x, perplexity=20.0, device="cpu")
    want = jax_tsne.tsne_fit_transform_members(x, perplexity=20.0)
    return x, got, want


def test_tsne_population_quality_matches_jax(tsne_population):
    x, (emb, kl), (want_emb, want_kl) = tsne_population
    assert emb.shape == (3, 60, 2) and kl.shape == (3,) and np.isfinite(emb).all()
    for m in range(3):
        assert_tsne_quality(x[m], emb[m], want_emb[m], f"member {m}")
        assert abs(kl[m] - want_kl[m]) <= 0.1 * want_kl[m]


def test_tsne_population_member_matches_its_single_run(tsne_population):
    x, (emb, kl), _ = tsne_population
    for m in range(3):
        single = port_tsne.TSNE(perplexity=20.0, device="cpu")
        alone = single.fit_transform(x[m])
        assert_tsne_quality(x[m], emb[m], alone, f"member {m}")
        assert abs(kl[m] - single.kl_divergence_) <= 0.1 * single.kl_divergence_
    with pytest.raises(ValueError, match="perplexity"):
        port_tsne.tsne_fit_transform_members(x[:, :10], device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        port_tsne.tsne_fit_transform_members(x[:, :1], perplexity=0.5, device="cpu")


# --- the cohort analysis ------------------------------------------------------

def test_analyze_cohort_population_matches_jax():
    spaces, labels = blobs(3, 80, 64, seed=4)  # > 50 columns: PCA-50 before the t-SNE
    got = port_common.analyze_cohort_population(spaces, labels, device="cpu")
    want = jax_common.analyze_cohort_population(spaces, labels)
    for m, ((pca2, tsne2, scores), (wpca2, wtsne2, wscores)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(align_signs(pca2, wpca2), wpca2, atol=1e-4 * np.abs(
            wpca2).max())
        assert_tsne_quality(scaled(spaces[m]), tsne2, wtsne2, f"member {m}")
        assert_scores(scores, wscores, f"member {m}")
    # each member scored alone by the plain path gives the same orig and PCA scores
    pca2, _, scores = got[1]
    alone = port_common.cluster_scores(spaces[1], labels, pca2, got[1][1], device="cpu")
    for key in ("orig_silhouette", "orig_nh", "pca_silhouette", "pca_nh", "tsne_silhouette",
                "tsne_nh"):
        np.testing.assert_allclose(alone[key], scores[key], atol=1e-6, err_msg=key)
    one_label = port_common.analyze_cohort_population(spaces[:2], np.zeros(80, int),
                                                      device="cpu")
    assert [s for _, _, s in one_label] == [None, None]


def test_dimensionality_reduction_matches_jax(monkeypatch):
    """Against the JAX package's device route (its Gram PCA and exact t-SNE
    on one device)."""
    monkeypatch.setattr(jax_common, "_tpu_backend", lambda n_rows=None: True)
    monkeypatch.setattr(jax_tsne, "resolve_tsne", lambda n_rows=None: functools.partial(
        jax_tsne.TSNETPU, shard=False))
    monkeypatch.setattr(jax_pca, "_eval_mesh", lambda shard=None: None)
    (x,), labels = blobs(1, 70, 64, seed=5)
    pca, tsne = port_common.perform_dimensionality_reduction(x, device="cpu")
    wpca, wtsne = jax_common.perform_dimensionality_reduction(x)
    np.testing.assert_allclose(align_signs(pca, wpca), wpca, atol=1e-4 * np.abs(wpca).max())
    assert_tsne_quality(scaled(x), tsne, wtsne)
    assert port_common.perform_dimensionality_reduction(x, "pca", device="cpu").shape == (70, 2)
    small = x[:, :8]  # 50 columns or fewer: the t-SNE takes the scaled features
    assert port_common.perform_dimensionality_reduction(small, "tsne", device="cpu").shape == (
        70, 2)
    got = port_common.cluster_scores(x, labels, pca, tsne, device="cpu")
    want = jax_common.cluster_scores(x, labels, pca, tsne)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **SCORE)
    assert port_common.cluster_scores(x, np.ones(70), pca, tsne, device="cpu") is None


def test_prepare_features_takes_frames_and_dicts():
    rng = np.random.default_rng(6)
    a, b = rng.random((7, 3), np.float32), rng.random((7, 2), np.float32)
    df = pd.DataFrame({"a": list(a), "b": list(b), "site": np.arange(7)})
    want = jax_common.prepare_features(df, ["a", "missing", "b"])
    np.testing.assert_array_equal(port_common.prepare_features(df, ["a", "missing", "b"]), want)
    np.testing.assert_array_equal(
        port_common.prepare_features({"a": a, "b": b}, ["a", "missing", "b"]), want)
    assert port_common.prepare_features({"a": a}, ["missing"]) is None
    assert port_common.CLASS_SHORT_LABELS == jax_common.CLASS_SHORT_LABELS


# --- the imputation methods' clustering main ----------------------------------

def record_plots(mp, module, store):
    def record(features_2d, labels, title, filename, label_encoder=None, **kw):
        store[os.path.basename(filename).rsplit("_", 2)[0]] = np.asarray(features_2d)
    mp.setattr(module, "plot_clusters_2d", record)


def cfg_for(cls, root, plots):
    return cls(input_dim_a=DIM_A, input_dim_b=DIM_B, data_dir=str(root / "data"),
               plots_dir=str(root / plots))


@pytest.fixture(scope="module")
def imputation_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cim")
    write_synthetic_artifacts(str(root / "data"), n_samples=N, dim_a=DIM_A, dim_b=DIM_B,
                              n_sites=N_SITES, n_unmatched=N_UNMATCHED)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EVAL_BACKEND", raising=False)
        mp.delenv("KNN_BACKEND", raising=False)
        plots = {}
        record_plots(mp, jax_cim, plots)
        runs["jax"] = (jax_cim.main(cfg_for(JaxConfig, root, "plots_jax")), plots)
    with pytest.MonkeyPatch.context() as mp:
        for name, data in (("pickles", None), ("arrays", unmatched_cohorts(
                N, N_UNMATCHED, DIM_A, DIM_B, N_SITES, seed=0))):
            plots = {}
            record_plots(mp, port_cim, plots)
            runs[name] = (port_cim.main(cfg_for(PortConfig, root, f"plots_{name}"), data=data,
                                        device="cpu"), plots)
    return root, runs


def test_imputation_methods_main_matches_jax(imputation_runs):
    root, runs = imputation_runs
    (got, got_plots), (want, want_plots) = runs["pickles"], runs["jax"]
    assert [(r["method"], r["cohort"]) for r in got] == [(r["method"], r["cohort"]) for r in want]
    assert len(got) == 6
    assert sorted(got_plots) == sorted(want_plots) and len(got_plots) == 12
    rna_only = pd.read_pickle(root / "data" / "rna_only_unmatched.pkl")
    dna_only = pd.read_pickle(root / "data" / "dna_only_unmatched.pkl")
    for rec, ref in zip(got, want):
        what = f"{rec['cohort']} {rec['method']}"
        assert_scores(rec, ref, what)
        tag = "{}_tsne_{}".format(rec["cohort"].lower().replace("-", "_"),
                                  rec["method"].lower().replace(" ", "_"))
        cohort = rna_only if rec["cohort"] == "RNA-only" else dna_only
        measured = np.log1p(np.stack(cohort["tpm_unstranded"])) if rec["cohort"] == "RNA-only" \
            else np.stack(cohort["beta_value"])
        assert_tsne_quality(scaled(measured), got_plots[tag], want_plots[tag], what)


def test_imputation_methods_main_takes_arrays(imputation_runs):
    _, runs = imputation_runs
    (got, plots), (want, want_plots) = runs["arrays"], runs["pickles"]
    assert got == want
    assert sorted(plots) == sorted(want_plots)
    for key, emb in plots.items():
        np.testing.assert_array_equal(emb, want_plots[key])


@pytest.fixture(scope="module")
def grouped_and_single():
    """The RNA-only cohort's three imputations (the ``data=`` tables of
    `main`, one row of a site the matched table lacks) through
    `analyze_cohort_grouped`, and each alone through `analyze_samples`;
    then the grouped path with one live method beside an empty one."""
    from vae_los_angeles_torch.data.splits import SiteCodes
    from vae_los_angeles_torch.evaluation import tables

    (tpm, beta, site), (raw, rna_site), _ = unmatched_cohorts(N, N_UNMATCHED, DIM_A, DIM_B,
                                                              N_SITES, seed=0)
    rna_site = rna_site.copy()
    rna_site[5] = 99  # filtered out alike by every method's analysis
    train = {"tpm_unstranded": tpm, "beta_value": beta, "primary_site": site,
             "primary_site_encoded": site}
    rna = {"tpm_unstranded": raw, "primary_site": rna_site, "primary_site_encoded": rna_site}
    enc = SiteCodes(site)
    entries = [("Mean", port_cim.apply_mean_imputation(train, rna, None)[0]),
               ("KNN", port_cim.apply_knn_imputation(train, rna, None, device="cpu")[0]),
               ("Conditioned KNN", port_cim.apply_conditioned_knn_imputation(
                   train, rna, None, enc, device="cpu")[0])]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        plots = {}
        record_plots(mp, port_cim, plots)
        out["grouped"] = (port_cim.analyze_cohort_grouped(entries, enc, STAMP, "RNA-only",
                                                          device="cpu"), plots)
        out["single"] = []
        for method, table in entries:
            plots = {}
            record_plots(mp, port_cim, plots)
            out["single"].append((port_cim.analyze_samples(table, enc, STAMP, method, "RNA-only",
                                                           device="cpu"), plots))
        plots = {}
        record_plots(mp, port_cim, plots)
        empty = tables.select(entries[1][1], np.zeros(N_UNMATCHED, bool))
        out["one"] = (port_cim.analyze_cohort_grouped([entries[0], ("KNN", empty)], enc, STAMP,
                                                      "RNA-only", device="cpu"), plots)
    rows = rna_site != 99
    out["x"] = scaled(np.concatenate([np.log1p(raw[rows]), entries[0][1]["imputed_beta_value"][
        rows]], axis=1))
    return out


def test_population_members_match_analyze_samples(grouped_and_single):
    """Each member of a cohort's population against the plain per-method
    function: the orig and PCA spaces' scores to 1e-5, the PCA embedding
    sign-aligned, the t-SNE by quality."""
    got, got_plots = grouped_and_single["grouped"]
    assert [r["method"] for r in got] == ["Mean", "KNN", "Conditioned KNN"]
    for rec, (want, want_plots) in zip(got, grouped_and_single["single"]):
        what = rec["method"]
        tag = "rna_only_{}_" + what.lower().replace(" ", "_")
        pca2, wpca2 = got_plots[tag.format("pca")], want_plots[tag.format("pca")]
        assert pca2.shape == (N_UNMATCHED - 1, 2)
        np.testing.assert_allclose(align_signs(pca2, wpca2), wpca2,
                                   atol=1e-4 * np.abs(wpca2).max(), err_msg=what)
        for key in ("orig_silhouette", "orig_nh", "pca_silhouette", "pca_nh"):
            np.testing.assert_allclose(rec[key], want[key], atol=1e-5, rtol=0, err_msg=key)
        for key in ("tsne_silhouette", "tsne_nh"):
            assert abs(rec[key] - want[key]) <= TSNE_SCORE, (what, key, rec[key], want[key])
        if what == "Mean":
            assert_tsne_quality(grouped_and_single["x"], got_plots[tag.format("tsne")],
                                want_plots[tag.format("tsne")], what)


def test_population_of_one_method(grouped_and_single):
    (mean, empty), plots = grouped_and_single["one"]
    assert empty is None and sorted(plots) == ["rna_only_pca_mean", "rna_only_tsne_mean"]
    want, want_plots = grouped_and_single["single"][0]
    for key in ("orig_silhouette", "orig_nh", "pca_silhouette", "pca_nh"):
        np.testing.assert_allclose(mean[key], want[key], atol=1e-5, rtol=0, err_msg=key)
    assert_tsne_quality(grouped_and_single["x"], plots["rna_only_tsne_mean"],
                        want_plots["rna_only_tsne_mean"], "one member")


def test_grouped_methods_must_share_rows():
    rows = {"tpm_unstranded": np.ones((6, 3), np.float32), "imputed_beta_value": np.ones(
        (6, 2), np.float32), "primary_site_encoded": np.arange(6) % 2}
    fewer = {k: v[:5] for k, v in rows.items()}
    from vae_los_angeles_torch.data.splits import SiteCodes

    with pytest.raises(ValueError, match="differ"):
        port_cim.analyze_cohort_grouped([("Mean", rows), ("KNN", fewer)], SiteCodes([0, 1]),
                                        "r", "RNA-only", device="cpu")


def test_imputations_match_jax():
    rng = np.random.default_rng(7)
    train = pd.DataFrame({"tpm_unstranded": list(rng.random((30, 6), np.float32)),
                          "beta_value": list(rng.random((30, 4), np.float32)),
                          "primary_site_encoded": rng.integers(0, 3, 30)})
    rna = pd.DataFrame({"tpm_unstranded": list(rng.random((9, 6), np.float32) * 5),
                        "primary_site": ["a", "b", "c", "z", "a", "b", "c", "a", "b"]})
    dna = pd.DataFrame({"beta_value": list(rng.random((8, 4), np.float32)),
                        "primary_site": ["a", "b", "c", "a", "z", "c", "a", "b"]})

    class Enc:
        classes_ = np.array(["a", "b", "c"])

        def transform(self, y):
            return np.searchsorted(self.classes_, np.asarray(y))

    cols = {"imputed_beta_value": "rna", "imputed_tpm_unstranded": "dna"}
    for name, kw, port_kw in (
            ("apply_mean_imputation", {}, {}),
            ("apply_knn_imputation", {}, {"device": "cpu"}),
            ("apply_conditioned_knn_imputation", {"label_encoder": Enc()}, {"device": "cpu"})):
        got = getattr(port_cim, name)(train, rna, dna, **kw, **port_kw)
        want = getattr(jax_cim, name)(train, rna, dna, **kw)
        for g, w, col in zip(got, want, cols):
            assert list(g.index) == list(w.index)
            np.testing.assert_allclose(np.stack(g[col]), np.stack(w[col]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {col}")


# --- the EDA boxplots and the plots -------------------------------------------

def test_boxplot_columns_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    tpm = rng.random((40, 30)).astype(np.float32)
    tpm[:, [3, 7]] = 1.0  # zero-variance genes are skipped by the lowest pick
    beta = rng.random((40, 25)).astype(np.float32)
    genes = [f"GENE_{i}" for i in range(30)]
    probes = [f"cg{i:04d}" for i in range(25)]
    seen = []
    monkeypatch.setattr(jax_box, "_variance_boxplot",
                        lambda m, names, idx, *a: seen.append(np.asarray(idx)))
    write_synthetic_artifacts(str(tmp_path / "data"), n_samples=40, dim_a=30, dim_b=25,
                              n_sites=3, n_unmatched=1)
    df = pd.read_pickle(tmp_path / "data" / "processed_data.pkl")
    df["tpm_unstranded"], df["beta_value"] = list(tpm), list(beta)
    df.to_pickle(tmp_path / "data" / "processed_data.pkl")
    with open(tmp_path / "data" / "feature_names.pkl", "wb") as f:
        pickle.dump({"gene_names": genes, "probe_ids": probes}, f)
    jax_box.main(JaxConfig(data_dir=str(tmp_path / "data"), plots_dir=str(tmp_path / "jax")))
    monkeypatch.setattr(port_box, "_variance_boxplot", lambda *a: None)
    got = port_box.main(PortConfig(data_dir=str(tmp_path / "data"),
                                   plots_dir=str(tmp_path / "port")))
    arrays = port_box.main(PortConfig(plots_dir=str(tmp_path / "port")),
                           data=(tpm, beta, genes, probes))
    assert list(got) == [p[-1] for p in port_box.PLOTS]
    for idx, want, from_arrays in zip(got.values(), seen, arrays.values()):
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(from_arrays, want)
    assert not set(got["rna_genes_distribution_lowest_variance.png"]) & {3, 7}


def test_plots_write_their_files(tmp_path):
    pytest.importorskip("matplotlib")
    from vae_los_angeles_torch.data.splits import SiteCodes
    from vae_los_angeles_torch.evaluation import compare_directional_imputation as port_cmp
    from vae_los_angeles_torch.evaluation import evaluate as port_eval
    from vae_los_angeles_torch.training import cli as port_cli

    rng = np.random.default_rng(9)
    emb, labels = rng.normal(size=(20, 2)), rng.integers(0, 3, 20)
    out = tmp_path / "clustering" / "rna_only_pca_mean_1.png"
    port_common.plot_clusters_2d(emb, labels, "t", str(out), label_encoder=SiteCodes(labels),
                                 figsize=(3, 3))
    a, b = rng.random((5, 6)), rng.random((5, 4))
    port_eval.plot_reconstruction_examples(a, b, a[::-1], b[::-1], str(tmp_path / "eval"),
                                           n_samples=1)
    port_eval.plot_correlation_distributions(a, b, a[::-1], b[::-1], str(tmp_path / "eval"))
    rec = {"_pearson_all": [0.1, 0.2], "PearsonMean": 0.15}
    port_cmp.plot_correlation_distributions(rec, rec, str(tmp_path))
    port_cmp.plot_comparison(a, b, b, a, b, a, b, a, str(tmp_path), n_samples=1)
    path = port_cli.plot_losses([3.0, 2.0], [3.5, 2.5], "r1", "rna2dna", str(tmp_path), 4)
    assert path == str(tmp_path / "training_losses_rna2dna_r1.png")
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.png"))
    assert written == ["clustering/rna_only_pca_mean_1.png", "comparison_sample_0.png",
                       "eval/pearson_distributions.png", "eval/reconstruction_example_0.png",
                       "pearson_distributions.png", "training_losses_rna2dna_r1.png"]


def test_plots_without_matplotlib_say_so(tmp_path, monkeypatch, capsys):
    import sys

    from vae_los_angeles_torch.evaluation import compare_directional_imputation as port_cmp
    from vae_los_angeles_torch.training import cli as port_cli

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "plotly", None)
    port_common.plot_clusters_2d(np.zeros((3, 2)), np.arange(3), "t", str(tmp_path / "a.png"))
    assert port_cli.plot_losses([1.0], [1.0], "r", "m", str(tmp_path)) is None
    port_cmp.create_interactive_plot([], str(tmp_path))
    port_box.main(PortConfig(plots_dir=str(tmp_path)),
                  data=(np.ones((4, 12)), np.ones((4, 11)), list("abcdefghijkl"),
                        list("abcdefghijk")))
    out = capsys.readouterr().out
    assert out.count("matplotlib unavailable") == 6 and "plotly unavailable" in out
    assert not list(tmp_path.rglob("*.png"))
