"""The unmatched-cohort flow of the port against the JAX package on the CPU:
``data.synthetic.unmatched_cohorts`` against the JAX package's pickled
frames, ``reconstruct_unmatched.main`` and
``clustering.cluster_reconstructed.main`` on the same
``write_synthetic_artifacts`` pickles and JAX-written checkpoints.

The reconstruction is made deterministic here, in the test alone, as
``test_torch_slice.py`` makes it: the JAX side decodes z = mu (its
``reparameterize`` patched, its jitted forward rebuilt), the port serves
through its fused route (``use_pallas``, the kernel's plain version on the
CPU) with ``use_noise=False``. The reconstructed columns agree to atol =
rtol = 1e-4; the statistics dict is equal. The clustering main runs both
packages on the JAX-written reconstruction pickles (the JAX side as it runs
on a CPU host: its sklearn route): the original and PCA spaces' silhouette
and hit to 1e-4, the t-SNE space's by quality (trustworthiness within 0.02,
the scores within 0.1). The ``data=`` paths give what the pickle paths
give, exactly. Each main runs once a package (a module-scoped fixture); the
scatter plots are recorded, not drawn.
"""

import glob
import os
import pickle
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.manifold import trustworthiness
from sklearn.preprocessing import StandardScaler

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import unmatched_cohorts
from vae_los_angeles_torch.evaluation import reconstruct_unmatched as port_rec
from vae_los_angeles_torch.evaluation.clustering import cluster_reconstructed as port_cr
from vae_los_angeles_torch.ops.kernels import fused_vae as port_fused
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.synthetic import write_synthetic_artifacts
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.evaluation import reconstruct_unmatched as jax_rec
from vae_los_angeles_tpu.evaluation.clustering import cluster_reconstructed as jax_cr
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, N, N_UNMATCHED = 40, 56, 5, 8, 120, 60
TOL = dict(atol=1e-4, rtol=1e-4)
UNKNOWN = [0, 7, 11]  # RNA-only rows given a site the label encoder does not know
DNA_UNKNOWN = [4]  # a DNA-only row of such a site: served without one, dropped when scored
RUN_ID = "20260102_030405"


def cfg_for(cls, root, data, plots="plots", **kw):
    return cls(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
               data_dir=str(root / data), checkpoint_dir=str(root / "checkpoints"),
               plots_dir=str(root / plots), **kw)


def cohort_arrays():
    """`unmatched_cohorts` with the UNKNOWN and DNA_UNKNOWN rows' site set
    to a code no matched row has, as the pickles' site names are set
    below."""
    matched, (raw, rna_site), (dna_beta, dna_site) = unmatched_cohorts(
        N, N_UNMATCHED, DIM_A, DIM_B, N_SITES, seed=0)
    rna_site, dna_site = rna_site.copy(), dna_site.copy()
    rna_site[UNKNOWN] = 99
    dna_site[DNA_UNKNOWN] = 99
    return matched, (raw, rna_site), (dna_beta, dna_site)


def record_plots(mp, module, store):
    def record(features_2d, labels, title, filename, label_encoder=None, **kw):
        store[os.path.basename(filename).rsplit("_", 2)[0]] = np.asarray(features_2d)
    mp.setattr(module, "plot_clusters_2d", record)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    root = tmp_path_factory.mktemp("unmatched")
    data = root / "data"
    write_synthetic_artifacts(str(data), n_samples=N, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                              n_unmatched=N_UNMATCHED)
    rna_only = pd.read_pickle(data / "rna_only_unmatched.pkl")
    rna_only.loc[UNKNOWN, "primary_site"] = "Atlantis"
    rna_only.to_pickle(data / "rna_only_unmatched.pkl")
    dna_only = pd.read_pickle(data / "dna_only_unmatched.pkl")
    dna_only.loc[DNA_UNKNOWN, "primary_site"] = "Atlantis"
    dna_only.loc[DNA_UNKNOWN, "primary_site_encoded"] = 99  # as `cohort_arrays` codes it
    dna_only.to_pickle(data / "dna_only_unmatched.pkl")
    shutil.copytree(data, root / "data_port")
    out = {"root": root}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)  # the run-id files live in the working directory
        mp.delenv("EVAL_BACKEND", raising=False)
        mp.delenv("KNN_BACKEND", raising=False)
        for name, init, seed in (("rna2dna", jdv.rna2dna_vae_init, 0),
                                 ("dna2rna", jdv.dna2rna_vae_init, 1)):
            params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
            state = jax.tree.map(lambda x: x + 0.2 * jax.random.uniform(
                jax.random.PRNGKey(seed + 7), x.shape), state)
            jax_ckpt.save_best(name, RUN_ID, params, state, str(root / "checkpoints"))
            jax_ckpt.write_run_id(name, RUN_ID)

        mp.setattr(jdv, "reparameterize", lambda key, mu, logvar, noise_scale=None: mu)
        jax_loading._jitted_directional.cache_clear()
        try:
            out["jax_rec"] = jax_rec.main(cfg_for(JaxConfig, root, "data"))
        finally:
            jax_loading._jitted_directional.cache_clear()

        calls = out["fused_calls"] = []
        call = port_fused._FusedForward.__call__

        def deterministic(self, x, site=None, seed=0, use_noise=True, eps=None):
            calls.append((type(self).__name__, len(x), site is None))
            return call(self, x, site, seed, use_noise=False)

        mp.setattr(port_fused._FusedForward, "__call__", deterministic)
        port_cfg = cfg_for(PortConfig, root, "data_port", use_pallas=True)
        out["port_rec"] = port_rec.main(port_cfg, root=str(root), device="cpu")
        arrays = cohort_arrays()
        out["port_rec_arrays"] = port_rec.main(
            cfg_for(PortConfig, root, "data_arrays", use_pallas=True), data=arrays,
            root=str(root), device="cpu")

        for name, module, cfg, data_arg in (
                ("jax_cr", jax_cr, cfg_for(JaxConfig, root, "data", "plots_jax"), None),
                ("port_cr", port_cr, cfg_for(PortConfig, root, "data", "plots_port"), None),
                ("port_cr_own", port_cr, cfg_for(PortConfig, root, "data_port", "plots_own"),
                 None),
                ("port_cr_arrays", port_cr, cfg_for(PortConfig, root, "data", "plots_arrays"),
                 (*out["port_rec_arrays"], arrays[0][2]))):
            plots = {}
            record_plots(mp, module, plots)
            kw = {} if module is jax_cr else {"data": data_arg, "device": "cpu"}
            out[name] = (module.main(cfg, **kw), plots)
    return out


def test_unmatched_cohorts_are_the_jax_writers_frames(tmp_path):
    write_synthetic_artifacts(str(tmp_path), n_samples=50, dim_a=9, dim_b=7, n_sites=4, seed=3,
                              n_unmatched=6)
    (tpm, beta, site), (raw, rna_site), (dna_beta, dna_site) = unmatched_cohorts(
        50, 6, 9, 7, 4, seed=3)
    matched = pd.read_pickle(tmp_path / "processed_data.pkl")
    rna_only = pd.read_pickle(tmp_path / "rna_only_unmatched.pkl")
    dna_only = pd.read_pickle(tmp_path / "dna_only_unmatched.pkl")
    for got, frame, col in ((tpm, matched, "tpm_unstranded"), (beta, matched, "beta_value"),
                            (raw, rna_only, "tpm_unstranded"), (dna_beta, dna_only, "beta_value")):
        want = np.stack(frame[col])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)  # bit for bit
    for got, frame in ((site, matched), (rna_site, rna_only), (dna_site, dna_only)):
        np.testing.assert_array_equal(got, frame["primary_site_encoded"].values)
    assert "beta_value" not in rna_only and "tpm_unstranded" not in dna_only


def test_reconstruction_matches_jax(flow):
    (got_rna, got_dna), (want_rna, want_dna) = flow["port_rec"], flow["jax_rec"]
    assert len(got_rna) == len(want_rna) == N_UNMATCHED - len(UNKNOWN)
    assert len(got_dna) == len(want_dna) == N_UNMATCHED
    for got, want, col in ((got_rna, want_rna, "reconstructed_beta_value"),
                           (got_dna, want_dna, "reconstructed_tpm_unstranded")):
        assert list(got.columns) == list(want.columns)
        assert list(got.index) == list(want.index)
        np.testing.assert_allclose(np.stack(got[col]), np.stack(want[col]), **TOL)
    np.testing.assert_array_equal(got_rna["primary_site_encoded"].values,
                                  want_rna["primary_site_encoded"].values)
    # each cohort is one call of its fused forward; the DNA-only one without a site
    assert flow["fused_calls"][:2] == [("FusedRNA2DNA", N_UNMATCHED - len(UNKNOWN), False),
                                       ("FusedDNA2RNA", N_UNMATCHED, True)]


def test_reconstruction_pickles_and_stats_match_jax(flow):
    root = flow["root"]
    for kind in ("rna_with_reconstructed_dna", "dna_with_reconstructed_rna"):
        (jax_file,) = glob.glob(str(root / "data" / f"{kind}_*.pkl"))
        (port_file,) = glob.glob(str(root / "data_port" / f"{kind}_*.pkl"))
        assert list(pd.read_pickle(port_file).columns) == list(pd.read_pickle(jax_file).columns)
    stats = {}
    for data in ("data", "data_port", "data_arrays"):
        (path,) = glob.glob(str(root / data / "reconstruction_stats_*.pkl"))
        with open(path, "rb") as f:
            stats[data] = pickle.load(f)
        stats[data].pop("timestamp")
    assert stats["data_port"] == stats["data"]
    sites = stats["data"]["rna_only_primary_sites"]
    codes = dict(zip(sorted(sites), range(len(sites))))  # LabelEncoder's sorted codes
    assert stats["data_arrays"]["rna_only_primary_sites"] == {
        codes[k]: v for k, v in sites.items()}
    assert not glob.glob(str(root / "data_arrays" / "*_with_reconstructed_*.pkl"))


def test_reconstruction_takes_arrays(flow):
    (rna, dna), (want_rna, want_dna) = flow["port_rec_arrays"], flow["port_rec"]
    assert isinstance(rna, dict) and isinstance(dna, dict)
    for got, want in ((rna, want_rna), (dna, want_dna)):
        assert set(got) <= set(want.columns)
        for col, values in got.items():
            want_col = np.stack(want[col]) if np.ndim(want[col].iloc[0]) else want[col].values
            if col != "primary_site":  # codes here, names in the pickle
                np.testing.assert_array_equal(values, want_col, err_msg=col)
    assert flow["fused_calls"][2:] == flow["fused_calls"][:2]


def features_of(df, cols):
    return StandardScaler().fit_transform(
        np.concatenate([np.stack(df[c]) for c in cols], axis=1).astype(np.float64))


def test_cluster_reconstructed_matches_jax(flow):
    (got, got_plots), (want, want_plots) = flow["port_cr"], flow["jax_cr"]
    assert [r["cohort"] for r in got] == [r["cohort"] for r in want] == ["RNA-only", "DNA-only"]
    assert sorted(got_plots) == sorted(want_plots) and len(got_plots) == 4
    rna, dna = flow["jax_rec"]
    for rec, ref, (df, cols) in zip(got, want, (
            (rna, ["tpm_unstranded", "reconstructed_beta_value"]),
            (dna, ["beta_value", "reconstructed_tpm_unstranded"]))):
        assert rec["n_samples"] == ref["n_samples"]
        for key in ("orig_silhouette", "orig_nh", "pca_silhouette", "pca_nh"):
            np.testing.assert_allclose(rec[key], ref[key], atol=1e-4, err_msg=key)
        for key in ("tsne_silhouette", "tsne_nh"):
            assert abs(rec[key] - ref[key]) <= 0.1, (key, rec[key], ref[key])
        tag = rec["cohort"].lower().replace("-", "_") + "_tsne_reconstructed"
        x = features_of(df[df["primary_site"] != "Atlantis"], cols)  # the scored rows
        assert abs(trustworthiness(x, got_plots[tag], n_neighbors=5)
                   - trustworthiness(x, want_plots[tag], n_neighbors=5)) <= 0.02


def test_cluster_reconstructed_summary_is_the_jax_text(flow, tmp_path):
    root = flow["root"]
    (report,) = glob.glob(str(root / "plots_port" / "clustering" / "clustering_summary_*.txt"))
    (want,) = glob.glob(str(root / "plots_jax" / "clustering" / "clustering_summary_*.txt"))
    got_lines, want_lines = open(report).read().splitlines(), open(want).read().splitlines()
    assert len(got_lines) == len(want_lines) == 13
    for a, b in zip(got_lines, want_lines):  # the t-SNE values are the descent's own
        if "tsne" not in a:
            assert a.split("=")[0] == b.split("=")[0]
    records = flow["port_cr"][0]
    a = port_cr.write_summary_report(records, "x", str(tmp_path / "port"))
    b = jax_cr.write_summary_report(records, "x", str(tmp_path / "jax"))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_cluster_reconstructed_takes_arrays(flow):
    (got, plots), (want, want_plots) = flow["port_cr_arrays"], flow["port_cr_own"]
    assert got == want
    assert sorted(plots) == sorted(want_plots)
    for key, emb in plots.items():
        np.testing.assert_array_equal(emb, want_plots[key])


def test_cluster_reconstructed_drops_unknown_sites(flow):
    """A DNA-only row whose site the matched table lacks is reconstructed
    (without a site) but not scored, on the pickle path (the label encoder)
    and on the ``data=`` path (the matched site codes) alike."""
    assert len(flow["port_rec"][1]) == len(flow["port_rec_arrays"][1]["beta_value"]) == N_UNMATCHED
    for run in ("jax_cr", "port_cr", "port_cr_own", "port_cr_arrays"):
        rna, dna = flow[run][0]
        assert rna["n_samples"] == N_UNMATCHED - len(UNKNOWN), run
        assert dna["n_samples"] == N_UNMATCHED - len(DNA_UNKNOWN), run


def test_latest_reconstruction_files_by_ctime(tmp_path):
    for i, stamp in enumerate(("20260101_000000", "20250101_000000")):
        for kind in ("rna_with_reconstructed_dna", "dna_with_reconstructed_rna"):
            path = tmp_path / f"{kind}_{stamp}.pkl"
            path.write_bytes(b"")
            os.utime(path, (1_000 + i, 1_000 + i))
    got = port_cr.find_latest_reconstruction_files(str(tmp_path))
    assert got == jax_cr.find_latest_reconstruction_files(str(tmp_path))
    assert port_cr.find_latest_reconstruction_files(str(tmp_path / "none")) == (None, None)


def test_missing_inputs_are_skipped(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    matched, rna, dna = cohort_arrays()
    cfg = cfg_for(PortConfig, tmp_path, "data")
    assert port_rec.main(cfg, data=(matched, rna, dna), root=".", device="cpu") == (None, None)
    assert port_cr.main(cfg, data=(None, None, matched[2]), device="cpu") == []
