"""The serving slice end to end: both packages'
``compare_directional_imputation.main`` on the same synthetic
``processed_data.pkl`` and the same JAX-written checkpoints.

Both are made deterministic here, in the test alone: the JAX side decodes
z = mu by patching ``directional_vae.reparameterize`` (its jitted forward is
rebuilt), the port side serves through its fused route (``use_pallas``, the
kernel's plain version on the CPU) with ``use_noise=False``. The VAE and
mean-imputation records, and the kNN ones (the JAX package's sklearn
baseline at this cohort size, the port's own kNN), must agree to atol =
rtol = 1e-4."""

import json
import os

import jax
import numpy as np
import pytest

from vae_los_angeles_torch.evaluation import compare_directional_imputation as port_compare
from vae_los_angeles_torch.ops.kernels import fused_vae as port_fused
from vae_los_angeles_tpu.config import Config
from vae_los_angeles_tpu.data.synthetic import write_synthetic_artifacts
from vae_los_angeles_tpu.evaluation import compare_directional_imputation as jax_compare
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

DIM_A, DIM_B, N_SITES, LATENT = 40, 56, 5, 8
TOL = dict(atol=1e-4, rtol=1e-4)
METRICS = ("MAE", "MSE", "RMSE", "R2", "CosineSimilarity", "PearsonMean", "PearsonStd")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run-id files live in the working directory
    write_synthetic_artifacts(str(tmp_path / "data"), n_samples=120, dim_a=DIM_A,
                              dim_b=DIM_B, n_sites=N_SITES, n_unmatched=4)
    run_id = "20260102_030405"
    for name, init, seed in (("rna2dna", jdv.rna2dna_vae_init, 0),
                             ("dna2rna", jdv.dna2rna_vae_init, 1)):
        params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
        state = jax.tree.map(
            lambda x: x + 0.2 * jax.random.uniform(jax.random.PRNGKey(seed + 7), x.shape), state
        )
        jax_ckpt.save_best(name, run_id, params, state, str(tmp_path / "checkpoints"))
        jax_ckpt.write_run_id(name, run_id)
    return tmp_path


def cfg_for(tmp_path, plots):
    return Config(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
                  data_dir=str(tmp_path / "data"), checkpoint_dir=str(tmp_path / "checkpoints"),
                  plots_dir=str(tmp_path / plots))


def test_compare_directional_imputation_matches_jax(workdir, monkeypatch):
    monkeypatch.setattr(jdv, "reparameterize", lambda key, mu, logvar, noise_scale=None: mu)
    jax_loading._jitted_directional.cache_clear()
    try:
        want = jax_compare.main(cfg_for(workdir, "plots_jax"))
    finally:
        jax_loading._jitted_directional.cache_clear()

    call = port_fused._FusedForward.__call__
    monkeypatch.setattr(
        port_fused._FusedForward, "__call__",
        lambda self, x, site=None, seed=0, use_noise=True, eps=None: call(
            self, x, site, seed, use_noise=False),
    )
    got = port_compare.main(cfg_for(workdir, "plots_port").replace(use_pallas=True),
                            root=str(workdir), device="cpu")

    want = {(r["Modality"], r["Model"]): r for r in want}
    assert [(r["Modality"], r["Model"]) for r in got] == list(want)
    for rec in got:
        ref = want[(rec["Modality"], rec["Model"])]
        for k in METRICS:
            np.testing.assert_allclose(rec[k], ref[k], err_msg=f"{rec['Model']} {k}", **TOL)
        np.testing.assert_allclose(rec["_pearson_all"], ref["_pearson_all"], **TOL)

    (out_dir,) = os.listdir(workdir / "plots_port")
    with open(workdir / "plots_port" / out_dir / "comparison_results.json") as f:
        saved = json.load(f)
    assert [s["Model"] for s in saved] == [r["Model"] for r in got]
    assert all("_pearson_all" not in s for s in saved)
    with open(workdir / "plots_port" / out_dir / "comparison_results.csv") as f:
        lines = f.read().splitlines()
    assert lines[0].split(",")[:3] == ["Modality", "Model", "MAE"] and len(lines) == 7


def test_compare_takes_arrays_and_serves_one_direction(workdir):
    """``data=`` arrays in place of the pickle; a missing model is skipped."""
    from vae_los_angeles_torch.data.dataset import MultiModalDataset

    ds = MultiModalDataset.from_pickle(str(workdir / "data" / "processed_data.pkl"))
    os.remove("latest_dna2rna_run_id.txt")
    got = port_compare.main(cfg_for(workdir, "plots_arrays"),
                            data=(ds.tpm_data, ds.beta_data, ds.primary_site), root=".",
                            device="cpu")
    assert [r["Model"] for r in got] == ["RNA2DNAVAE", "Mean Imputation", "k-NN Imputation"]
    assert all(np.isfinite(r[k]) for r in got for k in METRICS)
    os.remove("latest_rna2dna_run_id.txt")
    assert port_compare.main(cfg_for(workdir, "plots_none"), root=".", device="cpu") is None
