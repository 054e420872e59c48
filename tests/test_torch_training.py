"""The directional training slices against the JAX package: the carry
bridge, the resume file in both directions, one run of each engine from the
same weights, and the port's CLI end to end (its checkpoint served by the
JAX loader). Each check runs for the RNA→DNA task (the tests without a
suffix, as they were) and for the DNA→RNA task (``_dna2rna`` and the
``dna2rna-`` cases), through one body.

The port's noise (torch generators, Philox in the kernels) is not JAX's
threefry, so two runs agree exactly only where the noise does not enter:
the epoch count, β and the learning rate of each epoch. Their train and
final validation losses agree to rtol 5%: over four seeds of each engine at
this size the final validation losses of the two differ by at most 2.4%
(the seeds alone move either engine's by up to 1.5%). For DNA→RNA, over
the 16 pairs of four seeds of each engine, the train losses differ by at
most 3.4% and the final validation losses by at most 4.8%; the pair the
test runs differs by 1.0% and 2.5%."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import loading as port_loading
from vae_los_angeles_torch.ops.kernels import fused_vae as port_fused
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.utils.weights import tree_from_numpy, tree_to_numpy
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt
from vae_los_angeles_tpu.training import engine as jax_engine

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, BATCH = 40, 56, 5, 8, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, batch_size=BATCH)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.fixture(scope="module")
def cohort():
    tpm, beta, site = generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B,
                                                n_sites=N_SITES, seed=0)
    return tpm, beta, site


JAX_INIT = {"rna2dna": jdv.rna2dna_vae_init, "dna2rna": jdv.dna2rna_vae_init}


def _jax_fit(task, cohort):
    """Three epochs of the JAX engine (XLA path) from seeded weights."""
    tpm, beta, site = cohort
    cfg = JaxConfig(**DIMS)
    params, state = JAX_INIT[task](jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT)
    tr = MultiModalArrays(jnp.asarray(tpm[:160]), jnp.asarray(beta[:160]), jnp.asarray(site[:160]))
    va = MultiModalArrays(jnp.asarray(tpm[160:]), jnp.asarray(beta[160:]), jnp.asarray(site[160:]))
    res = jax_engine.fit(task, cfg, tr, va, jax.random.PRNGKey(1), N_SITES, num_epochs=3,
                         init_params=params, init_state=state)
    return task, jax.device_get(res), jax.tree.map(np.asarray, (params, state))


@pytest.fixture(scope="module")
def jax_run(cohort):
    return _jax_fit("rna2dna", cohort)


@pytest.fixture(scope="module")
def jax_run_dna2rna(cohort):
    return _jax_fit("dna2rna", cohort)


def check_carry_round_trip(run):
    _, res, _ = run
    carry = jax.tree.map(np.asarray, res.carry)
    port = tree_from_numpy(carry)
    assert port["opt"]["step"].dtype == torch.int32
    assert port["estop"]["stopped"].dtype == torch.bool
    _same_tree(tree_to_numpy(port), carry)
    assert set(carry["state"]) == {"encoder_rna" if run[0] == "rna2dna" else "encoder_dna"}


def test_carry_round_trips_jax_port_jax_exactly(jax_run):
    check_carry_round_trip(jax_run)


def test_carry_round_trips_jax_port_jax_exactly_dna2rna(jax_run_dna2rna):
    """DNA2RNAVAE's carry holds both BatchNorms' state (bn1, bn2)."""
    check_carry_round_trip(jax_run_dna2rna)
    assert set(jax_run_dna2rna[1].carry["best"]["state"]["encoder_dna"]) == {"bn1", "bn2"}


def check_resume_file(run, tmp_path):
    task, res, _ = run
    carry = jax.tree.map(np.asarray, res.carry)
    jax_ckpt.save_resume(task, "20260101_000001", carry, 3, str(tmp_path), seed=11)
    got, epochs, rid, seed = port_ckpt.load_resume(task, "20260101_000001", str(tmp_path))
    assert (epochs, rid, seed) == (3, "20260101_000001", 11)
    _same_tree(got, carry)
    port_ckpt.save_resume(task, "20260101_000002", tree_from_numpy(carry), 3,
                          str(tmp_path), seed=12)
    back, epochs, _, seed = jax_ckpt.load_resume(task, "20260101_000002", str(tmp_path))
    assert (epochs, seed) == (3, 12)
    _same_tree(back, carry)
    with open(tmp_path / f"resume_{task}_20260101_000001.npz", "rb") as a, \
            open(tmp_path / f"resume_{task}_20260101_000002.npz", "rb") as b:
        assert sorted(np.load(a).files) == sorted(np.load(b).files)


def test_resume_file_moves_between_the_packages(jax_run, tmp_path):
    check_resume_file(jax_run, tmp_path)


def test_resume_file_moves_between_the_packages_dna2rna(jax_run_dna2rna, tmp_path):
    check_resume_file(jax_run_dna2rna, tmp_path)


def check_fit_agrees(run, cohort):
    task, res, (params, state) = run
    tpm, beta, site = cohort
    cfg = PortConfig(**DIMS)
    got = port_engine.fit(task, cfg, (tpm[:160], beta[:160], site[:160]),
                          (tpm[160:], beta[160:], site[160:]), 1, N_SITES, num_epochs=3,
                          init_params=params, init_state=state, device="cpu")
    assert got.epochs_ran == int(res.epochs_ran) == 3
    np.testing.assert_array_equal(got.betas, np.asarray(res.betas))
    np.testing.assert_array_equal(got.lrs, np.asarray(res.lrs))
    np.testing.assert_allclose(got.val_losses[-1], float(res.val_losses[-1]), rtol=0.05)
    np.testing.assert_allclose(got.train_losses, np.asarray(res.train_losses), rtol=0.05)
    assert got.val_losses[-1] < got.val_losses[0]
    assert int(got.carry["opt"]["step"]) == int(res.carry["opt"]["step"]) == 30


def test_port_fit_agrees_with_the_jax_engine(jax_run, cohort):
    check_fit_agrees(jax_run, cohort)


def test_port_fit_agrees_with_the_jax_engine_dna2rna(jax_run_dna2rna, cohort):
    check_fit_agrees(jax_run_dna2rna, cohort)


@pytest.mark.parametrize("task,path", [
    pytest.param("rna2dna", "fused_step", id="fused_step"),
    pytest.param("rna2dna", "fused_epoch", id="fused_epoch"),
    pytest.param("dna2rna", "fused_step", id="dna2rna-fused_step"),
    pytest.param("dna2rna", "fused_epoch", id="dna2rna-fused_epoch"),
])
def test_kernel_paths_run_the_same_recipe(cohort, task, path):
    """On CPU tensors the kernel paths run their plain versions; both draw
    the same noise for one seed, so they train the same run."""
    tpm, beta, site = cohort
    cfg = PortConfig(**DIMS, beta_warmup_epochs=0)
    args = (task, cfg, (tpm[:160], beta[:160], site[:160]),
            (tpm[160:], beta[160:], site[160:]), 4, N_SITES)
    other = {"fused_step": "fused_epoch", "fused_epoch": "fused_step"}[path]
    a = port_engine.fit(*args, num_epochs=3, device="cpu", **{path: True})
    b = port_engine.fit(*args, num_epochs=3, device="cpu", **{other: True})
    np.testing.assert_allclose(a.train_losses, b.train_losses, rtol=1e-6)
    assert np.all(a.betas == np.float32(1e-3))  # warmup 0: full β from the start
    assert a.lrs[0] == np.float32(5e-4)
    with pytest.raises(ValueError, match="full batches"):
        port_engine.fit(task, cfg, (tpm[:150], beta[:150], site[:150]),
                        (tpm[160:], beta[160:], site[160:]), 0, N_SITES, num_epochs=1,
                        drop_last=False, device="cpu", **{path: True})


def _cli_cfg(tmp_path, **kw):
    return PortConfig(**DIMS, checkpoint_dir=str(tmp_path / "checkpoints"),
                      plots_dir=str(tmp_path / "plots"), **kw)


def check_cli(task, cohort, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cli_cfg(tmp_path)
    result, run_id, wall = port_cli.run_training(task, task, cfg=cfg,
                                                 argv=["--epochs", "2", "--seed", "3"],
                                                 data=cohort, n_sites=N_SITES, device="cpu")
    assert result.epochs_ran == 2 and wall > 0
    assert os.path.exists(tmp_path / "checkpoints" / f"best_{task}_{run_id}.npz")
    assert os.path.exists(tmp_path / "checkpoints" / f"resume_{task}_{run_id}.npz")
    assert (tmp_path / f"latest_{task}_run_id.txt").read_text() == run_id
    with open(tmp_path / "plots" / f"metrics_{task}_{run_id}.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert rows[0]["lr"] == pytest.approx(5e-4) and rows[1]["beta"] == pytest.approx(2e-5)
    _, _, _, seed = port_ckpt.load_resume(task, run_id, cfg.checkpoint_dir)
    assert seed == 3

    # the JAX loader serves the port-trained checkpoint; both decode z = mu
    tpm, beta, site = cohort
    kw, x = ("rna", tpm) if task == "rna2dna" else ("dna", beta)
    rows_in, s_in = x[:33], site[:33]
    monkeypatch.setattr(jdv, "reparameterize", lambda key, mu, logvar, noise_scale=None: mu)
    jax_loading._jitted_directional.cache_clear()
    try:
        j_model = getattr(jax_loading, f"load_{task}")(
            cfg=JaxConfig(**DIMS, checkpoint_dir=cfg.checkpoint_dir))
        j_recon, j_mu, j_lv = j_model(**{kw: rows_in}, site=s_in)
    finally:
        jax_loading._jitted_directional.cache_clear()
    call = port_fused._FusedForward.__call__
    monkeypatch.setattr(
        port_fused._FusedForward, "__call__",
        lambda self, x, site=None, seed=0, use_noise=True, eps=None: call(
            self, x, site, seed, use_noise=False))
    p_model = getattr(port_loading, f"load_{task}")(cfg=cfg.replace(use_pallas=True),
                                                    device="cpu")
    recon, mu, lv = p_model(**{kw: rows_in}, site=s_in)
    for got, want in ((recon, j_recon), (mu, j_mu), (lv, j_lv)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_cli_writes_the_four_artifacts_and_the_jax_loader_serves_them(cohort, tmp_path,
                                                                      monkeypatch):
    check_cli("rna2dna", cohort, tmp_path, monkeypatch)


def test_cli_writes_the_four_artifacts_and_the_jax_loader_serves_them_dna2rna(
        cohort, tmp_path, monkeypatch):
    """``main_dna2rna``'s run, served by both loaders (slice 1's kernel's
    plain version here), with the running statistics it trained."""
    check_cli("dna2rna", cohort, tmp_path, monkeypatch)
    assert port_cli.main_dna2rna.__module__ == port_cli.__name__


def test_resume_after_an_early_stop_trains_no_epoch(cohort, tmp_path):
    cfg = _cli_cfg(tmp_path, patience=1, learning_rate=0.5)  # diverges, so it stops at once
    result, run_id, _ = port_cli.run_training(cfg=cfg, argv=["--epochs", "6"], data=cohort,
                                              n_sites=N_SITES, device="cpu", root=str(tmp_path))
    assert result.stopped and result.epochs_ran < 6
    assert np.isnan(result.val_losses[result.epochs_ran:]).all()
    again, rid, wall = port_cli.run_training(cfg=cfg, argv=["--resume"], data=cohort,
                                             n_sites=N_SITES, device="cpu", root=str(tmp_path))
    assert (again, rid, wall) == (None, run_id, 0.0)


def test_resume_continues_a_run(cohort, tmp_path):
    cfg = _cli_cfg(tmp_path)
    first, run_id, _ = port_cli.run_training(cfg=cfg, argv=["--epochs", "1"], data=cohort,
                                             n_sites=N_SITES, device="cpu", root=str(tmp_path))
    more, rid, _ = port_cli.run_training(cfg=cfg, argv=["--resume", "--epochs", "2"], data=cohort,
                                         n_sites=N_SITES, device="cpu", root=str(tmp_path))
    assert rid == run_id and more.epochs_ran == 2
    assert int(more.carry["opt"]["step"]) == 3 * (160 // BATCH)
    np.testing.assert_allclose(more.betas, [2e-5, 4e-5], rtol=1e-6)  # global epochs 1, 2
    with open(tmp_path / "plots" / f"metrics_rna2dna_{run_id}.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1, 2, 3]
