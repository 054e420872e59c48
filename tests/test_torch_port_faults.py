"""Three faults of the port against the JAX package, held closed at small
widths on the CPU, and the tri-modal epoch graph's argument buffer.

* The directional loaders route as the JAX loaders do: the fused kernel
  only with ``use_pallas`` (and fp32) and an input row; without it, and for
  site-only imputation, the plain eval forward, which matches the JAX
  loader's XLA path on the same weights (atol = rtol = 1e-4, fp32 on both
  sides summed in different orders).
* The training CLI routes as the JAX CLI does: with ``USE_PALLAS`` on the
  card only a task with kernels (``engine.FUSED``) takes the epoch kernel;
  any other (the directional autoencoders) trains on the plain path and
  says so, where it used to be sent to the kernel path, which refuses it.
* ``DEBUG_NANS=1`` raises at the first non-finite value, on the plain path
  (the CLI, with its ``DEBUG_NANS:`` line) and on the kernel paths (their
  plain versions here), naming the epoch and step; without it a NaN trains
  on silently, as before.
* The kNN baselines and the t-SNE have no host route: the JAX package's
  resolvers send a CPU host, or ``EVAL_BACKEND=sklearn``, to sklearn, which
  the card's machine lacks; the port's resolvers return its own classes
  whatever ``EVAL_BACKEND`` says, and ``shard=True`` (multi-device) raises.
* ``fused_epoch.epoch_args``: the layout the CUDA graph reads (struct
  EpochArgs of ``csrc/fused_train.cu``), its bias corrections those of the
  directional epochs' host loop, ``(float)(1 - pow((double)β, t))`` computed
  here with the C library's ``pow``, and within 2^-23 of
  ``ops.optim.bias_corrections``, which takes the power in fp32: its
  rounding (an ulp of a number just below 1) survives the subtraction from
  1, so the two differ in the last bits at most steps.
"""

import ctypes
import ctypes.util

import jax
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.evaluation import loading as port_loading
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models.directional_vae import dna2rna_vae_init, rna2dna_vae_init
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT = 24, 30, 4, 6
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {"rna2dna": (rna2dna_vae_init, "rna", DIM_A),
            "dna2rna": (dna2rna_vae_init, "dna", DIM_B)}


def _checkpoint(model_type, tmp_path):
    params, state = FAMILIES[model_type][0](jax.random.PRNGKey(5), DIM_A, DIM_B, N_SITES, LATENT)
    state = jax.tree.map(lambda x: x + 0.2, state)
    jax_ckpt.save_best(model_type, "20260101_000006", params, state, str(tmp_path))
    jax_ckpt.write_run_id(model_type, "20260101_000006", str(tmp_path))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_loader_routes_as_the_jax_loader(model_type, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _checkpoint(model_type, tmp_path)
    _, kw, din = FAMILIES[model_type]
    load = getattr(port_loading, f"load_{model_type}")
    cfg = PortConfig(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
                     checkpoint_dir=str(tmp_path))
    plain = load(cfg=cfg, root=str(tmp_path), device="cpu")
    fused = load(cfg=cfg.replace(use_pallas=True), root=str(tmp_path), device="cpu")
    assert plain._fused is None and fused._fused is not None
    j_model = getattr(jax_loading, f"load_{model_type}")(
        cfg=JaxConfig(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
                      checkpoint_dir=str(tmp_path)), root=str(tmp_path))
    rng = np.random.default_rng(6)
    site = rng.integers(0, N_SITES, size=11)
    x = rng.uniform(size=(11, din)).astype(np.float32)
    # site-only imputation: the posterior is the site's, served by both routes
    _, jmu, jlv = j_model(site=site)
    for model in (plain, fused):
        recon, mu, lv = model(site=site)
        assert recon.shape == (11, DIM_B if kw == "rna" else DIM_A)
        np.testing.assert_allclose(mu, np.asarray(jmu), **TOL)
        np.testing.assert_allclose(lv, np.asarray(jlv), **TOL)
    # with a row, both routes give the JAX posterior
    _, jmu, jlv = j_model(**{kw: x}, site=site)
    for model in (plain, fused):
        _, mu, lv = model(**{kw: x}, site=site)
        np.testing.assert_allclose(mu, np.asarray(jmu), **TOL)
        np.testing.assert_allclose(lv, np.asarray(jlv), **TOL)
    with pytest.raises(ValueError, match="at least one"):
        plain()


class _Picked(Exception):
    """Raised by the stand-in ``engine.fit``: the CLI has chosen its path."""


@pytest.mark.parametrize("task, kernel", [("rna2dna_ae", False), ("dna2rna_ae", False),
                                          ("dna2rna", True)])
def test_cli_routes_a_task_without_kernels_to_the_plain_path(task, kernel, tmp_path,
                                                             monkeypatch, capsys):
    """``run_training`` with USE_PALLAS on a (stand-in) card: the path it
    hands ``engine.fit``, recorded by a stand-in that stops the run there."""
    monkeypatch.chdir(tmp_path)
    picked = []

    def fit(task_name, cfg, *args, fused_epoch=False, device=None, **kw):
        picked.append((task_name, fused_epoch, device.type))
        raise _Picked

    monkeypatch.setattr(port_cli, "resolve_device", lambda device, cfg: torch.device("cuda"))
    monkeypatch.setattr(port_cli.torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(port_engine, "fit", fit)
    cfg = PortConfig(**_cfg_kw(tmp_path), use_pallas=True)
    with pytest.raises(_Picked):
        port_cli.run_training(task, task, cfg=cfg, argv=["--epochs", "1"],
                              data=_rows_with_a_nan(), n_sites=3, root=str(tmp_path))
    assert picked == [(task, kernel, "cuda")]
    out = capsys.readouterr().out
    said = f"USE_PALLAS: {task} has no CUDA kernels; using the plain path"
    assert (said in out) != kernel
    assert ("path: epoch kernel" if kernel else "path: plain") in out


def _rows_with_a_nan(n=64):
    rng = np.random.default_rng(0)
    tpm = rng.uniform(size=(n, 6)).astype(np.float32)
    beta = rng.uniform(size=(n, 5)).astype(np.float32)
    tpm[10, 2] = np.nan
    return tpm, beta, rng.integers(0, 3, size=n)


def _cfg_kw(tmp_path):
    return dict(input_dim_a=6, input_dim_b=5, latent_dim=4, batch_size=16,
                checkpoint_dir=str(tmp_path / "ck"), plots_dir=str(tmp_path / "pl"))


@pytest.mark.parametrize("task", ["rna2dna", "dna2rna", "multimodal"])
def test_debug_nans_raises_at_the_first_nan_and_says_so(task, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DEBUG_NANS", "1")
    data = _rows_with_a_nan()
    cfg = PortConfig.from_env(**_cfg_kw(tmp_path))
    assert cfg.debug_nans
    with pytest.raises(FloatingPointError, match=r"DEBUG_NANS: non-finite loss at epoch 1"):
        port_cli.run_training(task, task, cfg=cfg, argv=["--epochs", "1"], data=data,
                              n_sites=3, device="cpu", root=str(tmp_path))
    assert "DEBUG_NANS: torch.autograd anomaly detection" in capsys.readouterr().out
    # the kernel paths (their plain versions on the CPU): the epoch's per-step
    # losses name the step; the row with the NaN lies in one batch
    train, val = tuple(a[:48] for a in data), tuple(a[48:] for a in data)
    for path in ("fused_epoch", "fused_step"):
        with pytest.raises(FloatingPointError, match=r"at epoch 1, step \d"):
            port_engine.fit(task, cfg, train, val, 0, 3, num_epochs=1, device="cpu",
                            **{path: True})


@pytest.mark.parametrize("path", ["plain", "fused_epoch"])
def test_without_debug_nans_a_nan_trains_on(path, tmp_path):
    data = _rows_with_a_nan()
    train, val = tuple(a[:48] for a in data), tuple(a[48:] for a in data)
    res = port_engine.fit("rna2dna", PortConfig(**_cfg_kw(tmp_path)), train, val, 0, 3,
                          num_epochs=1, device="cpu",
                          **({} if path == "plain" else {path: True}))
    assert np.isnan(res.train_losses[0])


def test_epoch_args_pack_the_host_bias_corrections():
    seed, step0, n = 2**62 + 12345, 7, 25
    args = fe.epoch_args(seed, 1e-3, 1.7, 5e-4, 1e-5, step0, n)
    assert args.dtype == np.float32 and args.shape == (6 + 2 * n,)
    assert int(args[:2].view(np.int64)[0]) == seed
    np.testing.assert_array_equal(args[2:6], np.float32([1e-3, 1.7, 5e-4, 1e-5]))
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.pow.argtypes, libm.pow.restype = [ctypes.c_double] * 2, ctypes.c_double
    gaps = []
    for i in range(n):
        t = step0 + i + 1
        _, bc1, bc2 = optim.bias_corrections(torch.tensor(t - 1, dtype=torch.int32))
        for k, (beta, ref) in enumerate(((0.9, bc1), (0.999, bc2))):
            host = np.float32(1.0 - libm.pow(float(np.float32(beta)), float(t)))
            assert args[6 + 2 * i + k] == host, (t, k)
            gaps.append(abs(float(host) - float(ref)))
    assert max(gaps) <= 2.0**-23


@pytest.mark.parametrize("backend", ["sklearn", "auto", "tpu"])
def test_knn_and_tsne_resolve_to_the_port_whatever_eval_backend(backend, monkeypatch):
    from vae_los_angeles_torch.ops import knn, tsne

    monkeypatch.setenv("EVAL_BACKEND", backend)
    assert knn.resolve_knn_regressor(10) is knn.KNNRegressor
    assert knn.resolve_conditioned_knn(10_000) is knn.ConditionedKNNRegressor
    assert tsne.resolve_tsne() is tsne.TSNE


def test_knn_and_tsne_refuse_shard_true():
    from vae_los_angeles_torch.ops import knn, tsne

    x = np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32)
    for call in (lambda: knn.KNNRegressor(shard=True, device="cpu").fit(x, x),
                 lambda: knn.ConditionedKNNRegressor(shard=True, device="cpu").fit(x, x),
                 lambda: knn.knn_grid_mse(x, x, x, x, (5,), ("uniform",), shard=True,
                                          device="cpu"),
                 lambda: tsne.TSNE(perplexity=3.0, shard=True, device="cpu").fit_transform(x)):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            call()
