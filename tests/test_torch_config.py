"""The port's own ``Config`` against the JAX package's, field for field, and
the device policy of the port's entry points: the card by default, the CPU
only when asked (``device="cpu"`` or ``DEVICE=cpu``), never a fallback."""

import dataclasses

import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_tpu.config import Config as JaxConfig

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(JaxConfig)]
ENV = {
    "INPUT_DIM_A": "40", "INPUT_DIM_B": "56", "LATENT_DIM": "8", "BATCH_SIZE": "16",
    "LEARNING_RATE": "0.001", "BETA_WARMUP_EPOCHS": "0", "PATIENCE": "3",
    "CHECKPOINT_DIR": "ck", "USE_PALLAS": "1", "DEBUG_NANS": "yes", "DEVICE": "cpu",
    "COMPUTE_DTYPE": "float32", "RANDOM_SEED": "7",
}


def test_same_fields_in_the_same_order():
    assert [f.name for f in dataclasses.fields(PortConfig)] == FIELDS
    assert [f.type for f in dataclasses.fields(PortConfig)] == [
        f.type for f in dataclasses.fields(JaxConfig)]


@pytest.mark.parametrize("name", FIELDS)
def test_defaults_and_env_overrides_agree(name, monkeypatch):
    assert getattr(PortConfig(), name) == getattr(JaxConfig(), name)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    port, jax_cfg = PortConfig.from_env(), JaxConfig.from_env()
    assert getattr(port, name) == getattr(jax_cfg, name)
    assert type(getattr(port, name)) is type(getattr(jax_cfg, name))
    kw = {"latent_dim": 3}
    assert getattr(PortConfig.from_env(**kw), name) == getattr(JaxConfig.from_env(**kw), name)


def test_replace_keeps_the_port_class():
    cfg = PortConfig().replace(batch_size=8)
    assert isinstance(cfg, PortConfig) and cfg.batch_size == 8


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_policy(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None, PortConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(None, PortConfig(platform="cpu")) == torch.device("cpu")
    assert resolve_device(None, PortConfig(platform="CPU")) == torch.device("cpu")
    monkeypatch.setenv("DEVICE", "cpu")
    assert resolve_device(None, PortConfig.from_env()) == torch.device("cpu")


def _entry_points(tmp_path):
    from vae_los_angeles_torch.evaluation import compare_directional_imputation, loading
    from vae_los_angeles_torch.training import cli, engine

    rng = np.random.default_rng(0)
    data = (rng.uniform(size=(40, 6)).astype(np.float32),
            rng.uniform(size=(40, 5)).astype(np.float32), rng.integers(0, 3, size=40))
    cfg = PortConfig(input_dim_a=6, input_dim_b=5, latent_dim=4, checkpoint_dir=str(tmp_path / "ck"),
                     plots_dir=str(tmp_path / "pl"))
    return {
        "fit": lambda **kw: engine.fit("rna2dna", cfg, data, data, 0, 3, num_epochs=1, **kw),
        "run_training": lambda **kw: cli.run_training(cfg=cfg, argv=["--epochs", "1"], data=data,
                                                      root=str(tmp_path), **kw),
        "load_rna2dna": lambda **kw: loading.load_rna2dna(cfg=cfg, root=str(tmp_path), **kw),
        "load_dna2rna": lambda **kw: loading.load_dna2rna(cfg=cfg, root=str(tmp_path), **kw),
        "compare_directional_imputation.main": lambda **kw: compare_directional_imputation.main(
            cfg, data=data, root=str(tmp_path), **kw),
    }


@pytest.mark.parametrize("entry", ["fit", "run_training", "load_rna2dna", "load_dna2rna",
                                   "compare_directional_imputation.main"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(entry, tmp_path,
                                                                    monkeypatch):
    _no_card(monkeypatch)
    monkeypatch.delenv("DEVICE", raising=False)
    call = _entry_points(tmp_path)[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")  # asked for: runs (a loader without a checkpoint returns None)
