"""The port's shell entry points on the CPU: ``python -m
vae_los_angeles_torch.train_rna2dna --synthetic --profile`` end to end in a
subprocess (``DEVICE=cpu``), the training CLI's ``--synthetic`` bootstrap
and wall split in-process against the JAX CLI's, the HPO's ``--synthetic``,
the profiling helpers and the console shims. The steady-state probe runs
only on the card; ``chip_smoke.py`` holds it there."""

import glob
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from vae_los_angeles_torch import console
from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data.synthetic import unmatched_cohorts
from vae_los_angeles_torch.evaluation import hpo
from vae_los_angeles_torch.training import checkpoint
from vae_los_angeles_torch.training.cli import run_training
from vae_los_angeles_torch.utils import profiling
from vae_los_angeles_tpu import console as jax_console
from vae_los_angeles_tpu.utils import profiling as jax_profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
DIM_A, DIM_B = 16, 24


def test_shell_run_with_synthetic_and_profile(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DEVICE="cpu", INPUT_DIM_A=str(DIM_A), INPUT_DIM_B=str(DIM_B),
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "vae_los_angeles_torch.train_rna2dna", "--synthetic", "--epochs",
         "1", "--profile", str(tmp_path / "trace")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Generating synthetic data artifacts..." in proc.stdout
    assert f"Profiler trace written to {tmp_path / 'trace'}" in proc.stdout
    split = [line for line in proc.stderr.splitlines() if line.startswith("backend init:")]
    assert len(split) == 1 and split[0].endswith("(steady probe skipped)"), proc.stderr
    assert "| data placement: " in split[0] and "| compile+run: " in split[0]
    for name in artifacts.ARTIFACTS:
        assert (tmp_path / "data" / name).exists(), name
    run_id = checkpoint.get_run_id("rna2dna", str(tmp_path))
    assert run_id is not None
    for kind in ("best", "resume"):
        assert (tmp_path / "checkpoints" / f"{kind}_rna2dna_{run_id}.npz").exists(), kind
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_synthetic_bootstrap_and_wall_split_in_process(tmp_path, monkeypatch, capsys):
    """``--synthetic --data_path`` writes the artifacts beside the named
    pickle, trains on exactly the synthetic matched rows, and the wall split
    is printed; with the artifacts there, a second run reads them."""
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig(input_dim_a=DIM_A, input_dim_b=DIM_B, checkpoint_dir="ckpts",
                     plots_dir="plots", platform="cpu")
    target = tmp_path / "elsewhere" / "cohort.pkl"
    result, run_id, wall = run_training("rna2dna", "rna2dna", cfg=cfg, argv=[
        "--synthetic", "--epochs", "1", "--data_path", str(target)], root=str(tmp_path))
    out, err = capsys.readouterr()
    assert "Generating synthetic data artifacts..." in out
    assert "(steady probe skipped)" in err and wall > 0
    table = artifacts.read_table(str(target))
    (tpm, beta, site), _, _ = unmatched_cohorts(dim_a=DIM_A, dim_b=DIM_B)
    np.testing.assert_array_equal(table["tpm_unstranded"], tpm)
    np.testing.assert_array_equal(table["primary_site_encoded"], site)
    assert (target.parent / "label_encoder.pkl").exists()
    assert not (tmp_path / "data").exists()  # the named pickle's directory, not DATA_DIR

    again, _, _ = run_training("rna2dna", "rna2dna", cfg=cfg, argv=[
        "--synthetic", "--epochs", "1", "--data_path", str(target)], root=str(tmp_path))
    assert "Generating synthetic" not in capsys.readouterr().out
    np.testing.assert_array_equal(again.train_losses, result.train_losses)  # same data, seed


def test_cli_refuses_the_cpu_unasked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("rna2dna", "rna2dna", cfg=PortConfig(input_dim_a=DIM_A, input_dim_b=DIM_B),
                     argv=["--synthetic", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("rna2dna", "rna2dna", argv=["--dp"])  # --dp refuses the CPU unasked too


def test_hpo_synthetic_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig(input_dim_a=DIM_A, input_dim_b=DIM_B, data_dir=str(tmp_path / "data"),
                     checkpoint_dir=str(tmp_path / "checkpoints"), latent_dim=4, embed_dim=4)
    best_params, best_value = hpo.main(["--synthetic", "--trials", "2", "--epochs", "1"],
                                       device="cpu", cfg=cfg)
    assert np.isfinite(best_value) and set(best_params) >= {"latent_dim", "learning_rate"}
    assert (tmp_path / "data" / "processed_data.pkl").exists()
    assert (tmp_path / "best_hyperparameters.json").exists()
    assert (tmp_path / "checkpoints" / "best_multivae_optimized.npz").exists()


def test_profiling_helpers(tmp_path):
    with profiling.StepTimer() as t:
        pass
    assert t.elapsed >= 0
    with profiling.device_timer("cpu") as t:
        torch.ones(4).sum()
    assert t.elapsed >= 0
    with profiling.trace(str(tmp_path / "trace"), cuda=False):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])
    for args in (("samples_per_sec", 1234.56789, "samples/s", 1.234567),
                 ("epoch_ms", 0.5, "ms", 2.0)):
        assert profiling.bench_line(*args) == jax_profiling.bench_line(*args)


def test_console_shims_resolve_and_return_none():
    """Each of the JAX package's 18 shims has its port counterpart, which
    delegates to a real module:attr of the port and returns None (a main's
    result would make ``sys.exit`` fail a successful run)."""
    names = sorted(n for n in dir(jax_console) if not n.startswith("_")
                   and callable(getattr(jax_console, n)) and n != "import_module"
                   and getattr(jax_console, n).__module__ == jax_console.__name__)
    assert len(names) == 18
    for name in names:
        port_module, port_attr = delegate(console, name)
        jax_module, jax_attr = delegate(jax_console, name)
        assert port_module.startswith("vae_los_angeles_torch.")
        assert port_module.split(".", 1)[1] == jax_module.split(".", 1)[1]
        assert port_attr == jax_attr
        module = __import__(port_module, fromlist=["_"])
        assert callable(getattr(module, port_attr)), (name, port_module)


def delegate(shims, name):
    """(module, attr) the shim ``name`` runs, with the import faked; the shim
    must return None although the main returns a truthy non-int."""
    called = {}

    def fake_import(module):
        called["module"] = module

        class Module:
            def __getattr__(self, attr):
                called["attr"] = attr
                return lambda: object()

        return Module()

    with mock.patch.object(shims, "import_module", fake_import):
        assert getattr(shims, name)() is None, name
    return called["module"], called["attr"]
