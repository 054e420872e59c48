"""Training CLI for the RNA→DNA directional VAE (counterpart of
``vae_los_angeles_tpu/training/cli.py``, task ``rna2dna``).

    python -m vae_los_angeles_torch.training.cli [--epochs N] [--seed S]
        [--data_path data/processed_data.pkl] [--resume]

It follows the JAX CLI: load the cohort, split 80/20 (`train_val_indices`),
train with β-warmup + AdamW + the plateau scheduler + early stopping
(`engine.fit`), print the per-epoch lines and append them to
``plots/metrics_rna2dna_<run_id>.jsonl``, save ``best_rna2dna_<run_id>.npz``
and ``resume_rna2dna_<run_id>.npz``, write ``latest_rna2dna_run_id.txt`` and
report the wall clock and samples/s. ``--resume`` continues the latest run
from its carry, and says so instead of training when that run had already
stopped early.

It runs on the card unless asked for the CPU (``device="cpu"`` or
``DEVICE=cpu``). With ``use_pallas`` (``USE_PALLAS=1``) on the card, every
epoch is one call of the epoch kernel, as the JAX CLI picks its whole-epoch
kernel on a TPU; otherwise the plain path trains.

``run_training(data=(tpm, beta, site))`` takes the cohort as arrays (the
tests and ``chip_smoke.py`` do); without it the CLI reads
``processed_data.pkl`` and its ``label_encoder.pkl`` (pandas and sklearn are
imported only there). Not ported yet: the loss plot, the ``--synthetic``
artifact writer, ``--replicates``, ``--dp``, ``--profile`` and the
``WALL_DETAIL`` steady-state probe.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.training import checkpoint, engine
from vae_los_angeles_torch.training.tasks import get_task
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_to_numpy


def load_data(cfg: Config, data_path=None):
    """(dataset, n_sites) from ``processed_data.pkl`` and the label encoder
    beside it."""
    data_path = data_path or os.path.join(cfg.data_dir, "processed_data.pkl")
    le_path = os.path.join(os.path.dirname(data_path) or ".", "label_encoder.pkl")
    if not os.path.exists(data_path):
        raise FileNotFoundError(
            f"{data_path} not found. Run `python scripts/prepare_data.py` "
            "first.")
    print("Loading processed data...")
    dataset = MultiModalDataset.from_pickle(data_path)
    with open(le_path, "rb") as f:  # written by the data preparation step
        n_sites = len(pickle.load(f).classes_)
    print(f"Data shape: ({len(dataset)}, ...)")
    print(f"Number of primary sites: {n_sites}")
    return dataset, n_sites


def _parse(model_name, argv):
    parser = argparse.ArgumentParser(description=f"Train {model_name} on an NVIDIA GPU")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument(
        "--seed", type=int, default=None,
        help="run seed (default 0; on --resume, the seed recorded in the checkpoint)")
    parser.add_argument(
        "--resume", action="store_true",
        help="continue the latest run from its saved training state")
    return parser.parse_args(argv)


def run_training(task_name: str = "rna2dna", model_name: str = "rna2dna", cfg: Config = None,
                 argv=None, data=None, n_sites=None, device=None, root: str = "."):
    """Train, save and report; returns (FitResult or None, run_id, wall seconds).
    ``root`` is where the run-id file goes (the working directory by default)."""
    args = _parse(model_name, argv)
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    task = get_task(task_name)

    resume_carry, start_epoch = None, 0
    if args.resume:
        resume_carry, start_epoch, run_id, saved_seed = checkpoint.load_resume(
            model_name, checkpoint_dir=cfg.checkpoint_dir, root=root)
        if bool(np.asarray(resume_carry["estop"]["stopped"])):
            best_ep = int(np.asarray(resume_carry["estop"]["best_epoch"]))
            print(f"Run {run_id} already early-stopped (best epoch {best_ep + 1}, "
                  f"{start_epoch} epochs ran) — resuming would train 0 epochs. Start a fresh "
                  "run, or retrain with a higher PATIENCE.")
            return None, run_id, 0.0
        if args.seed is None:
            seed = saved_seed if saved_seed is not None else 0
        else:
            seed = args.seed
            if saved_seed is not None and saved_seed != seed:
                print(f"WARNING: --seed {seed} differs from the checkpoint's recorded seed "
                      f"{saved_seed}; the resumed noise schedule will not match the original run")
        print(f"Resuming {model_name} run {run_id} from epoch {start_epoch}")
    else:
        seed = 0 if args.seed is None else args.seed
        run_id = checkpoint.new_run_id()
        print(f"Starting {model_name} training run: {run_id}")

    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    os.makedirs(cfg.plots_dir, exist_ok=True)
    if data is None:
        dataset, n_sites = load_data(cfg, args.data_path)
    else:
        dataset = MultiModalDataset.from_numpy(*data)
        n_sites = int(dataset.primary_site.max()) + 1 if n_sites is None else int(n_sites)
    cfg = cfg.replace(input_dim_a=dataset.tpm_data.shape[1],
                      input_dim_b=dataset.beta_data.shape[1])

    if resume_carry is not None:
        ref_params, _ = task.init(torch.Generator().manual_seed(0), cfg, n_sites, "meta")
        got = tree_map(np.shape, resume_carry["params"])
        want = tree_map(lambda t: tuple(t.shape), ref_params)
        if got != want:
            raise ValueError(
                f"resume checkpoint parameter shapes do not match the current dataset/config "
                f"(data dims {cfg.input_dim_a}/{cfg.input_dim_b}, {n_sites} sites)")

    print("\nSplitting data into train/validation sets...")
    tr_idx, va_idx = train_val_indices(len(dataset), cfg.train_test_split, cfg.random_seed)
    print(f"Train set size: {len(tr_idx)}")
    print(f"Validation set size: {len(va_idx)}")
    train_arrays = (dataset.tpm_data[tr_idx], dataset.beta_data[tr_idx],
                    dataset.primary_site[tr_idx])
    val_arrays = (dataset.tpm_data[va_idx], dataset.beta_data[va_idx],
                  dataset.primary_site[va_idx])

    num_epochs = cfg.num_epochs if args.epochs is None else args.epochs
    print(f"\nStarting training for {num_epochs} epochs...")
    print(f"Early stopping patience: {cfg.patience}")
    fused_epoch = bool(cfg.use_pallas) and device.type == "cuda"
    print(f"Device: {device}; path: {'epoch kernel' if fused_epoch else 'plain'}")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = engine.fit(task_name, cfg, train_arrays, val_arrays, seed, n_sites,
                        num_epochs=num_epochs, resume_carry=resume_carry,
                        start_epoch=start_epoch, fused_epoch=fused_epoch, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    n_ran = result.epochs_ran
    total = start_epoch + num_epochs
    metrics_path = os.path.join(cfg.plots_dir, f"metrics_{model_name}_{run_id}.jsonl")
    with open(metrics_path, "a") as f:
        for epoch in range(n_ran):
            global_epoch = start_epoch + epoch + 1
            print(f"Epoch [{global_epoch}/{total}] | "
                  f"Train Loss: {result.train_losses[epoch]:.2f} | "
                  f"Val Loss: {result.val_losses[epoch]:.2f} | "
                  f"β={float(result.betas[epoch]):.5f}")
            f.write(json.dumps({
                "epoch": global_epoch,
                "train_loss": float(result.train_losses[epoch]),
                "val_loss": float(result.val_losses[epoch]),
                "beta": float(result.betas[epoch]),
                "lr": float(result.lrs[epoch]),
            }) + "\n")
    print(f"Per-epoch metrics appended to {metrics_path}")
    if result.stopped:
        print(f"\nEarly stopping triggered at epoch {start_epoch + n_ran}!")

    model_path = checkpoint.save_best(model_name, run_id, tree_to_numpy(result.params),
                                      tree_to_numpy(result.state), cfg.checkpoint_dir)
    print(f"✓ Best model saved (val_loss: {result.best_val_loss:.2f})")
    checkpoint.save_resume(model_name, run_id, tree_to_numpy(result.carry),
                           start_epoch + n_ran, cfg.checkpoint_dir, seed=seed)
    checkpoint.write_run_id(model_name, run_id, root)

    trained = engine.samples_trained(len(tr_idx), cfg.batch_size, n_ran)
    samples_per_sec = trained / wall if wall > 0 else float("inf")
    print("\n" + "=" * 50)
    print("Training complete!")
    print(f"Run ID: {run_id}")
    print(f"Best validation loss: {result.best_val_loss:.2f}")
    print(f"Best model saved to: {model_path}")
    print(f"Wall-clock: {wall:.2f}s for {n_ran} epochs on {device}, kernels' build included "
          f"where first used ({samples_per_sec:,.0f} samples/sec)")
    print("=" * 50)
    return result, run_id, wall


def main_rna2dna(argv=None):
    """Entry point: ``python -m vae_los_angeles_torch.training.cli``."""
    return run_training("rna2dna", "rna2dna", argv=argv)


if __name__ == "__main__":
    main_rna2dna(sys.argv[1:])
