"""Training CLI (counterpart of ``vae_los_angeles_tpu/training/cli.py``,
tasks ``rna2dna``, ``dna2rna``, ``multimodal``, ``rna2dna_ae`` and
``dna2rna_ae``).

    python -m vae_los_angeles_torch.training.cli [--epochs N] [--seed S]
        [--data_path data/processed_data.pkl] [--resume]
        [--compute_dtype bfloat16] [--moments_dtype bfloat16]
        [--optimizer adafactor]                                # RNA→DNA
    python -m vae_los_angeles_torch.train_dna2rna [same flags]  # DNA→RNA
    python -m vae_los_angeles_torch.train [same flags]          # tri-modal

The tri-modal run (``main_multimodal``, model name ``multivae``) weighs the
site cross-entropy with the balanced class weights of the training rows
(`compute_class_weights`).

It follows the JAX CLI: load the cohort, split 80/20 (`train_val_indices`),
train with β-warmup + AdamW + the plateau scheduler + early stopping
(`engine.fit`), print the per-epoch lines and append them to
``plots/metrics_<model>_<run_id>.jsonl``, save ``best_<model>_<run_id>.npz``
and ``resume_<model>_<run_id>.npz``, write ``latest_<model>_run_id.txt`` and
report the wall clock and samples/s. ``--resume`` continues the latest run
from its carry, and says so instead of training when that run had already
stopped early. ``DEBUG_NANS=1`` prints a ``DEBUG_NANS:`` line and makes
``engine.fit`` raise at the first non-finite value.

It runs on the card unless asked for the CPU (``device="cpu"`` or
``DEVICE=cpu``). With ``use_pallas`` (``USE_PALLAS=1``) on the card, every
epoch of a task with kernels (``engine.FUSED``) is one call of the epoch
kernel, as the JAX CLI picks its whole-epoch kernel on a TPU; otherwise the
plain path trains, and a task without kernels (the directional
autoencoders: ``run_training("rna2dna_ae", "rna2dna_ae", ...)``, the same
for ``dna2rna_ae``) says so and trains there. RNA→DNA data at least
``engine.WIDE_HEAD_MIN_DIM_B`` probes wide trains there through the wide head
kernel instead, once a step.

The wide-regime knobs ``--compute_dtype bfloat16``, ``--moments_dtype
bfloat16`` and ``--optimizer adafactor`` (``COMPUTE_DTYPE``,
``MOMENTS_DTYPE``, ``OPTIMIZER`` in the environment; an explicit flag wins)
train on the plain path: with ``USE_PALLAS=1`` and any of them set, the CLI
says so and trains there, as the JAX CLI routes them to its XLA path, since
the CUDA kernels are fp32 AdamW programs.

``--replicates N`` trains N replicates of the run (the same
hyperparameters, seeds ``vmap_meta.member_seeds(seed, N)``) as one
population (``vmap_meta.fit_trials``, the plain path: under USE_PALLAS it
says so; RNA→DNA runs the loss pair once a member a step), prints each
one's best validation loss (``r{i}=``) and their mean±std, and keeps the
best finite one under the run-id protocol (its resume checkpoint records
its own seed); it refuses N < 1 and ``--resume``, and exits when every
replicate diverged.

``run_training(data=(tpm, beta, site))`` takes the cohort as arrays (the
tests and ``chip_smoke.py`` do); without it the CLI reads
``processed_data.pkl`` and its ``label_encoder.pkl`` (pandas and sklearn are
imported only there). The loss plot (`plot_losses`) imports matplotlib
where it draws; without it a line says so. Not ported yet: the
``--synthetic`` artifact writer, ``--dp``, ``--profile`` and the
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
from vae_los_angeles_torch.evaluation.plotting import pyplot
from vae_los_angeles_torch.ops.nn import resolve_compute_dtype
from vae_los_angeles_torch.parallel import vmap_meta
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


def compute_class_weights(site_labels, n_classes):
    """Balanced class weights: ``n / (k · count_c)`` for each of the k
    classes present in ``site_labels`` (sklearn's ``compute_class_weight(
    "balanced")``), 1 for a class that is absent. numpy only."""
    labels = np.asarray(site_labels).astype(np.int64).reshape(-1)
    present, counts = np.unique(labels, return_counts=True)
    weights = np.ones(n_classes, dtype=np.float32)
    weights[present] = (len(labels) / (len(present) * counts.astype(np.float64))).astype(
        np.float32)
    return weights


def plot_losses(train_losses, val_losses, run_id, model_name, plots_dir="plots",
                start_epoch=0):
    """Loss plot (reference train_rna2dna.py:134-147) →
    ``training_losses_<model>_<run_id>.png``; ``start_epoch`` keeps the
    x-axis in global epoch numbers on resumed runs. Returns the file name,
    or None without matplotlib."""
    plt = pyplot()
    if plt is None:
        return None
    epochs = range(start_epoch, start_epoch + len(train_losses))
    plt.figure(figsize=(10, 6))
    plt.plot(epochs, train_losses, label="Train Loss")
    plt.plot(epochs, val_losses, label="Validation Loss")
    plt.title(f"Training & Validation Loss for {model_name}")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend()
    plt.grid(True)
    filename = os.path.join(plots_dir, f"training_losses_{model_name}_{run_id}.png")
    plt.savefig(filename, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Loss plot saved to {filename}")
    return filename


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
    parser.add_argument(
        "--compute_dtype", choices=["float32", "bfloat16"], default=None,
        help="bfloat16 = matmul operands cast to bf16 inside the loss, fp32 products, fp32 "
        "masters/optimizer/BN (plain path). Same as COMPUTE_DTYPE env")
    parser.add_argument(
        "--moments_dtype", choices=["float32", "bfloat16"], default=None,
        help="bfloat16 = optimizer moments stored reduced, fp32 math. Same as MOMENTS_DTYPE env")
    parser.add_argument(
        "--optimizer", choices=["adamw", "adafactor"], default=None,
        help="adafactor = factored second moments, no first moment (plain path). Default "
        "adamw = torch-parity recipe. Same as OPTIMIZER env")
    parser.add_argument(
        "--replicates", type=int, default=1, metavar="N",
        help="train N replicates (the same hyperparameters, seeds member_seeds(seed, N)) as "
        "one population on the plain path; keeps the best one under the run-id protocol and "
        "reports mean±std. Does not compose with --resume")
    return parser.parse_args(argv)


def _reduced_knobs(cfg: Config) -> dict:
    """The wide-regime knobs set away from the fp32 AdamW recipe, by their
    environment names."""
    reduced = {name: value for name, value in (("COMPUTE_DTYPE", cfg.compute_dtype),
                                               ("MOMENTS_DTYPE", cfg.moments_dtype))
               if resolve_compute_dtype(value) != torch.float32}
    if cfg.optimizer != "adamw":
        reduced["OPTIMIZER"] = cfg.optimizer
    return reduced


def run_training(task_name: str = "rna2dna", model_name: str = "rna2dna", cfg: Config = None,
                 argv=None, data=None, n_sites=None, device=None, root: str = ".",
                 use_class_weights: bool = False):
    """Train, save and report; returns (FitResult or None, run_id, wall seconds).
    ``root`` is where the run-id file goes (the working directory by default);
    ``use_class_weights`` weighs the site loss by the training rows' balanced
    class weights (the tri-modal task)."""
    args = _parse(model_name, argv)
    cfg = cfg or Config.from_env()
    # explicit flags win over env/config spellings of the same knobs
    overrides = {k: v for k, v in (("compute_dtype", args.compute_dtype),
                                   ("moments_dtype", args.moments_dtype),
                                   ("optimizer", args.optimizer)) if v is not None}
    if overrides:
        cfg = cfg.replace(**overrides)
    device = resolve_device(device, cfg)
    task = get_task(task_name)
    if args.replicates < 1:
        raise SystemExit(f"--replicates must be >= 1, got {args.replicates}")
    if args.replicates > 1 and args.resume:
        raise SystemExit("--resume does not compose with --replicates: population members "
                         "train on per-member noise streams that a single resume checkpoint "
                         "cannot reproduce")

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
    class_weights = (compute_class_weights(dataset.primary_site[tr_idx], n_sites)
                     if use_class_weights else None)

    num_epochs = cfg.num_epochs if args.epochs is None else args.epochs
    print(f"\nStarting training for {num_epochs} epochs...")
    print(f"Early stopping patience: {cfg.patience}")
    fused_epoch = bool(cfg.use_pallas) and device.type == "cuda"
    if fused_epoch and task_name not in engine.FUSED:
        print(f"USE_PALLAS: {task_name} has no CUDA kernels; using the plain path")
        fused_epoch = False
    reduced = _reduced_knobs(cfg)
    if reduced and cfg.use_pallas:
        req = ", ".join(f"{k}={v}" for k, v in reduced.items())
        print(f"{req}: using the plain path (the CUDA kernels are fp32 AdamW programs)")
        fused_epoch = False
    if args.replicates > 1 and fused_epoch:
        print("--replicates: using the plain population path (vmap_meta.fit_trials)")
        fused_epoch = False
    path = "plain"
    if fused_epoch:
        path = "wide head kernel" if engine.uses_wide_head(task_name, cfg) else "epoch kernel"
    print(f"Device: {device}; path: {path}")
    if cfg.debug_nans:
        # as the JAX CLI's jax_debug_nans: stop at the first NaN instead of
        # training to a silent NaN loss, at the cost of a sync a step
        check = ("the loss and the updated parameters checked after every kernel call"
                 if fused_epoch else
                 "torch.autograd anomaly detection and every step's loss checked")
        print(f"DEBUG_NANS: {check}; the first non-finite value raises")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if args.replicates > 1:
        result, seed = _train_replicates(task_name, cfg, train_arrays, val_arrays, seed,
                                         n_sites, num_epochs, class_weights, args.replicates,
                                         device)
    else:
        result = engine.fit(task_name, cfg, train_arrays, val_arrays, seed, n_sites,
                            num_epochs=num_epochs, resume_carry=resume_carry,
                            start_epoch=start_epoch, fused_epoch=fused_epoch, device=device,
                            class_weights=class_weights)
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
    print("\nGenerating loss plots...")
    plot_losses(result.train_losses[:n_ran], result.val_losses[:n_ran], run_id, model_name,
                cfg.plots_dir, start_epoch=start_epoch)
    checkpoint.write_run_id(model_name, run_id, root)

    # with --replicates the wall covers the whole population: count its samples
    trained = engine.samples_trained(len(tr_idx), cfg.batch_size, n_ran) * args.replicates
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


def _train_replicates(task_name, cfg, train_arrays, val_arrays, seed, n_sites, num_epochs,
                      class_weights, n, device):
    """``n`` replicates of one run as one population (``vmap_meta.fit_trials``
    with one lr population, seeds ``member_seeds(seed, n)``); prints each
    one's best validation loss and their mean±std, and returns the best
    finite replicate's ``FitResult`` with its seed (a resume of its
    checkpoint continues its noise stream). Exits when every replicate
    diverged."""
    seeds = vmap_meta.member_seeds(seed, n)
    res = vmap_meta.fit_trials(task_name, cfg, train_arrays, val_arrays, seed, n_sites,
                               {"lr": np.full(n, cfg.learning_rate, np.float32)},
                               num_epochs=num_epochs, class_weights=class_weights, seeds=seeds,
                               device=device)
    best_vals = np.asarray([r.best_val_loss for r in res])
    finite = np.isfinite(best_vals)
    if not finite.any():
        raise SystemExit("every replicate diverged to a non-finite validation loss — "
                         "nothing to save")
    best_r = int(np.argmin(np.where(finite, best_vals, np.inf)))
    print("\nReplicates (best val loss each): "
          + ", ".join(f"r{r}={v:.2f}" for r, v in enumerate(best_vals)))
    print(f"mean={best_vals[finite].mean():.2f} std={best_vals[finite].std():.2f} -> keeping "
          f"replicate {best_r}")
    return res[best_r], seeds[best_r]


def main_rna2dna(argv=None):
    """Entry point: ``python -m vae_los_angeles_torch.training.cli``."""
    return run_training("rna2dna", "rna2dna", argv=argv)


def main_dna2rna(argv=None):
    """Entry point: ``python -m vae_los_angeles_torch.train_dna2rna``."""
    return run_training("dna2rna", "dna2rna", argv=argv)


def main_multimodal(argv=None):
    """Entry point: ``python -m vae_los_angeles_torch.train`` (the root
    ``train.py``): the tri-modal MultiModalVAE with balanced class weights."""
    return run_training("multimodal", "multivae", argv=argv, use_class_weights=True)


if __name__ == "__main__":
    main_rna2dna(sys.argv[1:])
