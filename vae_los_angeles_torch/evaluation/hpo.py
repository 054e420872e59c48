"""Hyperparameter optimization (counterpart of
``vae_los_angeles_tpu/evaluation/hpo.py``, the reference's
``optimize_hyperparameters.py``).

    python -m vae_los_angeles_torch.optimize_hyperparameters [--trials N]
        [--epochs E] [--timeout S] [--mode vmapped|optuna] [--seed S]
        [--bucket-size K | --pad-shapes] [--prune-rungs R]

The search space is the reference's: latent_dim 10–100, lr 1e-5–1e-2 (log),
weight_decay 1e-6–1e-3 (log), beta_start 1e-4–1e-2 (log), gamma 0.5–5,
embed_dim ∈ {16, 32, 64}. The objective is the tri-modal MultiModalVAE's
best validation loss with balanced class weights. It writes
``best_hyperparameters.json`` (in the working directory) and retrains the
winner into ``checkpoints/best_multivae_optimized.npz``, in the JAX
checkpoint format.

Two modes, as in the JAX package:
  * ``vmapped`` (default): trials are sampled up front (`sample_trials`,
    the same draws as the JAX package for a seed and bucket size), grouped
    by their (latent_dim, embed_dim), and each group trains as one
    population (``parallel.vmap_meta.fit_trials``: one batched launch a
    layer for all its trials). ``--pad-shapes`` samples latent_dim for
    every trial on its own and groups by embed_dim alone: each trial trains
    at the group's largest latent width with its own 0/1 latent mask (the
    ``multimodal_padded`` task; masked dims add exactly 0 to the loss, the
    KL and the gradients) and its decoders' first layers rescaled to its
    true fan-in (`_padded_carry`).
  * ``optuna``: a sequential Optuna study, each trial one ``engine.fit``
    (segmented with ``--prune-rungs``, continuing from the carry).

Pruning (``--prune-rungs R`` > 1): the epoch budget is cut into R rungs;
after each, the median rule drops the trials whose best validation loss is
strictly worse than the live trials' median (ties survive, a non-finite
value is always dropped), and only the survivors continue from their
carries, with their own seeds, so a survivor trains as its uninterrupted
run. ``--timeout`` is checked between groups and between rungs. Trials
train with early stopping off (``patience=10**6``), as the reference's
objective loop does.

Every trial is ``engine.fit``'s plain path at its seed (the JAX package
trains its trial populations in XLA, never through its Pallas kernels),
with the shared tables padded to ``vmap_meta.bucket_rows`` of their sizes
and the true sizes masked (``engine.fit(masked_sizes=True)``), unless
``POP_MASK_SIZES=0``, as the JAX package's trials; a
trial's seed comes from its global index (`_trial_seeds`), so neither its
group nor a pruned neighbour changes its noise. No pandas here: ``main``
takes ``data=(tpm, beta, site)`` arrays; without them it reads
``processed_data.pkl`` and its ``label_encoder.pkl`` (``data.artifacts``:
the port's pandas-free form anywhere, so on the card too), which
``--synthetic`` first writes where the pickle is missing
(``data.synthetic.ensure_synthetic_artifacts``). It runs on the card unless
``device="cpu"`` or ``DEVICE=cpu``. optuna is imported only in optuna mode.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.data.synthetic import ensure_synthetic_artifacts
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.parallel import comm, vmap_meta
from vae_los_angeles_torch.training import checkpoint, engine
from vae_los_angeles_torch.training.cli import compute_class_weights, load_data
from vae_los_angeles_torch.training.tasks import get_task
from vae_los_angeles_torch.utils.weights import tree_to_numpy

SEARCH_SPACE = {
    "latent_dim": (10, 100),
    "learning_rate": (1e-5, 1e-2),  # log
    "weight_decay": (1e-6, 1e-3),  # log
    "beta_start": (1e-4, 1e-2),  # log
    "gamma": (0.5, 5.0),
    "embed_dim": (16, 32, 64),
}
FIT_KEYS = {"lr": "learning_rate", "weight_decay": "weight_decay",
            "beta_start": "beta_start", "gamma": "gamma"}  # engine name: trial name


def sample_trials(n_trials: int, seed: int = 0, bucket_size: int = 4):
    """``n_trials`` trial dicts, the JAX package's draws: ``ceil(n /
    bucket_size)`` (latent_dim, embed_dim) shapes drawn first, each shared by
    up to ``bucket_size`` consecutive trials (so a population holds more than
    one trial), then each trial's shape-free hyperparameters on their own."""
    rng = np.random.default_rng(seed)
    lo, hi = SEARCH_SPACE["latent_dim"]
    n_buckets = max(1, -(-n_trials // max(1, bucket_size)))
    shapes = [(int(rng.integers(lo, hi + 1)), int(rng.choice(SEARCH_SPACE["embed_dim"])))
              for _ in range(n_buckets)]
    log_uniform = lambda name: float(np.exp(rng.uniform(*np.log(SEARCH_SPACE[name]))))  # noqa: E731
    trials = []
    for i in range(n_trials):
        latent, embed = shapes[i // max(1, bucket_size)]
        trials.append({
            "latent_dim": latent,
            "learning_rate": log_uniform("learning_rate"),
            "weight_decay": log_uniform("weight_decay"),
            "beta_start": log_uniform("beta_start"),
            "gamma": float(rng.uniform(*SEARCH_SPACE["gamma"])),
            "embed_dim": embed,
        })
    return trials


def _rung_lengths(num_epochs: int, rungs: int):
    """The epoch budget cut into ``rungs`` near-equal segments, the first
    ones taking the remainder, each at least one epoch."""
    rungs = max(1, min(rungs, num_epochs)) if num_epochs > 0 else 1
    base, rem = divmod(num_epochs, rungs)
    return [base + (1 if r < rem else 0) for r in range(rungs)]


def _trial_seeds(seed: int, idxs):
    """The run seeds of the trials at global indices ``idxs``: trial i's is
    ``vmap_meta.member_seeds(seed, n)[i]``, whatever its group."""
    return [engine.epoch_seed(seed, int(i)) for i in idxs]


def _pad_latents(carry, latent_dim: int, latents):
    """Write each trial's 0/1 latent mask (its first ``latents[j]`` of
    ``latent_dim`` dims) into the state and the best snapshot of a stacked
    ``multimodal_padded`` carry, and rescale the first layer of the three
    decoders, in the parameters and the best snapshot, by √(latent_dim /
    latents[j]): the padded init drew them at fan-in ``latent_dim``
    (U(±1/√fan_in)), an unpadded trial would at its own. In place; returns
    ``carry``."""
    device = carry["params"]["decoder_a"]["fc1"]["w"].device
    masks = np.zeros((len(latents), latent_dim), np.float32)
    for j, width in enumerate(latents):
        masks[j, :width] = 1.0
    mask = torch.as_tensor(masks).to(device)
    scale = torch.as_tensor(np.sqrt(latent_dim / np.asarray(latents, np.float64)),
                            dtype=torch.float32).to(device)
    carry["state"] = {**carry["state"], "latent_mask": mask}
    carry["best"]["state"] = {**carry["best"]["state"], "latent_mask": mask}
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        fc1 = carry["params"][dec]["fc1"]
        scaled = {"w": fc1["w"] * scale[:, None, None], "b": fc1["b"] * scale[:, None]}
        for tree in (carry["params"], carry["best"]["params"]):
            tree[dec] = {**tree[dec], "fc1": scaled}
    return carry


def _padded_carry(cfg, n_sites, seeds, lrs, latents, device):
    """The population carry of the pad-latent-to-max mode: every trial's
    ``multimodal_padded`` init at the padded width ``cfg.latent_dim`` from
    its seed, then `_pad_latents`."""
    task = get_task("multimodal_padded")
    inits = [task.init(torch.Generator().manual_seed(int(s)), cfg, n_sites, device)
             for s in seeds]
    carry = engine.init_carry(vmap_meta._stack([p for p, _ in inits]),
                              vmap_meta._stack([s for _, s in inits]),
                              np.asarray(lrs, np.float32), cfg.moments_dtype, cfg.optimizer,
                              len(seeds))
    return _pad_latents(carry, cfg.latent_dim, latents)


def run_vmapped(cfg, trials, train_arrays, val_arrays, n_sites, class_weights, num_epochs,
                seed=0, timeout=None, prune_rungs: int = 1, pad_shapes: bool = False,
                device=None):
    """Train the trials, one population a shape group (module docstring);
    returns ``(values, pruned_at)``: each trial's best validation loss (inf
    for a trial never started) and the epoch it was pruned at (-1: it ran to
    its end). ``timeout`` (seconds) is checked before each group and each
    rung after the first: a group not started keeps inf, survivors keep what
    they reached. A group whose live trials all diverge is abandoned, its
    ``pruned_at`` left at -1 (a failure, not a pruning)."""
    device = resolve_device(device, cfg)
    buckets = {}
    for i, t in enumerate(trials):
        key = t["embed_dim"] if pad_shapes else (t["latent_dim"], t["embed_dim"])
        buckets.setdefault(key, []).append(i)

    t0 = time.monotonic()
    values = np.full(len(trials), np.inf)
    pruned_at = np.full(len(trials), -1, np.int64)
    task_name = "multimodal_padded" if pad_shapes else "multimodal"
    for key, idxs in buckets.items():
        latents = [trials[i]["latent_dim"] for i in idxs]
        latent, embed = (max(latents), key) if pad_shapes else key
        if timeout is not None and time.monotonic() - t0 > timeout:
            print(f"  --timeout {timeout:.0f}s reached; skipping bucket latent={latent} "
                  f"embed={embed} ({len(idxs)} trial(s))")
            continue
        bucket_cfg = cfg.replace(latent_dim=latent, embed_dim=embed, patience=10**6)
        pop = {k: np.asarray([trials[i][name] for i in idxs], np.float32)
               for k, name in FIT_KEYS.items()}
        rungs = _rung_lengths(num_epochs, prune_rungs)
        print(f"  bucket latent={latent} embed={embed}: {len(idxs)} trial(s) in one population"
              + (f" (padded widths {sorted(set(latents))})" if pad_shapes else "")
              + (f", {len(rungs)} pruning rungs {rungs}" if len(rungs) > 1 else ""))
        seeds = _trial_seeds(seed, idxs)
        live = list(range(len(idxs)))  # bucket positions still training
        carry = (_padded_carry(bucket_cfg, n_sites, seeds, pop["lr"], latents, device)
                 if pad_shapes else None)
        offset = 0
        for r, rung_epochs in enumerate(rungs):
            if r and timeout is not None and time.monotonic() - t0 > timeout:
                print(f"    --timeout {timeout:.0f}s reached after rung {r - 1}; {len(live)} "
                      f"survivor(s) keep their epoch-{offset} results")
                break
            res = vmap_meta.fit_trials(
                task_name, bucket_cfg, train_arrays, val_arrays, seed, n_sites,
                {k: v[live] for k, v in pop.items()}, num_epochs=rung_epochs,
                class_weights=class_weights, carry0=carry, start_epoch=offset,
                seeds=[seeds[j] for j in live], mesh=vmap_meta.population_mesh(),
                device=device)
            best = np.asarray([trial.best_val_loss for trial in res])
            for j, pos in enumerate(live):
                values[idxs[pos]] = float(best[j])
            offset += rung_epochs
            if r == len(rungs) - 1:
                break
            finite = best[np.isfinite(best)]
            if finite.size == 0:
                print(f"    rung {r}: no finite val loss — bucket abandoned")
                break
            median = float(np.median(finite))
            keep = [j for j, v in enumerate(best) if np.isfinite(v) and v <= median]
            dropped = [pos for j, pos in enumerate(live) if j not in keep]
            for pos in dropped:
                pruned_at[idxs[pos]] = offset
            if dropped:
                print(f"    rung {r}: pruned {len(dropped)} trial(s) at epoch {offset} "
                      f"(median val loss {median:.2f})")
            live = [live[j] for j in keep]
            carry = [res[j].carry for j in keep]
    return values, pruned_at


def _trial_hp(cfg, params):
    """``engine.hyperparams`` of one trial's dict."""
    return engine.hyperparams(cfg, **{k: params[name] for k, name in FIT_KEYS.items()})


def run_optuna(cfg, n_trials, timeout, train_arrays, val_arrays, n_sites, class_weights,
               num_epochs, seed=0, prune_rungs: int = 1, pruner=None, device=None):
    """A sequential Optuna study (the reference's): each trial ``engine.fit``
    at seed ``seed + trial.number``, in ``prune_rungs`` segments continued
    from the carry (the same run as one segment), each epoch reported and
    ``should_prune`` asked, so a pruned trial's later segments never run.
    Without optuna it exits as the JAX package does."""
    try:
        import optuna
    except ImportError:
        raise SystemExit(
            "optuna is not installed in this environment; use the default "
            "--mode vmapped (population search) instead.")
    device = resolve_device(device, cfg)

    def objective(trial):
        params = {
            "latent_dim": trial.suggest_int("latent_dim", *SEARCH_SPACE["latent_dim"]),
            "learning_rate": trial.suggest_float(
                "learning_rate", *SEARCH_SPACE["learning_rate"], log=True),
            "weight_decay": trial.suggest_float(
                "weight_decay", *SEARCH_SPACE["weight_decay"], log=True),
            "beta_start": trial.suggest_float("beta_start", *SEARCH_SPACE["beta_start"],
                                              log=True),
            "gamma": trial.suggest_float("gamma", *SEARCH_SPACE["gamma"]),
            "embed_dim": trial.suggest_categorical("embed_dim",
                                                   list(SEARCH_SPACE["embed_dim"])),
        }
        trial_cfg = cfg.replace(latent_dim=params["latent_dim"], embed_dim=params["embed_dim"],
                                patience=10**6)
        hp = _trial_hp(trial_cfg, params)
        carry, offset, best = None, 0, np.inf
        for rung_epochs in _rung_lengths(num_epochs, prune_rungs):
            res = engine.fit("multimodal", trial_cfg, train_arrays, val_arrays,
                             seed + trial.number, n_sites, num_epochs=rung_epochs,
                             class_weights=class_weights, hp=hp, resume_carry=carry,
                             start_epoch=offset, device=device)
            finite = res.val_losses[np.isfinite(res.val_losses)]
            if finite.size:
                best = min(best, float(finite.min()))
            for epoch, v in enumerate(res.val_losses):
                if np.isfinite(v):
                    trial.report(float(v), offset + epoch)
                    if trial.should_prune():
                        raise optuna.TrialPruned()
            offset += rung_epochs
            carry = res.carry
        return best if np.isfinite(best) else float("inf")

    study = optuna.create_study(direction="minimize", pruner=pruner)
    study.optimize(objective, n_trials=n_trials, timeout=timeout)
    return study


def retrain_best(cfg, best_params, train_arrays, val_arrays, n_sites, class_weights,
                 num_epochs, seed=0, device=None):
    """The winner retrained by ``engine.fit("multimodal")`` at ``seed`` and
    saved to ``<checkpoint_dir>/best_multivae_optimized.npz``; returns
    (FitResult, path)."""
    final_cfg = cfg.replace(latent_dim=int(best_params["latent_dim"]),
                            embed_dim=int(best_params["embed_dim"]))
    res = engine.fit("multimodal", final_cfg, train_arrays, val_arrays, seed, n_sites,
                     num_epochs=num_epochs, class_weights=class_weights,
                     hp=_trial_hp(final_cfg, best_params), device=device)
    path = os.path.join(cfg.checkpoint_dir, "best_multivae_optimized.npz")
    checkpoint.save(path, tree_to_numpy(res.params), tree_to_numpy(res.state))
    print(f"Final optimized model saved to {path} (val loss {res.best_val_loss:.2f})")
    return res, path


def _split(cfg, data):
    """(cfg with the data's widths, train, val, n_sites, class weights) of
    ``data`` arrays or, without them, the pickled cohort."""
    if data is None:
        dataset, n_sites = load_data(cfg)
    else:
        dataset = MultiModalDataset.from_numpy(*data)
        n_sites = int(dataset.primary_site.max()) + 1
    tr_idx, va_idx = train_val_indices(len(dataset), cfg.train_test_split, cfg.random_seed)
    rows = lambda idx: (dataset.tpm_data[idx], dataset.beta_data[idx],  # noqa: E731
                        dataset.primary_site[idx])
    cfg = cfg.replace(input_dim_a=dataset.tpm_data.shape[1],
                      input_dim_b=dataset.beta_data.shape[1])
    return (cfg, rows(tr_idx), rows(va_idx), n_sites,
            compute_class_weights(dataset.primary_site[tr_idx], n_sites))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Hyperparameter optimization on an NVIDIA GPU")
    parser.add_argument("--trials", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--timeout", type=float, default=3000)
    parser.add_argument("--mode", choices=["vmapped", "optuna"], default="vmapped")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--bucket-size", type=int, default=None,
        help="trials sharing one (latent_dim, embed_dim) shape draw in vmapped mode "
        "(default 4); 1 draws every trial's shape on its own. Mutually exclusive with "
        "--pad-shapes")
    parser.add_argument(
        "--prune-rungs", type=int, default=1,
        help="split the epoch budget into this many rungs and apply the median pruning "
        "rule between them (both modes); 1 = no mid-run pruning")
    parser.add_argument(
        "--pad-shapes", action="store_true",
        help="vmapped mode: draw latent_dim for every trial on its own and still batch: "
        "trials sharing an embed_dim train together at the group's largest latent width, "
        "each with a 0/1 latent mask")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="generate synthetic data first if processed_data.pkl is missing (same bootstrap "
        "as the training CLIs)")
    args = parser.parse_args(argv)
    if args.pad_shapes and args.mode == "optuna":
        parser.error("--pad-shapes applies to the vmapped mode only "
                     "(optuna mode is sequential — nothing to batch)")
    if args.pad_shapes and args.bucket_size is not None:
        parser.error("--bucket-size and --pad-shapes are mutually exclusive: pad-shapes "
                     "samples shapes fully independently and batches by embed_dim")
    return args


@comm.writes_files
def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def main(argv=None, data=None, device=None, cfg: Optional[Config] = None):
    """The search, the JSON and the retrained checkpoint; returns
    (best_params, best_value). ``data`` is (tpm, beta, site) arrays; None
    reads ``<data_dir>/processed_data.pkl`` (written first by ``--synthetic`` where it is
    missing).
    Runs on the card unless ``device="cpu"`` or ``DEVICE=cpu``."""
    args = parse_args(argv)
    cfg = cfg or Config.from_env()
    comm.ensure_group(device, cfg)
    device = resolve_device(device, cfg)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    if args.synthetic and data is None:
        ensure_synthetic_artifacts(cfg.data_dir, dim_a=cfg.input_dim_a, dim_b=cfg.input_dim_b)
    cfg, train_arrays, val_arrays, n_sites, class_weights = _split(cfg, data)
    # an explicit --epochs 0 means "no training epochs", as in the training CLIs
    num_epochs = cfg.num_epochs if args.epochs is None else args.epochs

    if args.mode == "vmapped":
        bucket_size = 1 if args.pad_shapes else (
            4 if args.bucket_size is None else args.bucket_size)
        trials = sample_trials(args.trials, args.seed, bucket_size)
        print(f"Running {args.trials} trials (populations"
              + (", padded latents)..." if args.pad_shapes else ")..."))
        values, pruned_at = run_vmapped(
            cfg, trials, train_arrays, val_arrays, n_sites, class_weights, num_epochs,
            args.seed, timeout=args.timeout, prune_rungs=args.prune_rungs,
            pad_shapes=args.pad_shapes, device=device)
        # as optuna's study: only complete trials may win, and a sweep with none is an error
        complete = np.isfinite(values) & (pruned_at < 0)
        for i, (t, v) in enumerate(zip(trials, values)):
            status = "failed" if not np.isfinite(v) else (
                "PRUNED@%d" % pruned_at[i] if pruned_at[i] >= 0 else "complete")
            print(f"  trial {i}: val_loss={v:.2f} [{status}]  {t}")
        if not complete.any():
            raise SystemExit(
                "no trial completed with a finite validation loss — every trial diverged, "
                "was pruned, or was skipped by --timeout; nothing to retrain (try more "
                "--trials, a longer --timeout, or --prune-rungs 1)")
        best_idx = int(np.argmin(np.where(complete, values, np.inf)))
        best_params, best_value = trials[best_idx], float(values[best_idx])
    else:
        study = run_optuna(cfg, args.trials, args.timeout, train_arrays, val_arrays, n_sites,
                           class_weights, num_epochs, args.seed, prune_rungs=args.prune_rungs,
                           device=device)
        best_params, best_value = dict(study.best_params), float(study.best_value)

    print(f"\nBest hyperparameters (val_loss={best_value:.2f}): {best_params}")
    _write_json("best_hyperparameters.json", {"best_params": best_params,
                                              "best_value": best_value})
    print("Saved best_hyperparameters.json")

    print("\nRetraining final model with best hyperparameters...")
    retrain_best(cfg, best_params, train_arrays, val_arrays, n_sites, class_weights,
                 num_epochs, args.seed, device=device)
    return best_params, best_value


if __name__ == "__main__":
    main()
