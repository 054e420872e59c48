"""Training engine (counterpart of ``vae_los_angeles_tpu/training/engine.py``):
a whole single run with the reference recipe, driven from the host one
epoch at a time while the state stays on the device.

Semantics carried over from the JAX engine:
  * β = min(1, epoch/warmup)·beta_start with 0-based global epochs, warmup
    0 meaning full β from the start;
  * a shuffled epoch with ``drop_last`` (the remainder is a last, short
    batch without it);
  * train loss = Σ(batch sum-losses)/n_batches; validation = the full set's
    sum loss in eval mode / ceil(n_val/B);
  * ReduceLROnPlateau steps on the validation loss after the epoch, and its
    rate applies from the next epoch; early stopping on strict improvement,
    with the best (params, state) snapshot carried on the device and
    returned (``FitResult.params``);
  * epochs after the stop cost nothing: the loop reads the stop flag (and the
    plateau's rate) once per epoch, its only host sync, and breaks; their
    loss rows stay NaN.

Three paths compute an epoch:
  * plain: autograd over the task's loss, then ``ops.optim.adamw_update``;
  * ``fused_step=True``: the train-step kernel each step
    (``ops.kernels.fused_train``), then ``adamw_update``;
  * ``fused_epoch=True``: the epoch kernel once per epoch
    (``ops.kernels.fused_epoch``), every step and its AdamW inside.

Noise comes from the run's ``seed``: epoch e shuffles with a generator seeded
from (seed, e), the plain path draws its dropout and eps from the same
generator, and the kernels draw Philox noise keyed by the same (seed, e)
value with the step index. So a fused_step and a fused_epoch run of one seed
see the same noise. The threefry streams of the JAX engine cannot be
matched: runs agree with it statistically, not bit for bit.

Not ported, raising as the JAX engine does where it has no kernel:
``masked_sizes``, ``mesh``, ``compute_dtype=bfloat16``, bf16 moments and
Adafactor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy


class FitResult(NamedTuple):
    params: dict  # best-validation snapshot (rolled back, like the reference)
    state: dict  # BatchNorm state at the best snapshot
    final_params: dict
    final_state: dict
    best_val_loss: float
    best_epoch: int
    stopped: bool
    train_losses: np.ndarray  # (num_epochs,), NaN after early stop
    val_losses: np.ndarray
    betas: np.ndarray
    lrs: np.ndarray  # learning rate applied in each epoch (post-plateau)
    carry: dict  # full final training state: pass back as ``resume_carry``
    epochs_ran: int


def init_carry(params0, state0, lr, moments_dtype: str = "float32", optimizer: str = "adamw"):
    """Fresh training carry for a model, on the parameters' device."""
    if optimizer != "adamw":
        raise ValueError(f"optimizer={optimizer!r}: the port trains with AdamW only")
    device = tree_leaves(params0)[0].device
    return {
        "params": params0,
        "state": state0,
        "opt": optim.adamw_init(params0, moments_dtype),
        "plateau": optim.plateau_init(lr, device),
        "estop": optim.early_stop_init(device),
        "best": {"params": params0, "state": state0},
    }


def hyperparams(cfg: Config, **overrides):
    """Hyperparameter bundle; an unknown override name raises."""
    hp = {
        "lr": float(cfg.learning_rate),
        "weight_decay": float(cfg.weight_decay),
        "beta_start": float(cfg.beta_start),
        "warmup_epochs": float(cfg.beta_warmup_epochs),
        "gamma": float(cfg.gamma),
        "patience": int(cfg.patience),
        "sched_factor": float(cfg.lr_scheduler_factor),
        "sched_patience": int(cfg.lr_scheduler_patience),
    }
    for k, v in overrides.items():
        if k not in hp:
            raise ValueError(f"unknown hyperparameter override {k!r}; valid: {sorted(hp)}")
        hp[k] = type(hp[k])(v)
    return hp


def beta_schedule(epoch: int, hp) -> float:
    """β of a 0-based global epoch, in float32 as the JAX engine computes it."""
    warm = np.float32(hp["warmup_epochs"])
    frac = np.float32(epoch) / max(warm, np.float32(1.0)) if warm > 0 else np.float32(1.0)
    return float(np.minimum(np.float32(1.0), np.float32(frac)) * np.float32(hp["beta_start"]))


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of epoch ``epoch`` of a run (splitmix64 of the pair), < 2**63."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(epoch) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def _as_batch(arrays, device) -> Batch:
    tpm, beta, site = arrays
    to = lambda a, dt: (a.to(device=device, dtype=dt) if isinstance(a, torch.Tensor)  # noqa: E731
                        else torch.as_tensor(np.asarray(a), dtype=dt).to(device)).contiguous()
    return Batch(to(tpm, torch.float32), to(beta, torch.float32), to(site, torch.int64))


def _check_supported(cfg, fused_step, fused_epoch, masked_sizes, mesh):
    if masked_sizes:
        raise ValueError("masked_sizes is not ported: the port trains exact-shape runs")
    if mesh is not None:
        raise ValueError("mesh-sharded fit is not ported: the port trains on one card")
    if cfg.compute_dtype not in ("float32", "fp32"):
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the port trains fp32 only")
    if cfg.moments_dtype not in ("float32", "fp32"):
        raise ValueError(f"moments_dtype={cfg.moments_dtype!r}: the port keeps fp32 moments")
    if cfg.optimizer != "adamw":
        raise ValueError(f"optimizer={cfg.optimizer!r}: the port trains with AdamW only")
    if fused_step and fused_epoch:
        raise ValueError("choose one of fused_step and fused_epoch")


def fit(task_name: str, cfg: Config, train_arrays, val_arrays, seed: int, n_sites: int, *,
        num_epochs: Optional[int] = None, drop_last: bool = True, hp=None, init_params=None,
        init_state=None, resume_carry=None, start_epoch: int = 0, fused_step: bool = False,
        fused_epoch: bool = False, device=None, masked_sizes: bool = False,
        mesh=None) -> FitResult:
    """Train a task end to end; returns the best-validation snapshot.

    ``train_arrays``/``val_arrays`` are (tpm, beta, site) arrays or tensors;
    ``seed`` seeds the initialisation (when neither ``init_params`` nor
    ``resume_carry`` is given), the shuffles and the noise. Runs on the card
    unless ``device="cpu"`` or ``cfg.platform == "cpu"``."""
    _check_supported(cfg, fused_step, fused_epoch, masked_sizes, mesh)
    task = get_task(task_name)
    device = resolve_device(device, cfg)
    if num_epochs is None:  # an explicit 0 means "no training epochs"
        num_epochs = cfg.num_epochs
    hp = hyperparams(cfg) if hp is None else hp
    train, val = _as_batch(train_arrays, device), _as_batch(val_arrays, device)
    batch_size = int(cfg.batch_size)
    n_train, n_val = len(train), len(val)
    n_full = n_train // batch_size
    remainder = 0 if drop_last else n_train % batch_size
    n_batches = n_full + (1 if remainder else 0)
    if n_batches == 0:
        raise ValueError(
            f"no training batches: n_train={n_train} < batch_size={batch_size} with "
            "drop_last=True — lower batch_size or pass drop_last=False")
    if n_val == 0:
        raise ValueError("empty validation set: n_val=0")
    if (fused_step or fused_epoch) and remainder:
        raise ValueError(
            f"the fused kernels need full batches: n_train={n_train} is not divisible by "
            f"batch_size={batch_size} — use drop_last=True or the plain path")
    n_val_batches = -(-n_val // batch_size)
    if (train.tpm.shape[1], train.beta.shape[1]) != (cfg.input_dim_a, cfg.input_dim_b):
        raise ValueError(
            f"data widths {train.tpm.shape[1]}/{train.beta.shape[1]} differ from the config's "
            f"input_dim_a/input_dim_b {cfg.input_dim_a}/{cfg.input_dim_b}")

    if resume_carry is not None:
        carry = tree_from_numpy(resume_carry, device)
    else:
        if init_params is None:
            init_params, init_state = task.init(torch.Generator().manual_seed(int(seed)), cfg,
                                                n_sites, device)
        elif init_state is None:
            raise ValueError("init_params was given without init_state — pass both halves "
                             "of the task.init(...) result")
        else:
            init_params = tree_from_numpy(init_params, device)
            init_state = tree_from_numpy(init_state, device)
        carry = init_carry(init_params, init_state, hp["lr"], cfg.moments_dtype, cfg.optimizer)
    step_host = int(carry["opt"]["step"])  # one read at the start of the run

    rows = {"train": [], "val": [], "beta": [], "lr": []}
    epochs_ran = 0
    for epoch in range(start_epoch, start_epoch + num_epochs):
        # the epoch's one host sync: the stop latch and the plateau's rate
        stopped, lr = torch.stack([carry["estop"]["stopped"].to(torch.float32),
                                   carry["plateau"]["lr"]]).tolist()
        if stopped:
            break
        beta = beta_schedule(epoch, hp) if task.uses_kl_warmup else 0.0
        eseed = epoch_seed(seed, epoch)
        gen = torch.Generator(device=device).manual_seed(eseed)
        perm = torch.randperm(n_train, generator=gen, device=device)
        params, state, opt = carry["params"], carry["state"], carry["opt"]
        if fused_epoch:
            ep = train.take(perm[: n_full * batch_size])
            losses, params, m, v, state = fe.rna2dna_fused_epoch(
                params, opt["m"], opt["v"], state, ep.tpm, ep.beta, ep.site, n_sites,
                seed=eseed, beta=beta, lr=lr, weight_decay=hp["weight_decay"], step0=step_host,
                n_batches=n_full)
            opt = {"step": opt["step"] + n_full, "m": m, "v": v}
            train_sum = losses.sum()
        else:
            train_sum = torch.zeros((), device=device)
            for b in range(n_batches):
                batch = train.take(perm[b * batch_size:(b + 1) * batch_size])
                if fused_step:
                    loss, grads, state = ft.rna2dna_fused_train_step(
                        params, state, batch.tpm, batch.beta, batch.site, n_sites, seed=eseed,
                        step=b, beta=beta)
                else:
                    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
                    loss, state = task.loss(leaves, state, batch, beta, True, gen)
                    flat = tree_leaves(leaves)
                    grads_flat = iter(torch.autograd.grad(loss, flat))
                    grads = tree_map(lambda _: next(grads_flat), leaves)
                    loss, state = loss.detach(), tree_map(torch.Tensor.detach, state)
                params, opt = optim.adamw_update(params, grads, opt, lr, hp["weight_decay"])
                train_sum = train_sum + loss
        step_host += n_batches
        train_loss = train_sum / n_batches

        with torch.no_grad():
            val_sum, _ = task.loss(params, state, val, beta, False, gen)
        val_loss = val_sum / n_val_batches
        plateau = optim.plateau_step(carry["plateau"], val_loss, hp["sched_factor"],
                                     hp["sched_patience"])
        estop, snap = optim.early_stop_step(carry["estop"], val_loss, epoch, hp["patience"])
        best = tree_map(lambda b_, c_: torch.where(snap, c_, b_), carry["best"],
                        {"params": params, "state": state})
        carry = {"params": params, "state": state, "opt": opt, "plateau": plateau,
                 "estop": estop, "best": best}
        rows["train"].append(train_loss)
        rows["val"].append(val_loss)
        rows["beta"].append(beta)
        rows["lr"].append(lr)
        epochs_ran += 1

    def padded(values):
        out = np.full(num_epochs, np.nan, np.float32)
        if values:
            out[: len(values)] = (torch.stack(values).cpu().numpy()
                                  if isinstance(values[0], torch.Tensor)
                                  else np.asarray(values, np.float32))
        return out

    es = carry["estop"]
    return FitResult(
        params=carry["best"]["params"], state=carry["best"]["state"],
        final_params=carry["params"], final_state=carry["state"],
        best_val_loss=float(es["best_val"]), best_epoch=int(es["best_epoch"]),
        stopped=bool(es["stopped"]),
        train_losses=padded(rows["train"]), val_losses=padded(rows["val"]),
        betas=padded(rows["beta"]), lrs=padded(rows["lr"]), carry=carry, epochs_ran=epochs_ran,
    )


def samples_trained(n_train: int, batch_size: int, epochs: int, drop_last: bool = True) -> int:
    """Rows a run of ``epochs`` epochs trains on (drop_last discards the rest)."""
    per_epoch = (n_train // batch_size) * batch_size if drop_last else n_train
    return per_epoch * epochs


__all__ = ["FitResult", "beta_schedule", "epoch_seed", "fit", "hyperparams", "init_carry",
           "samples_trained"]
