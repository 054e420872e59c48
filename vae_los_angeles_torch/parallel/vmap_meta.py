"""CV fold populations (counterpart of ``fit_folds`` in
``vae_los_angeles_tpu/parallel/vmap_meta.py``).

The reference trains ``folds × directions × families`` full models one after
another (SURVEY §3.4, its wall-clock hot spot). `fit_folds` trains the folds
of one family as one population: every parameter, BatchNorm, optimizer,
plateau and early-stop leaf is stacked on a leading member axis, so each
layer is one batched launch for all members (``ops.nn``: a 3-D batch with
stacked leaves), and the population steps together through one Python loop.

Each member is ``engine.fit``'s plain path at that member's integer seed:
the same init from the seed, the same per-epoch generator
(``engine.epoch_seed(seed_i, e)``), the shuffle, dropout masks and eps drawn
from it in the same order and shapes (one generator a member,
``ops.nn.draw``), the same β schedule, plateau, strict-improvement early
stop and best snapshot, NaN loss rows after its stop. A member that stops
leaves the stacked population at the next epoch's start (where a single run
reads its stop flag and breaks), so it costs nothing more. The products are
batched, so a member's numbers agree with its single run to fp32 order
(the JAX package's population-against-sequential tolerance, rtol 2e-4),
not bit for bit.

The RNA→DNA tasks' loss stays the hand-written loss pair: one forward and
one backward a member a step, each on that member's contiguous
(rows, DNA width) slice (``fused_loss.rna2dna_loss_fused_members``). The
pair is never put under ``torch.func.vmap`` (its autograd Function and its
CUDA entries have no batching rule), so nothing here runs under vmap.

Folds are grouped by their exact (n_train, n_val), the JAX package's
``POP_MASK_SIZES=0`` mode, which gives each member its single run; KFold with
the CV's inner split gives at most a few groups. Its masked-size mode
(``mask_sizes=True``: rows padded to buckets, true sizes as masked
arguments) saves XLA compilations, which an eager port does not pay, and
changes only the members' noise streams: it raises here, and so does
``mesh`` (one card). The optimizer is AdamW (fp32 or bf16 moments; fp32 or
bf16 compute); Adafactor raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.training import engine
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_map


def member_seeds(seed: int, n: int) -> List[int]:
    """The default run seeds of ``n`` members: member i's is
    ``engine.epoch_seed(seed, i)``, the splitmix64 mix of (seed, i)."""
    return [engine.epoch_seed(seed, i) for i in range(n)]


def _check_sizes(n_trs, n_vas, batch_size: int, drop_last: bool):
    """The three host checks of every member (JAX ``_check_masked_sizes``)."""
    for i, (n_tr, n_va) in enumerate(zip(n_trs, n_vas)):
        if (n_tr // batch_size if drop_last else -(-n_tr // batch_size)) == 0:
            raise ValueError(f"member {i}: no training batches (n_train={n_tr}, "
                             f"batch_size={batch_size}, drop_last={drop_last})")
        if not drop_last and n_tr % batch_size == 1:
            raise ValueError(
                f"member {i}: final training batch has a single row (n_train={n_tr} % "
                f"batch_size={batch_size} == 1) — train-mode BatchNorm requires batch size > 1 "
                "(the reference crashes here too)")
        if n_va == 0:
            raise ValueError(f"member {i}: empty validation set")


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def _take(tree, keep):
    """The members ``keep`` (a device index) of a stacked tree; the shared
    0-d leaves (the optimizer's step) as they are."""
    return tree_map(lambda t: t.index_select(0, keep) if t.dim() else t, tree)


def _member(tree, j: int):
    return tree_map(lambda t: t[j] if t.dim() else t, tree)


def fit_folds(task_name: str, cfg: Config, fold_train: Sequence, fold_val: Sequence,
              seed: int, n_sites: int, *, num_epochs: Optional[int] = None,
              drop_last: bool = False, mesh=None, seeds: Optional[Sequence[int]] = None,
              state_overrides: Optional[Dict[str, np.ndarray]] = None,
              mask_sizes: bool = False, device=None) -> List[engine.FitResult]:
    """Train one model a fold, the folds of one (n_train, n_val) as one
    population; returns a list of ``engine.FitResult`` in the input order,
    each with the layout ``engine.fit`` returns.

    ``fold_train``/``fold_val`` hold a (tpm, beta, site) triple of arrays or
    tensors a fold. ``seeds`` (one int a fold) override the default
    `member_seeds(seed, n)`, so a caller can train a fold list with another
    list's noise (the unified CV reuses the standalone sweep's seeds).
    ``state_overrides`` writes name → (n_folds, ...) values into each
    member's state and best snapshot after init (the unified tasks'
    ``kl_on``); an unknown name raises. ``drop_last`` defaults to False, as
    the CV's loaders. Runs on the card unless ``device="cpu"`` or
    ``cfg.platform == "cpu"``."""
    if mask_sizes:
        raise ValueError(
            "mask_sizes=True is not ported: padded rows with masked true sizes save XLA "
            "compilations, which an eager port does not pay, and would only change the "
            "members' noise streams; the port trains exact-shape groups (POP_MASK_SIZES=0)")
    if mesh is not None:
        raise ValueError("mesh-sharded populations are not ported: the port trains on one card")
    if cfg.optimizer != "adamw":
        raise ValueError(f"optimizer={cfg.optimizer!r}: the fold population trains with AdamW")
    if len(fold_train) != len(fold_val):
        raise ValueError(f"{len(fold_train)} training folds for {len(fold_val)} validation folds")
    n_folds = len(fold_train)
    _check_sizes([len(t[0]) for t in fold_train], [len(v[0]) for v in fold_val],
                 int(cfg.batch_size), bool(drop_last))
    seeds = member_seeds(seed, n_folds) if seeds is None else [int(s) for s in seeds]
    if len(seeds) != n_folds:
        raise ValueError(f"seeds has {len(seeds)} entries for {n_folds} folds")
    task = get_task(task_name)
    device = resolve_device(device, cfg)
    num_epochs = cfg.num_epochs if num_epochs is None else int(num_epochs)
    overrides = {name: np.asarray(value) for name, value in (state_overrides or {}).items()}
    for name, value in overrides.items():
        if len(value) != n_folds:
            raise ValueError(f"state_overrides[{name!r}] has {len(value)} rows for {n_folds} "
                             "folds")

    groups: Dict[tuple, list] = {}
    for i, (tr, va) in enumerate(zip(fold_train, fold_val)):
        groups.setdefault((len(tr[0]), len(va[0])), []).append(i)
    results: List[Optional[engine.FitResult]] = [None] * n_folds
    for idxs in groups.values():
        group = _fit_group(task, cfg, [engine._as_batch(fold_train[i], device) for i in idxs],
                           [engine._as_batch(fold_val[i], device) for i in idxs],
                           [seeds[i] for i in idxs], n_sites, num_epochs, bool(drop_last),
                           {name: value[idxs] for name, value in overrides.items()}, device)
        for i, res in zip(idxs, group):
            results[i] = res
    return results


def _fit_group(task, cfg, train, val, seeds, n_sites, num_epochs, drop_last, overrides, device):
    """One population of equal-shape folds (module docstring)."""
    n_members = len(seeds)
    tr = Batch(*(torch.stack(f) for f in zip(*train)))  # (P, n_train, ...)
    va = Batch(*(torch.stack(f) for f in zip(*val)))
    if (tr.tpm.shape[-1], tr.beta.shape[-1]) != (cfg.input_dim_a, cfg.input_dim_b):
        raise ValueError(
            f"data widths {tr.tpm.shape[-1]}/{tr.beta.shape[-1]} differ from the config's "
            f"input_dim_a/input_dim_b {cfg.input_dim_a}/{cfg.input_dim_b}")
    hp = engine.hyperparams(cfg)
    inits = [task.init(torch.Generator().manual_seed(s), cfg, n_sites, device) for s in seeds]
    params, state = _stack([p for p, _ in inits]), _stack([s for _, s in inits])
    for name, value in overrides.items():
        if name not in state:
            raise ValueError(f"state_overrides[{name!r}]: task {task.name!r} has no such state "
                             f"entry (have: {sorted(state)})")
        new = torch.as_tensor(value, dtype=state[name].dtype).to(device)
        if new.shape != state[name].shape:
            raise ValueError(f"state_overrides[{name!r}] has shape {tuple(value.shape)}; "
                             f"the state entry is {tuple(state[name].shape[1:])} a member")
        state[name] = new
    carry = engine.init_carry(params, state, hp["lr"], cfg.moments_dtype, cfg.optimizer,
                              n_members)

    batch_size = int(cfg.batch_size)
    n_train, n_val = tr.tpm.shape[1], va.tpm.shape[1]
    n_batches = n_train // batch_size if drop_last else -(-n_train // batch_size)
    n_val_batches = -(-n_val // batch_size)
    compute_dtype = ops_nn.resolve_compute_dtype(cfg.compute_dtype)
    loss_kw = {"gamma": hp["gamma"], "class_weights": None}
    debug = bool(cfg.debug_nans)
    members = list(range(n_members))  # the input positions still training
    carries: List[Optional[dict]] = [None] * n_members
    history = []  # an epoch: (members, train losses, val losses, lrs, β)
    anomaly = torch.autograd.set_detect_anomaly(True) if debug else contextlib.nullcontext()
    with anomaly:
        for epoch in range(num_epochs):
            # the epoch's one host sync: the stop latches and the plateaus' rates
            stopped, lrs = torch.stack([carry["estop"]["stopped"].to(torch.float32),
                                        carry["plateau"]["lr"]]).tolist()
            keep = [j for j, s in enumerate(stopped) if not s]
            if len(keep) < len(members):  # the stopped leave the population
                for j, s in enumerate(stopped):
                    if s:
                        carries[members[j]] = _member(carry, j)
                keep_t = torch.tensor(keep, dtype=torch.int64, device=device)
                carry = _take(carry, keep_t)
                tr, va = (Batch(*(t.index_select(0, keep_t) for t in b)) for b in (tr, va))
                members, lrs = [members[j] for j in keep], [lrs[j] for j in keep]
            if not members:
                break
            beta = engine.beta_schedule(epoch, hp) if task.uses_kl_warmup else 0.0
            gens, perm = zip(*(engine.epoch_noise(seeds[i], epoch, n_train, device)
                               for i in members))
            gens, perm = list(gens), torch.stack(perm)
            rows = torch.arange(len(members), device=device)[:, None]
            params, state, opt = carry["params"], carry["state"], carry["opt"]
            lr = carry["plateau"]["lr"]
            train_sum = torch.zeros(len(members), device=device)
            for b in range(n_batches):
                idx = perm[:, b * batch_size:(b + 1) * batch_size]
                batch = Batch(*(t[rows, idx] for t in tr))
                loss, grads, state = engine.plain_grads(task, params, state, batch, beta, gens,
                                                        loss_kw, compute_dtype, debug, epoch, b,
                                                        members=True)
                params, opt = optim.adamw_update(params, grads, opt, lr, hp["weight_decay"])
                train_sum = train_sum + loss
            val_loss, carry = engine.end_epoch(task, carry, params, state, opt, va, beta, gens,
                                               hp, loss_kw, compute_dtype, n_val_batches, epoch,
                                               members=True)
            history.append((members, train_sum / n_batches, val_loss, lrs, beta))
    for j, i in enumerate(members):
        carries[i] = _member(carry, j)
    return _results(carries, history, num_epochs)


def _results(carries, history, num_epochs):
    """The members' ``engine.FitResult``s; the loss rows come to the host in
    one copy."""
    rows = {name: np.full((len(carries), num_epochs), np.nan, np.float32)
            for name in ("train", "val", "beta", "lr")}
    ran = np.zeros(len(carries), np.int64)
    if history:
        losses = torch.cat([torch.cat([h[1], h[2]]) for h in history]).cpu().numpy()
        at = 0
        for epoch, (members, _, _, lrs, beta) in enumerate(history):
            n = len(members)
            rows["train"][members, epoch] = losses[at:at + n]
            rows["val"][members, epoch] = losses[at + n:at + 2 * n]
            rows["lr"][members, epoch] = lrs
            rows["beta"][members, epoch] = beta
            ran[members] += 1
            at += 2 * n
    out = []
    for i, carry in enumerate(carries):
        es = carry["estop"]
        best_val, best_epoch, stopped = torch.stack(
            [es["best_val"].double(), es["best_epoch"].double(),
             es["stopped"].double()]).tolist()
        out.append(engine.FitResult(
            params=carry["best"]["params"], state=carry["best"]["state"],
            final_params=carry["params"], final_state=carry["state"],
            best_val_loss=best_val, best_epoch=int(best_epoch),
            stopped=bool(stopped), train_losses=rows["train"][i], val_losses=rows["val"][i],
            betas=rows["beta"][i], lrs=rows["lr"][i], carry=carry,
            epochs_ran=int(ran[i])))
    return out


__all__ = ["fit_folds", "member_seeds"]
