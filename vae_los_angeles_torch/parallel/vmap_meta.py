"""CV fold and HPO trial populations (counterpart of ``fit_folds`` and
``fit_trials`` in ``vae_los_angeles_tpu/parallel/vmap_meta.py``).

The reference trains ``folds × directions × families`` full models one after
another (SURVEY §3.4, its wall-clock hot spot), and its HPO one trial after
another. `fit_folds` trains the folds of one family, and `fit_trials` the
hyperparameter trials of one model shape on one shared split, each as one
population through one epoch loop (`_fit_group`): every parameter,
BatchNorm, optimizer, plateau and early-stop leaf is stacked on a leading
member axis, so each layer is one batched launch for all members
(``ops.nn``: a 3-D batch with stacked leaves), and the population steps
together through one Python loop.

Each member is ``engine.fit``'s plain path at that member's integer seed:
the same init from the seed, the same per-epoch generator
(``engine.epoch_seed(seed_i, e)``), the shuffle, dropout masks and eps drawn
from it in the same order and shapes (one generator a member,
``ops.nn.draw``), the same β schedule, plateau, strict-improvement early
stop and best snapshot, NaN loss rows after its stop. A trial's lr, weight
decay, β and γ may be its own (one value a member: AdamW's rate and decay,
the loss's β and γ); the trials' shared tables are gathered by each
member's own permutation, not copied a member. A member that stops
leaves the stacked population at the next epoch's start (where a single run
reads its stop flag and breaks), so it costs nothing more. The products are
batched, so a member's numbers agree with its single run to fp32 order,
not bit for bit; a population of one is its single run bit for bit. The
encoder biases feeding train-mode BatchNorm have a true gradient of 0, so
Adam turns that order's noise in their gradients into ±lr steps: on the
card a member's losses part from its single run's by an amount that grows
with its rate (PERF.md).

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
changes only the members' noise streams: it raises here. The optimizer
is AdamW (fp32 or bf16 moments; fp32 or bf16 compute); Adafactor raises.

Several devices (``mesh``: `population_mesh`, every rank of the process
group calling with the same arguments): the member axis is sharded, as the
JAX package shards it. The members are padded to a multiple of the rank
count by repeating the last one (`_pad_population`), rank r trains its
contiguous slice with the population code above, and the results are
gathered in input order on every rank, the padding dropped. A member's
numbers are those of its slice run alone.
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
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.training import engine
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy


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


def population_mesh():
    """A 1-axis ("data",) mesh over every rank of the process group, or None
    when there are fewer than two."""
    if comm.world() < 2:
        return None
    from vae_los_angeles_torch.parallel.sharding import make_mesh

    return make_mesh()


def _pad_population(items: list, target: int) -> list:
    """``items`` (one entry a member) padded to ``target`` by repeating the
    last member; the padding trains in the same slot and is dropped."""
    return list(items) + [items[-1]] * (target - len(items))


def _rank_slice(n: int, mesh):
    """(padded size, this rank's [lo, hi) of the padded member axis)."""
    per = -(-n // mesh.size)
    r = comm.rank()
    return per * mesh.size, r * per, (r + 1) * per


def _moved(res: engine.FitResult, device) -> engine.FitResult:
    return res._replace(**{k: tree_map(lambda t: t.detach().to(device), getattr(res, k))
                           for k in ("params", "state", "final_params", "final_state", "carry")})


def _gathered(local: list, n: int, device):
    """Every rank's results, in member order, the padding dropped, on
    ``device``."""
    parts = comm.gather_objects([_moved(res, "cpu") for res in local])
    return [_moved(res, device) for part in parts for res in part][:n]


def _refuse(cfg, mask_sizes):
    """The options a population of the port does not train."""
    if mask_sizes:
        raise ValueError(
            "mask_sizes=True is not ported: padded rows with masked true sizes save XLA "
            "compilations, which an eager port does not pay, and would only change the "
            "members' noise streams; the port trains exact-shape groups (POP_MASK_SIZES=0)")
    if cfg.optimizer != "adamw":
        raise ValueError(f"optimizer={cfg.optimizer!r}: a population trains with AdamW")


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
    ``cfg.platform == "cpu"``. ``mesh`` shards the folds (module
    docstring)."""
    _refuse(cfg, mask_sizes)
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
    if mesh is not None and mesh.size > 1:
        padded, lo, hi = _rank_slice(n_folds, mesh)
        pick = lambda items: _pad_population(list(items), padded)[lo:hi]  # noqa: E731
        local = fit_folds(task_name, cfg, pick(fold_train), pick(fold_val), seed, n_sites,
                          num_epochs=num_epochs, drop_last=drop_last, seeds=pick(seeds),
                          state_overrides={k: np.stack(pick(v)) for k, v in overrides.items()},
                          device=device)
        return _gathered(local, n_folds, device)

    groups: Dict[tuple, list] = {}
    for i, (tr, va) in enumerate(zip(fold_train, fold_val)):
        groups.setdefault((len(tr[0]), len(va[0])), []).append(i)
    results: List[Optional[engine.FitResult]] = [None] * n_folds
    for idxs in groups.values():
        tr, va = (Batch(*(torch.stack(f) for f in zip(*(engine._as_batch(folds[i], device)
                                                        for i in idxs))))
                  for folds in (fold_train, fold_val))  # (P, rows, ...)
        group = _fit_group(task, cfg, tr, va, [seeds[i] for i in idxs], n_sites, num_epochs,
                           bool(drop_last), device,
                           overrides={name: value[idxs] for name, value in overrides.items()})
        for i, res in zip(idxs, group):
            results[i] = res
    return results


def fit_trials(task_name: str, cfg: Config, train, val, seed: int, n_sites: int,
               hp_population: Dict[str, np.ndarray], *, num_epochs: Optional[int] = None,
               class_weights=None, carry0=None, start_epoch: int = 0,
               seeds: Optional[Sequence[int]] = None, mask_sizes: bool = False, mesh=None,
               device=None) -> List[engine.FitResult]:
    """Train a population of hyperparameter trials of one model shape on
    one shared (train, val) split (JAX ``vmap_meta.fit_trials``); returns a
    list of ``engine.FitResult``, one a trial.

    ``hp_population`` maps any of ``engine.POPULATION_KEYS`` (lr,
    weight_decay, beta_start, gamma) to (n_trials,) values, kept as fp32;
    the other hyperparameters are ``cfg``'s for every trial. Each trial is
    ``engine.fit``'s plain path at its seed with its hyperparameters
    (``drop_last=True``, as the JAX package trains trials): its own shuffle
    and noise from its own generator, the shared tables gathered by its own
    permutation. ``class_weights`` (n_sites,) are shared. ``seeds`` (one int
    a trial) default to `member_seeds(seed, n_trials)`.

    ``carry0``/``start_epoch`` continue a population mid-run: a stacked
    population carry (``evaluation.hpo._padded_carry``) or a list of member
    carries (``FitResult.carry`` of the trials that go on; their optimizer
    step, shared by the population, must agree) and the absolute epoch it
    stopped at. β, the plateau, early stopping and the best snapshot resume
    exactly, and a trial's noise of epoch e comes from (its seed, e), so a
    survivor continued with its own seed trains as the uninterrupted run.
    Continuing needs explicit ``seeds`` (the default depends on the number of
    trials, so a sliced population would switch streams): without them it
    raises. ``mask_sizes=True`` and ``mesh`` raise. Runs on the card unless
    ``device="cpu"`` or ``cfg.platform == "cpu"``. ``mesh`` shards the
    trials (module docstring)."""
    _refuse(cfg, mask_sizes)
    unknown = sorted(set(hp_population) - set(engine.POPULATION_KEYS))
    if unknown:
        raise ValueError(f"hp_population keys {unknown}: a trial population sets "
                         f"{engine.POPULATION_KEYS}")
    sizes = {len(v) for v in hp_population.values()}
    if len(sizes) != 1:
        raise ValueError(f"hp_population needs one (n_trials,) array a key, got lengths "
                         f"{sorted(sizes)}")
    n_trials = sizes.pop()
    if seeds is None:
        if carry0 is not None or start_epoch:
            raise ValueError(
                "continuing a population (carry0/start_epoch) requires explicit per-trial "
                "`seeds`: pass the seeds of the original run for the trials that go on")
        seeds = member_seeds(seed, n_trials)
    seeds = [int(s) for s in seeds]
    if len(seeds) != n_trials:
        raise ValueError(f"seeds has {len(seeds)} entries for {n_trials} trials")
    device = resolve_device(device, cfg)
    if mesh is not None and mesh.size > 1:
        padded, lo, hi = _rank_slice(n_trials, mesh)
        pick = lambda items: _pad_population(list(items), padded)[lo:hi]  # noqa: E731
        if carry0 is not None and not isinstance(carry0, (list, tuple)):
            stacked = tree_from_numpy(carry0, device)
            carry0 = [_member(stacked, j) for j in range(n_trials)]
        local = fit_trials(task_name, cfg, train, val, seed, n_sites,
                           {k: np.asarray(pick(np.asarray(v))) for k, v in hp_population.items()},
                           num_epochs=num_epochs, class_weights=class_weights,
                           carry0=None if carry0 is None else pick(carry0),
                           start_epoch=start_epoch, seeds=pick(seeds), device=device)
        return _gathered(local, n_trials, device)
    task = get_task(task_name)
    num_epochs = cfg.num_epochs if num_epochs is None else int(num_epochs)
    tr, va = engine._as_batch(train, device), engine._as_batch(val, device)
    _check_sizes([len(tr)], [len(va)], int(cfg.batch_size), True)
    if carry0 is not None:
        carry0 = (_stack_carry(carry0, device) if isinstance(carry0, (list, tuple))
                  else tree_from_numpy(carry0, device))
        if carry0["estop"]["stopped"].shape != (n_trials,):
            raise ValueError(f"carry0 holds {carry0['estop']['stopped'].shape[0]} members for "
                             f"{n_trials} trials")
    if class_weights is not None:
        class_weights = torch.as_tensor(np.asarray(class_weights, np.float32)).to(device)
    return _fit_group(task, cfg, tr, va, seeds, n_sites, num_epochs, True, device,
                      hp=engine.hyperparams(cfg, **hp_population),
                      class_weights=class_weights, carry0=carry0, start_epoch=start_epoch)


def _stack_carry(carries, device):
    """One population carry of member carries: every leaf stacked, but the
    optimizer's step, which the population shares, kept 0-d."""
    carries = [tree_from_numpy(c, device) for c in carries]
    steps = {int(c["opt"]["step"]) for c in carries}
    if len(steps) != 1:
        raise ValueError(f"the member carries are at different optimizer steps {sorted(steps)}")
    carry = _stack(carries)
    carry["opt"]["step"] = carries[0]["opt"]["step"]
    return carry


def _fit_group(task, cfg, tr, va, seeds, n_sites, num_epochs, drop_last, device, *, hp=None,
               class_weights=None, overrides=None, carry0=None, start_epoch=0):
    """One population (module docstring). ``tr``/``va`` are stacked
    (P, rows, ...) tables, one a member, or shared (rows, ...) ones; ``hp``
    may hold one value a member (`engine.hyperparams`)."""
    n_members = len(seeds)
    shared = tr.tpm.dim() == 2
    if (tr.tpm.shape[-1], tr.beta.shape[-1]) != (cfg.input_dim_a, cfg.input_dim_b):
        raise ValueError(
            f"data widths {tr.tpm.shape[-1]}/{tr.beta.shape[-1]} differ from the config's "
            f"input_dim_a/input_dim_b {cfg.input_dim_a}/{cfg.input_dim_b}")
    hp = engine.hyperparams(cfg) if hp is None else hp
    if carry0 is None:
        inits = [task.init(torch.Generator().manual_seed(s), cfg, n_sites, device)
                 for s in seeds]
        params, state = _stack([p for p, _ in inits]), _stack([s for _, s in inits])
        for name, value in (overrides or {}).items():
            if name not in state:
                raise ValueError(f"state_overrides[{name!r}]: task {task.name!r} has no such "
                                 f"state entry (have: {sorted(state)})")
            new = torch.as_tensor(value, dtype=state[name].dtype).to(device)
            if new.shape != state[name].shape:
                raise ValueError(f"state_overrides[{name!r}] has shape {tuple(value.shape)}; "
                                 f"the state entry is {tuple(state[name].shape[1:])} a member")
            state[name] = new
        carry = engine.init_carry(params, state, hp["lr"], cfg.moments_dtype, cfg.optimizer,
                                  n_members)
    else:
        carry = carry0

    batch_size = int(cfg.batch_size)
    n_train, n_val = tr.tpm.shape[-2], va.tpm.shape[-2]
    n_batches = n_train // batch_size if drop_last else -(-n_train // batch_size)
    n_val_batches = -(-n_val // batch_size)
    compute_dtype = ops_nn.resolve_compute_dtype(cfg.compute_dtype)
    debug = bool(cfg.debug_nans)
    members = list(range(n_members))  # the input positions still training
    carries: List[Optional[dict]] = [None] * n_members
    history = []  # an epoch: (members, train losses, val losses, lrs, β)
    anomaly = torch.autograd.set_detect_anomaly(True) if debug else contextlib.nullcontext()
    with anomaly:
        for epoch in range(start_epoch, start_epoch + num_epochs):
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
                if not shared:
                    tr, va = (Batch(*(t.index_select(0, keep_t) for t in b)) for b in (tr, va))
                members, lrs = [members[j] for j in keep], [lrs[j] for j in keep]
            if not members:
                break
            # the live members' hyperparameters: a scalar as it is, one value a member
            # as a tensor on the device
            live = {k: np.asarray(v)[members] if np.ndim(v) else v for k, v in hp.items()}
            beta = engine.beta_schedule(epoch, live) if task.uses_kl_warmup else 0.0
            beta_kl, gamma, weight_decay = (torch.as_tensor(v).to(device) if np.ndim(v) else v
                                            for v in (beta, live["gamma"],
                                                      live["weight_decay"]))
            loss_kw = {"gamma": gamma, "class_weights": class_weights}
            gens, perm = zip(*(engine.epoch_noise(seeds[i], epoch, n_train, device)
                               for i in members))
            gens, perm = list(gens), torch.stack(perm)
            rows = torch.arange(len(members), device=device)[:, None]
            val = (Batch(*(t.expand(len(members), *t.shape) for t in va)) if shared else va)
            params, state, opt = carry["params"], carry["state"], carry["opt"]
            lr = carry["plateau"]["lr"]
            train_sum = torch.zeros(len(members), device=device)
            for b in range(n_batches):
                idx = perm[:, b * batch_size:(b + 1) * batch_size]
                batch = Batch(*(t[idx] if shared else t[rows, idx] for t in tr))
                loss, grads, state = engine.plain_grads(task, params, state, batch, beta_kl,
                                                        gens, loss_kw, compute_dtype, debug,
                                                        epoch, b, members=True)
                params, opt = optim.adamw_update(params, grads, opt, lr, weight_decay)
                train_sum = train_sum + loss
            val_loss, carry = engine.end_epoch(task, carry, params, state, opt, val, beta_kl,
                                               gens, hp, loss_kw, compute_dtype, n_val_batches,
                                               epoch, members=True)
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


__all__ = ["fit_folds", "fit_trials", "member_seeds", "population_mesh"]
