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
(rows, DNA width) slice, its valid rows in a masked short batch
(``fused_loss.rna2dna_loss_fused_members``). The
pair is never put under ``torch.func.vmap`` (its autograd Function and its
CUDA entries have no batching rule), so nothing here runs under vmap.

Masked sizes (``mask_sizes=True``, the default, as in the JAX package:
``POP_MASK_SIZES``, `mask_sizes_enabled`): every fold's tables are padded to
`bucket_rows` of the folds' row maxima and its true sizes ride along
(``engine.fit``'s ``masked_sizes``: the permutation over the padded
maximum with the valid ids first, pad slots masked out of the loss and the
BatchNorm statistics, a member without rows in a trailing batch gated, the
validation masked), so uneven KFold folds train as ONE population a family.
On the card that matters: a population is bound by the host's launches
(PERF.md), and every extra size group costs a whole population epoch of
them. A member is its own masked run (``engine.fit(masked_sizes=True)``)
at the same maxima; at a true size equal to the padded maximum that is its
exact-shape run. ``fit_trials`` pads the shared tables the same way.
``POP_MASK_SIZES=0`` (or ``mask_sizes=False``) groups the folds by their
exact (n_train, n_val), which gives each member its exact-shape single run.

The optimizer is the config's (``engine._optimizer``): AdamW (fp32 or bf16
moments) or Adafactor, whose factoring, clip, rate and decay are each
member's own (``ops.optim``); fp32 or bf16 compute.

Several devices (``mesh``: `population_mesh`, every rank of the process
group calling with the same arguments): the member axis is sharded, as the
JAX package shards it. The members are padded to a multiple of the rank
count by repeating the last one (`_pad_population`), rank r trains its
contiguous slice with the population code above, and the results are
gathered in input order on every rank, the padding dropped. A member's
numbers are those of its slice run alone; in masked mode every rank pads to
the maxima of all the members, so they are also the unsharded
population's.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.training import engine
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy


def member_seeds(seed: int, n: int) -> List[int]:
    """The default run seeds of ``n`` members: member i's is
    ``engine.epoch_seed(seed, i)``, the splitmix64 mix of (seed, i)."""
    return [engine.epoch_seed(seed, i) for i in range(n)]


def mask_sizes_enabled() -> bool:
    """Masked-size populations (``POP_MASK_SIZES``, default on; ``0`` turns
    them off: exact-shape groups), as in the JAX package."""
    return os.getenv("POP_MASK_SIZES", "1") != "0"


def eval_bucket_enabled() -> bool:
    """Row buckets for the masked populations (``EVAL_BUCKET``, default on;
    ``0`` pads to the exact maxima), the JAX package's switch."""
    return os.getenv("EVAL_BUCKET", "1") != "0"


# per-octave mantissas: ratio <= 1.17 between consecutive buckets
_BUCKET_MANTISSAS = (16, 18, 21, 24, 28)


def bucket_rows(n: int, enabled=None) -> int:
    """The smallest ladder value >= n (JAX ``ops/backend.bucket_rows``): the
    ladder is {16, 18, 21, 24, 28}·2^e, consecutive steps within 17%; the
    identity at 32 rows or fewer and with bucketing off."""
    if n <= 32:
        return n
    if not (eval_bucket_enabled() if enabled is None else enabled):
        return n
    octave = 1
    while True:
        for m in _BUCKET_MANTISSAS:
            if m * octave >= n:
                return m * octave
        octave *= 2


# the host checks of every member's true sizes (JAX ``_check_masked_sizes``)
_check_sizes = engine.check_sizes


def _pad_rows(batch: Batch, n_max: int) -> Batch:
    """``batch`` with zero rows appended up to ``n_max`` (site 0, in range):
    a training table's padding is never gathered and a validation table's
    is masked, so what it holds reaches nothing."""
    pad = n_max - len(batch)
    if pad == 0:
        return batch
    return Batch(*(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) for t in batch))


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


def fit_folds(task_name: str, cfg: Config, fold_train: Sequence, fold_val: Sequence,
              seed: int, n_sites: int, *, num_epochs: Optional[int] = None,
              drop_last: bool = False, mesh=None, seeds: Optional[Sequence[int]] = None,
              state_overrides: Optional[Dict[str, np.ndarray]] = None,
              mask_sizes: Optional[bool] = None, device=None) -> List[engine.FitResult]:
    """Train one model a fold; returns a list of ``engine.FitResult`` in the
    input order, each with the layout ``engine.fit`` returns.

    ``fold_train``/``fold_val`` hold a (tpm, beta, site) triple of arrays or
    tensors a fold. ``mask_sizes`` (None: `mask_sizes_enabled`) trains every
    fold as one population, padded to `bucket_rows` of the maxima with its
    true sizes masked; off, the folds of one exact (n_train, n_val) form a
    population (module docstring). ``seeds`` (one int a fold) override the
    default `member_seeds(seed, n)`, so a caller can train a fold list with
    another list's noise (the unified CV reuses the standalone sweep's
    seeds). ``state_overrides`` writes name → (n_folds, ...) values into each
    member's state and best snapshot after init (the unified tasks'
    ``kl_on``); an unknown name raises. ``drop_last`` defaults to False, as
    the CV's loaders. Runs on the card unless ``device="cpu"`` or
    ``cfg.platform == "cpu"``. ``mesh`` shards the folds (module
    docstring)."""
    if len(fold_train) != len(fold_val):
        raise ValueError(f"{len(fold_train)} training folds for {len(fold_val)} validation folds")
    if mask_sizes is None:
        mask_sizes = mask_sizes_enabled()
    n_folds = len(fold_train)
    n_trs, n_vas = [len(t[0]) for t in fold_train], [len(v[0]) for v in fold_val]
    _check_sizes(n_trs, n_vas, int(cfg.batch_size), bool(drop_last))
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
    # the padded maxima of all folds, so that a rank's members train as they would alone
    maxima = (bucket_rows(max(n_trs)), bucket_rows(max(n_vas))) if mask_sizes else None
    idxs = list(range(n_folds))
    if mesh is not None and mesh.size > 1:
        padded, lo, hi = _rank_slice(n_folds, mesh)
        idxs = _pad_population(idxs, padded)[lo:hi]
    local = _fold_groups(task, cfg, [fold_train[i] for i in idxs], [fold_val[i] for i in idxs],
                         [seeds[i] for i in idxs], n_sites, num_epochs, bool(drop_last), device,
                         {name: value[idxs] for name, value in overrides.items()}, maxima)
    if mesh is not None and mesh.size > 1:
        return _gathered(local, n_folds, device)
    return local


def _fold_groups(task, cfg, fold_train, fold_val, seeds, n_sites, num_epochs, drop_last, device,
                 overrides, maxima):
    """`fit_folds` on this device: one masked population padded to
    ``maxima`` (n_train, n_val), or, without them, one population a group
    of exact (n_train, n_val)."""
    folds = [(engine._as_batch(tr, device), engine._as_batch(va, device))
             for tr, va in zip(fold_train, fold_val)]
    groups: Dict[tuple, list] = {}
    for i, (tr, va) in enumerate(folds):
        groups.setdefault(maxima or (len(tr), len(va)), []).append(i)
    results: List[Optional[engine.FitResult]] = [None] * len(folds)
    for idxs in groups.values():
        if maxima is None:
            tr, va = (Batch(*(torch.stack(f) for f in zip(*(folds[i][k] for i in idxs))))
                      for k in (0, 1))  # (P, rows, ...)
            sizes = None
        else:
            tr, va = (Batch(*(torch.stack(f) for f in zip(*(_pad_rows(folds[i][k], n_max)
                                                             for i in idxs))))
                      for k, n_max in enumerate(maxima))
            sizes = ([len(folds[i][0]) for i in idxs], [len(folds[i][1]) for i in idxs])
        group = _fit_group(task, cfg, tr, va, [seeds[i] for i in idxs], n_sites, num_epochs,
                           drop_last, device, sizes=sizes,
                           overrides={name: value[idxs] for name, value in overrides.items()})
        for i, res in zip(idxs, group):
            results[i] = res
    return results


def fit_trials(task_name: str, cfg: Config, train, val, seed: int, n_sites: int,
               hp_population: Dict[str, np.ndarray], *, num_epochs: Optional[int] = None,
               class_weights=None, carry0=None, start_epoch: int = 0,
               seeds: Optional[Sequence[int]] = None, mask_sizes: Optional[bool] = None,
               mesh=None, device=None) -> List[engine.FitResult]:
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
    raises. ``mask_sizes`` (None: `mask_sizes_enabled`) pads the shared
    tables to `bucket_rows` of their sizes and trains the true sizes
    (module docstring). Runs on the card unless ``device="cpu"`` or
    ``cfg.platform == "cpu"``. ``mesh`` shards the trials (module
    docstring)."""
    if mask_sizes is None:
        mask_sizes = mask_sizes_enabled()
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
                           start_epoch=start_epoch, seeds=pick(seeds), mask_sizes=mask_sizes,
                           device=device)
        return _gathered(local, n_trials, device)
    task = get_task(task_name)
    num_epochs = cfg.num_epochs if num_epochs is None else int(num_epochs)
    tr, va = engine._as_batch(train, device), engine._as_batch(val, device)
    _check_sizes([len(tr)], [len(va)], int(cfg.batch_size), True)
    sizes = None
    if mask_sizes:
        sizes = ([len(tr)] * n_trials, [len(va)] * n_trials)
        tr, va = _pad_rows(tr, bucket_rows(len(tr))), _pad_rows(va, bucket_rows(len(va)))
    if carry0 is not None:
        carry0 = (_stack_carry(carry0, device) if isinstance(carry0, (list, tuple))
                  else tree_from_numpy(carry0, device))
        if carry0["estop"]["stopped"].shape != (n_trials,):
            raise ValueError(f"carry0 holds {carry0['estop']['stopped'].shape[0]} members for "
                             f"{n_trials} trials")
    if class_weights is not None:
        class_weights = torch.as_tensor(np.asarray(class_weights, np.float32)).to(device)
    return _fit_group(task, cfg, tr, va, seeds, n_sites, num_epochs, True, device,
                      hp=engine.hyperparams(cfg, **hp_population), sizes=sizes,
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
               class_weights=None, overrides=None, carry0=None, start_epoch=0, sizes=None):
    """One population (module docstring). ``tr``/``va`` are stacked
    (P, rows, ...) tables, one a member, or shared (rows, ...) ones; ``hp``
    may hold one value a member (`engine.hyperparams`). ``sizes`` (one list
    of true train sizes and one of validation sizes, a member each) trains
    the tables as padded maxima (``engine.fit``'s ``masked_sizes``)."""
    n_members = len(seeds)
    shared = tr.tpm.dim() == 2
    if (tr.tpm.shape[-1], tr.beta.shape[-1]) != (cfg.input_dim_a, cfg.input_dim_b):
        raise ValueError(
            f"data widths {tr.tpm.shape[-1]}/{tr.beta.shape[-1]} differ from the config's "
            f"input_dim_a/input_dim_b {cfg.input_dim_a}/{cfg.input_dim_b}")
    hp = engine.hyperparams(cfg) if hp is None else hp
    batch_size = int(cfg.batch_size)
    n_train, n_val = tr.tpm.shape[-2], va.tpm.shape[-2]

    def plan(members):
        """The masked grid and validation of the members ``members``."""
        if sizes is None:
            return None, None, -(-n_val // batch_size)
        grid = engine.masked_grid([sizes[0][i] for i in members], n_train, batch_size,
                                  drop_last, device)
        return (grid, *engine.masked_validation([sizes[1][i] for i in members], n_val,
                                                batch_size, device))

    members = list(range(n_members))  # the input positions still training
    grid, val_mask, n_val_batches = plan(members)
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
    step = carry["opt"]["step"]
    if grid is not None and step.dim() == 0 and any(gb.active is not None for gb in grid.batches):
        # members that step apart count their own optimizer steps
        carry["opt"] = {**carry["opt"], "step": step.expand(n_members).clone()}

    n_batches = n_train // batch_size if drop_last else -(-n_train // batch_size)
    _, opt_update = engine._optimizer(cfg.optimizer)
    compute_dtype = ops_nn.resolve_compute_dtype(cfg.compute_dtype)
    debug = bool(cfg.debug_nans)
    spare = torch.Generator(device=device).manual_seed(0)  # an inactive member's draws
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
                if members:
                    grid, val_mask, n_val_batches = plan(members)
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
            if grid is None:
                steps = [(perm[:, b * batch_size:(b + 1) * batch_size], None, None)
                         for b in range(n_batches)]
            else:
                perm = grid.permute(perm)
                steps = [(grid.rows(perm, gb), gb.mask, gb.active) for gb in grid.batches]
            for b, (idx, row_mask, active) in enumerate(steps):
                batch = Batch(*(t[idx] if shared else t[rows, idx] for t in tr))
                batch_gens = gens if active is None else [
                    g if n else spare for g, n in zip(gens, row_mask.counts)]
                loss, grads, new_state = engine.plain_grads(
                    task, params, state, batch, beta_kl, batch_gens, loss_kw, compute_dtype,
                    debug, epoch, b, members=True, row_mask=row_mask)
                new_params, new_opt = opt_update(params, grads, opt, lr, weight_decay)
                if active is None:
                    params, state, opt = new_params, new_state, new_opt
                else:  # a member without rows here keeps its state
                    params, state, opt = (engine.gate(active, n, o) for n, o in (
                        (new_params, params), (new_state, state), (new_opt, opt)))
                train_sum = train_sum + loss
            val_loss, carry = engine.end_epoch(task, carry, params, state, opt, val, beta_kl,
                                               gens, hp, loss_kw, compute_dtype, n_val_batches,
                                               epoch, members=True, row_mask=val_mask)
            divisor = n_batches if grid is None else grid.n_batches
            history.append((members, train_sum / divisor, val_loss, lrs, beta))
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


__all__ = ["bucket_rows", "fit_folds", "fit_trials", "mask_sizes_enabled", "member_seeds",
           "population_mesh"]
