"""MLP classifiers of the downstream site classification (counterpart of
``vae_los_angeles_tpu/evaluation/mlp_classifier.py``).

Two architectures from the reference:
  * "deep" (``downstream_task.py:54-71``): Linear(in, 256) → LayerNorm →
    ReLU → Dropout(0.3) → Linear(256, 128) → LayerNorm → ReLU →
    Dropout(0.2) → Linear(128, n). Adam(lr 1e-3, weight decay 1e-4, the
    coupled L2 form), the plateau schedule on the validation loss, early
    stopping on strict improvement of the validation accuracy (patience 10,
    at most 100 epochs) with a rollback to the best snapshot.
  * "shallow" (``downstream_task_directional.py:151-162``): Linear(in, 128)
    → ReLU → Dropout(0.2) → Linear(128, n). Adam(lr 1e-3), a fixed 20
    epochs, no stop.

The fit follows the JAX package's ``_make_fold_fit``: each epoch draws a
permutation of the member's training rows; ceil(n_train / 32) Adam steps an
epoch, the last batch filled cyclically with rows of weight 0 (torch's
``drop_last=False``); the loss is the class-weighted cross-entropy
Σ w·nll / max(Σ w, 1e-12); after each epoch the validation loss drives the
plateau (factor 0.5, patience 5) and the validation accuracy is
100·correct / n_val. ``val_accs`` is NaN after a member stops. A member's
draws come from its own generator a epoch
(``engine.epoch_seed(seed, epoch)``): the permutation, then one uniform
block a dropout layer for all its batches; its init from a CPU generator
seeded by ``seed``, as ``nn.Linear`` draws (weight, then bias).

`fit_classifier_folds` trains folds (or scenario × fold members) as one
population: every leaf stacked on a leading member axis (``ops.nn``: one
batched product a layer for all members), one generator a member. Uneven
fold sizes stay in one population, under the JAX package's masked-batch
rule: rows padded to the largest fold, a member whose batch b does not
exist leaves its parameters and Adam state (its own step count) untouched
there, and padded validation rows are masked with ``where``. That is exact
because LayerNorm normalises each row alone (the VAE populations' train-mode
BatchNorm is why those refuse masked sizes). A member that stops leaves the
population at the next epoch. `fit_classifier` is the population of one;
a member of a larger one agrees with its single fit to fp32 order (batched
products).

Not read, as they change no result: ``DOWNSTREAM_DIM_BUCKET`` and
``feature_bucket``'s column padding, ``EVAL_BUCKET``'s row buckets (both
save XLA compilations), ``DOWNSTREAM_SHARD`` (under a process group the
members always shard, `fit_classifier_folds`). A population's
members share one feature width; the callers group by exact width. The
refusal of an input wider than the trained width is kept (`_pad_cols`).

The weight bridge: the port keeps the JAX layout (``fc{1,2,3}.{w,b}`` with
``w`` stored (in, out), ``ln{1,2}.{gamma,beta}``), so `mlp_params_from_jax`
is a checked copy and `mlp_params_to_jax` its inverse.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.nn import dropout_apply, layernorm_apply, linear_apply, per_member
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.parallel.vmap_meta import (_pad_population, _rank_slice, _stack, _take,
                                                      population_mesh)
from vae_los_angeles_torch.training.engine import epoch_noise
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy, tree_to_numpy

HIDDEN = {"deep": (256, 128), "shallow": (128,)}
DROPOUT = {"deep": (0.3, 0.2), "shallow": (0.2,)}
PLATEAU_FACTOR, PLATEAU_PATIENCE = 0.5, 5
STOP_PATIENCE = 10


class ClassifierFit(NamedTuple):
    """A fit's parameters (tensors on its device; stacked for a population),
    its best validation accuracy and the accuracy of every epoch (NaN after
    a stop); numpy, one row a member for a population."""
    params: dict
    best_val_acc: np.ndarray
    val_accs: np.ndarray


def _check_arch(arch: str):
    if arch not in HIDDEN:
        raise ValueError(f"arch must be one of {sorted(HIDDEN)}, got {arch!r}")


def _param_keys(arch: str):
    n = len(HIDDEN[arch])
    keys = [f"fc{i}" for i in range(1, n + 2)]
    if arch == "deep":
        keys += [f"ln{i}" for i in range(1, n + 1)]
    return sorted(keys)


def _pad_cols(a, dim: int) -> np.ndarray:
    """``a`` with its last axis zero-padded to ``dim``; wider raises."""
    a = np.asarray(a)
    if a.shape[-1] > dim:
        raise ValueError(f"features wider ({a.shape[-1]}) than trained width ({dim}); a "
                         "classifier only accepts inputs at or below the width it was fit on")
    if a.shape[-1] == dim:
        return a
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, dim - a.shape[-1])])


def _pad_rows(a, n_max: int) -> np.ndarray:
    a = np.asarray(a)
    if len(a) == n_max:
        return a
    return np.pad(a, [(0, n_max - len(a))] + [(0, 0)] * (a.ndim - 1))


def _linear_init(generator, n_in: int, n_out: int):
    bound = 1.0 / math.sqrt(n_in)
    w = torch.empty(n_out, n_in).uniform_(-bound, bound, generator=generator)
    b = torch.empty(n_out).uniform_(-bound, bound, generator=generator)
    return {"w": w.t().contiguous(), "b": b}


def mlp_init(generator: torch.Generator, input_dim: int, n_classes: int, arch: str = "deep",
             device=None):
    """A classifier's parameters, drawn from ``generator`` (a CPU
    generator) as ``nn.Linear`` draws (U(±1/√fan_in) for weight then bias,
    layer after layer); LayerNorm's γ = 1, β = 0. On ``device``."""
    _check_arch(arch)
    widths = (input_dim, *HIDDEN[arch], n_classes)
    params = {}
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:]), 1):
        params[f"fc{i}"] = _linear_init(generator, n_in, n_out)
        if arch == "deep" and i < len(widths) - 1:
            params[f"ln{i}"] = {"gamma": torch.ones(n_out), "beta": torch.zeros(n_out)}
    return tree_map(lambda t: t.to(device), params)


def mlp_apply(params, x, *, arch: str = "deep", train: bool = False, masks=None):
    """Logits of ``x`` (rows, features), or (P, rows, features) with
    stacked parameters. In train mode each dropout layer takes its {0, 1}
    keep mask from ``masks`` (one a layer, shaped like its output)."""
    rates = DROPOUT[arch]
    if train and (masks is None or len(masks) != len(rates)):
        raise ValueError(f"train mode needs {len(rates)} dropout masks")
    h = x
    for i, rate in enumerate(rates, 1):
        h = linear_apply(params[f"fc{i}"], h)
        if arch == "deep":
            h = layernorm_apply(params[f"ln{i}"], h)
        h = dropout_apply(h.clamp(min=0.0), rate, train=train,
                          mask=masks[i - 1] if train else None)
    return linear_apply(params[f"fc{len(rates) + 1}"], h)


def _class_weight_of(class_weights, labels):
    if class_weights.dim() == 2:  # one row a member
        return torch.gather(class_weights, 1, labels)
    return class_weights[labels]


def _weighted_nll(logits, labels, class_weights):
    """(nll, class weight) of each row, a member's rows on the last axis."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels.unsqueeze(-1)).squeeze(-1)
    return nll, _class_weight_of(class_weights, labels)


def _masked_ce(logits, labels, class_weights, valid=None):
    """Σ w·nll / max(Σ w, 1e-12) over the rows ``valid`` keeps (all rows
    when None)."""
    nll, w = _weighted_nll(logits, labels, class_weights)
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
        w = torch.where(valid, w, 0.0)
    return (w * nll).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)


def weighted_ce_mean(logits, labels, class_weights):
    """torch ``CrossEntropyLoss(weight=w)``'s mean: Σ w[yᵢ]·nllᵢ / Σ w[yᵢ]."""
    nll, w = _weighted_nll(logits, labels, class_weights)
    return (w * nll).sum(-1) / w.sum(-1)


def _grads(params, x, y, class_weights, valid, masks, arch):
    """(loss, gradients) of one training batch; with stacked parameters the
    loss has one entry a member and each member's gradient is its own."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    logits = mlp_apply(leaves, x, arch=arch, train=True, masks=masks)
    loss = _masked_ce(logits, y, class_weights, valid)
    flat = [leaf for layer in leaves.values() for leaf in layer.values()]
    grads = iter(torch.autograd.grad(loss.sum(), flat))
    return loss.detach(), {k: {n: next(grads) for n in layer} for k, layer in leaves.items()}


def _draws(seed: int, epoch: int, n_train: int, n_batches: int, batch_size: int, arch: str,
           device):
    """A member's draws of one epoch from its generator
    (``engine.epoch_noise``): the permutation of its rows, then a {0, 1}
    keep mask a dropout layer for all its batches, (n_batches, batch,
    width)."""
    gen, perm = epoch_noise(seed, epoch, n_train, device)
    masks = tuple((torch.rand((n_batches, batch_size, width), generator=gen, device=device)
                   < 1.0 - rate).to(torch.float32)
                  for width, rate in zip(HIDDEN[arch], DROPOUT[arch]))
    return perm, masks


def _fit(params0, x_train, y_train, n_train, x_val, y_val, n_val, class_weights, seeds, *,
         arch: str, num_epochs: int, batch_size: int, lr: float, weight_decay: float,
         early_stop: bool, noise: Optional[Callable] = None) -> ClassifierFit:
    """The fit loop (module docstring) of a population: stacked parameters,
    (P, rows, ...) tables padded to the largest member, (P, classes) class
    weights, and a list of sizes and seeds. ``noise(member, epoch,
    n_batches)`` returns that member's (permutation, dropout masks) of the
    epoch in `_draws`' shapes; by default `_draws` from its seed."""
    _check_arch(arch)
    device = x_train.device
    sizes, val_sizes, seeds = list(n_train), list(n_val), list(seeds)
    n_members = len(sizes)
    if min(sizes) < 1 or min(val_sizes) < 1:
        raise ValueError("every member needs at least one training and one validation row")
    if noise is None:
        def noise(i, epoch, n_batches):
            return _draws(seeds[i], epoch, sizes[i], n_batches, batch_size, arch, device)
    n_batches = [-(-n // batch_size) for n in sizes]
    slots = torch.arange(max(n_batches) * batch_size, device=device)

    params = params0
    opt = optim.adamw_init(params)
    opt["step"] = torch.zeros(n_members, dtype=torch.int32, device=device)
    plateau = optim.plateau_init(lr, device, n_members=n_members)
    best = params
    best_acc = torch.zeros(n_members, dtype=torch.float32, device=device)
    patience = torch.zeros(n_members, dtype=torch.int32, device=device)
    stopped = torch.zeros(n_members, dtype=torch.bool, device=device)
    val_accs = np.full((n_members, num_epochs), np.nan, np.float32)
    best_accs = np.zeros(n_members, np.float32)
    finals = [None] * n_members
    live = list(range(n_members))  # the input positions still training
    n_tr_t = torch.tensor(sizes, device=device)
    n_va_t = torch.tensor(val_sizes, device=device)
    val_pos = torch.arange(x_val.shape[-2], device=device)

    for epoch in range(num_epochs):
        draws = [noise(i, epoch, n_batches[i]) for i in live]
        rows = torch.arange(len(live), device=device)[:, None]
        idx = torch.stack([perm[slots % sizes[i]] for i, (perm, _) in zip(live, draws)])
        valid = slots < n_tr_t[:, None]
        masks = []
        for k, width in enumerate(HIDDEN[arch]):
            m = torch.ones(len(live), len(slots) // batch_size, batch_size, width, device=device)
            for j, (_, ms) in enumerate(draws):
                m[j, : len(ms[k])] = ms[k]
            masks.append(m)
        lr_now = plateau["lr"]
        for b in range(len(slots) // batch_size):
            cols = slice(b * batch_size, (b + 1) * batch_size)
            xb, yb = x_train[rows, idx[:, cols]], y_train[rows, idx[:, cols]]
            _, grads = _grads(params, xb, yb, class_weights, valid[:, cols],
                              tuple(m[:, b] for m in masks), arch)
            new_params, new_opt = optim.adam_update(params, grads, opt, lr_now, weight_decay)
            if all(n_batches[i] > b for i in live):
                params, opt = new_params, new_opt
            else:  # the members without a batch b keep their parameters and Adam state
                on = n_tr_t > b * batch_size
                keep = lambda n, o: torch.where(per_member(on, n), n, o)  # noqa: E731
                params, opt = tree_map(keep, new_params, params), tree_map(keep, new_opt, opt)

        logits = mlp_apply(params, x_val, arch=arch)
        val_valid = val_pos < n_va_t[:, None]
        val_loss = _masked_ce(logits, y_val, class_weights, val_valid)
        correct = (logits.argmax(-1) == y_val) & val_valid
        val_acc = 100.0 * correct.sum(-1).to(torch.float32) / n_va_t.to(torch.float32)
        plateau = optim.plateau_step(plateau, val_loss, PLATEAU_FACTOR, PLATEAU_PATIENCE)
        improved = val_acc > best_acc
        best = tree_map(lambda b_, c: torch.where(per_member(improved, c), c, b_), best, params)
        best_acc = torch.maximum(best_acc, val_acc)
        patience = torch.where(improved, torch.zeros_like(patience), patience + 1)
        if early_stop:
            stopped = stopped | (patience >= STOP_PATIENCE)
        # the epoch's one host sync: the accuracies, the stops and the best accuracies
        acc_h, stop_h, best_h = torch.stack([val_acc, stopped.to(torch.float32), best_acc]) \
            .cpu().numpy()
        val_accs[live, epoch] = acc_h
        best_accs[live] = best_h
        if not stop_h.any():
            continue
        keep = [j for j, s in enumerate(stop_h) if not s]
        for j, s in enumerate(stop_h):
            if s:
                finals[live[j]] = tree_map(lambda t: t[j], best)
        live = [live[j] for j in keep]
        if not live:
            break
        keep_t = torch.tensor(keep, dtype=torch.int64, device=device)
        params, best, opt, plateau = (_take(t, keep_t) for t in (params, best, opt, plateau))
        best_acc, patience, stopped, n_tr_t, n_va_t, class_weights = (
            t.index_select(0, keep_t)
            for t in (best_acc, patience, stopped, n_tr_t, n_va_t, class_weights))
        x_train, y_train, x_val, y_val = (
            t.index_select(0, keep_t) for t in (x_train, y_train, x_val, y_val))

    final = best if early_stop else params
    for j, i in enumerate(live):
        finals[i] = tree_map(lambda t: t[j], final)
    return ClassifierFit(_stack(finals), best_accs, val_accs)


def _as_tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def fit_classifier(x_train, y_train, x_val, y_val, n_classes: int, class_weights, seed: int, *,
                   arch: str = "deep", num_epochs: int = 100, batch_size: int = 32,
                   lr: float = 1e-3, weight_decay: float = 1e-4, early_stop: bool = True,
                   device=None) -> ClassifierFit:
    """One classifier fit (module docstring) from ``seed``, its init and
    every epoch's draws: the population of one of `fit_classifier_folds`,
    its member axis taken off. Runs on the card unless ``device="cpu"``."""
    fit = fit_classifier_folds([(x_train, y_train, x_val, y_val, class_weights)], n_classes,
                               arch=arch, num_epochs=num_epochs, batch_size=batch_size, lr=lr,
                               weight_decay=weight_decay, early_stop=early_stop, seeds=[seed],
                               device=device)
    return ClassifierFit(tree_map(lambda t: t[0], fit.params), fit.best_val_acc[0],
                         fit.val_accs[0])


def fit_classifier_folds(folds: Sequence, n_classes: int, *, arch: str = "deep",
                         num_epochs: int = 100, batch_size: int = 32, lr: float = 1e-3,
                         weight_decay: float = 1e-4, early_stop: bool = True, seeds=None,
                         device=None) -> ClassifierFit:
    """Every fold of ``folds``, ``(x_train, y_train, x_val, y_val,
    class_weights)`` tuples of one feature width (sizes may differ), as one
    population; member i from ``seeds[i]`` (default its index, the
    sequential path's ``seed=fold_idx``). Returns a `ClassifierFit` with a
    leading member axis. Under a process group of two or more ranks the
    members shard over them as the VAE populations do
    (``vmap_meta.population_mesh``): padded by repeating the last, a
    contiguous slice a rank, gathered in member order on every rank."""
    device = resolve_device(device)
    seeds = list(range(len(folds))) if seeds is None else [int(s) for s in seeds]
    if len(seeds) != len(folds) or not folds:
        raise ValueError(f"{len(folds)} folds and {len(seeds)} seeds")
    kw = dict(arch=arch, num_epochs=num_epochs, batch_size=batch_size, lr=lr,
              weight_decay=weight_decay, early_stop=early_stop)
    mesh = population_mesh()
    if mesh is None:
        return _fit_folds(folds, n_classes, seeds, device, **kw)
    padded, lo, hi = _rank_slice(len(folds), mesh)
    local = _fit_folds(_pad_population(folds, padded)[lo:hi], n_classes,
                       _pad_population(seeds, padded)[lo:hi], device, **kw)
    parts = comm.gather_objects((tree_map(lambda t: t.cpu(), local.params), local.best_val_acc,
                                 local.val_accs))
    n = len(folds)
    params = tree_map(lambda *ts: torch.cat(ts)[:n].to(device), *(p[0] for p in parts))
    return ClassifierFit(params, np.concatenate([p[1] for p in parts])[:n],
                         np.concatenate([p[2] for p in parts])[:n])


def _fit_folds(folds, n_classes, seeds, device, *, arch, num_epochs, batch_size, lr,
               weight_decay, early_stop) -> ClassifierFit:
    """`fit_classifier_folds` on this device alone."""
    widths = {np.shape(f[0])[1] for f in folds} | {np.shape(f[2])[1] for f in folds}
    if len(widths) != 1:
        raise ValueError(f"a population's members share one feature width, got {sorted(widths)}: "
                         "group the members by width")
    width = widths.pop()
    n_tr_max = max(len(f[0]) for f in folds)
    n_va_max = max(len(f[2]) for f in folds)
    stack = lambda i, n, dt: _as_tensor(np.stack([_pad_rows(f[i], n) for f in folds]),  # noqa: E731
                                        dt, device)
    params0 = _stack([mlp_init(torch.Generator().manual_seed(s), width, n_classes, arch, device)
                      for s in seeds])
    return _fit(params0, stack(0, n_tr_max, torch.float32), stack(1, n_tr_max, torch.int64),
                [len(f[0]) for f in folds], stack(2, n_va_max, torch.float32),
                stack(3, n_va_max, torch.int64), [len(f[2]) for f in folds],
                _as_tensor(np.stack([f[4] for f in folds]), torch.float32, device), seeds,
                arch=arch, num_epochs=num_epochs, batch_size=batch_size, lr=lr,
                weight_decay=weight_decay, early_stop=early_stop)


@torch.no_grad()
def predict_classes(params, x, arch: str = "deep") -> np.ndarray:
    """Class codes of the rows of ``x`` (columns zero-padded to the trained
    width; wider raises)."""
    w = params["fc1"]["w"]
    x = _as_tensor(_pad_cols(x, w.shape[-2]), torch.float32, w.device)
    return mlp_apply(params, x, arch=arch).argmax(-1).cpu().numpy()


@torch.no_grad()
def predict_classes_folds(params, x_vals, arch: str = "deep") -> np.ndarray:
    """(P, rows) class codes of each member's ``x_vals[i]`` under its own
    stacked parameters; rows padded to the longest (callers cut member i to
    its own length), columns as `predict_classes`."""
    w = params["fc1"]["w"]
    n_max = max(len(x) for x in x_vals)
    x = np.stack([_pad_rows(_pad_cols(x, w.shape[-2]), n_max) for x in x_vals])
    return mlp_apply(params, _as_tensor(x, torch.float32, w.device), arch=arch).argmax(-1).cpu() \
        .numpy()


def mlp_params_from_jax(params, arch: str, device=None):
    """The port's parameters from the JAX package's (numpy or JAX arrays,
    stacked or not). A JAX fit at a bucketed width keeps fc1's zero rows:
    `predict_classes` pads its inputs' columns to them, as JAX's does."""
    _check_arch(arch)
    if sorted(params) != _param_keys(arch):
        raise ValueError(f"{arch} classifier parameters have keys {_param_keys(arch)}, got "
                         f"{sorted(params)}")
    return tree_from_numpy({k: dict(v) for k, v in params.items()}, device)


def mlp_params_to_jax(params):
    """The JAX package's layout (numpy arrays) of the port's parameters."""
    return tree_to_numpy(params)
