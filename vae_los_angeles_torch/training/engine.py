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

Four paths compute an epoch:
  * plain: autograd over the task's loss, then the optimizer's update;
  * ``fused_step=True``: the task's train-step kernel each step
    (``ops.kernels.fused_train``), then ``adamw_update``;
  * ``fused_epoch=True``: the task's epoch kernel once per epoch
    (``ops.kernels.fused_epoch``), every step and its AdamW inside;
  * the wide head (``rna2dna`` at ``cfg.input_dim_b >=
    WIDE_HEAD_MIN_DIM_B``, the whole-methylome-width regime): what
    ``fused_step`` and ``fused_epoch`` train there, chosen by the data's
    width (`uses_wide_head`). Autograd over the trunk up to DecoderB's
    output layer, and that layer's step (logits, BCE sum, its gradients, dh
    with the pre-update weight and its AdamW) in the wide head kernel
    (``ops.kernels.fused_wide``), whose dh is back-propagated through the
    trunk; then ``adamw_update`` of the trunk. The same loss and updates as
    the plain path.
The step and epoch kernels exist for ``rna2dna``, ``dna2rna`` and
``multimodal`` (`FUSED`); the directional autoencoders (``rna2dna_ae``,
``dna2rna_ae``) train on the plain path, with β = 0 (no KL term). ``class_weights`` (the tri-modal task's per-site weights of the
cross-entropy term) and γ (``hp["gamma"]``) reach the train loss, the
validation loss and both kernels; the directional tasks ignore them. The
tri-modal kernels' wrappers check the site labels' range, one more read of
two numbers a call.

Noise comes from the run's ``seed``: epoch e shuffles with a generator seeded
from (seed, e), the plain path draws its dropout and eps from the same
generator, and the kernels draw Philox noise keyed by the same (seed, e)
value with the step index. So a fused_step and a fused_epoch run of one seed
see the same noise. The threefry streams of the JAX engine cannot be
matched: runs agree with it statistically, not bit for bit.

The wide-regime knobs of the JAX engine apply to the plain path:
``cfg.compute_dtype = "bfloat16"`` casts the 2-D parameters to bf16 inside
the differentiated loss (``ops.nn.cast_matmul_params``: fp32 products of
bf16 operands, fp32 masters, BatchNorm, losses and optimizer);
``cfg.moments_dtype = "bfloat16"`` stores the optimizer's moments in bf16;
``cfg.optimizer = "adafactor"`` trains with ``ops.optim.adafactor_update``.
The kernel paths refuse all three with a ``ValueError``, as the JAX engine
refuses them on its Pallas paths: the CUDA kernels are fp32 AdamW programs.
On resume the carry's optimizer state rules: a carry of the other optimizer
raises, and moments stored in another dtype than ``cfg.moments_dtype`` are
kept, with a note that the knob is ignored.

``cfg.debug_nans`` (``DEBUG_NANS=1``) raises ``FloatingPointError`` at the
first non-finite value, naming the epoch and, where known, the step: the
plain path runs under ``torch.autograd.set_detect_anomaly`` and checks each
step's loss before its backward; the kernel paths check the loss and the
updated parameters after each kernel call (the epoch kernel's per-step
losses name the step). Each check reads one flag back from the card.
Without it nothing is checked and no sync is added.

``masked_sizes=True`` (JAX ``build_fit_fn(masked_sizes=True)``, the core of
the masked-size populations, ``parallel.vmap_meta``): the tables are padded
to row maxima and ``true_sizes`` gives their true (n_train, n_val). Each
epoch draws its permutation over the padded maximum and stable-partitions
the valid ids first, so at a true size equal to the maximum the run is the
exact-shape run bit for bit. The batch grid is the padded maximum's (full
batches, then its remainder unless ``drop_last``); rows past the true size
are never gathered: a short batch's pad slots re-gather the batch's first
row and leave its loss and BatchNorm statistics through a row mask
(``ops.nn.RowMask``), so a run steps exactly floor or ceil(n_train / B) times
an epoch (`masked_grid`). The JAX package re-gathers the epoch's first row
instead; a row from outside the batch, normalised by the statistics of a
batch of a few rows, can reach activations whose exp overflows, and the
masked loss's zero gradient times that inf is NaN. The validation sum
masks the pad rows and divides by ceil(n_val / B) of the true size. In a
population a member without rows
in a trailing batch keeps its parameters, BatchNorm and optimizer state
(its own step) there, and draws that batch's noise from a spare generator,
so its stream is its own. It refuses, as the JAX engine does, the kernel
paths and intra-run data sharding (``mesh``).

``mesh`` (``parallel.sharding.make_mesh`` or ``vmap_meta.population_mesh``)
trains data-parallel, the JAX engine's rules: every rank of the process
group calls `fit` with the whole tables; each draws the epoch's shuffle and
the global batch's noise from the same generator and takes its rows of the
batch (``parallel.sharding.ShardContext``: dropout masks and eps drawn for
the global batch, BatchNorm on the global batch's statistics), the loss
sums and gradients are summed over the "data" axis (one all-reduce a step)
and divided by the global counts, so the run is the single-device plain
path up to the order of its sums, and a batch that does not divide by the
axis still trains. The parameters stay replicated (no tensor parallelism in
a fit, as in JAX: the "model" axis repeats the work). The validation loss
is summed the same way. A mesh of one device takes the plain program;
``mesh`` with ``fused_step`` or ``fused_epoch`` raises.

`predict` is the JAX engine's ``predict``: the task's eval-mode prediction
over a full table (z sampled from a generator seeded by ``seed``), in
``compute_dtype``, in one call or in ``chunk_size`` row chunks; with a
``mesh`` every rank predicts its rows, with the noise the single call
draws for them, and every rank returns the whole table.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.models import directional_vae
from vae_los_angeles_torch.ops import losses, optim
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.ops.kernels import fused_wide as fw
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy


class Fused(NamedTuple):
    """A task's kernels: the train step takes (rna, dna) in every task; the
    epoch takes the epoch's rows in the order ``epoch_rows`` gives them
    (input then target for the directional tasks; RNA then DNA, each an
    input and a target, for the tri-modal one); ``loss_args`` gives the
    keyword arguments of both kernels' loss beyond β."""

    step: Callable  # fused_train.*_fused_train_step
    epoch: Callable  # fused_epoch.*_fused_epoch
    epoch_rows: Callable  # Batch -> the epoch's row arrays
    loss_args: Callable  # (gamma, class_weights) -> {keyword: value}


def _no_loss_args(gamma, class_weights):
    return {}


FUSED = {
    "rna2dna": Fused(ft.rna2dna_fused_train_step, fe.rna2dna_fused_epoch,
                     lambda ep: (ep.tpm, ep.beta), _no_loss_args),
    "dna2rna": Fused(ft.dna2rna_fused_train_step, fe.dna2rna_fused_epoch,
                     lambda ep: (ep.beta, ep.tpm), _no_loss_args),
    "multimodal": Fused(ft.multimodal_fused_train_step, fe.multimodal_fused_epoch,
                        lambda ep: (ep.tpm, ep.beta),
                        lambda gamma, class_weights: {"gamma": gamma,
                                                      "class_weights": class_weights}),
}


# From this DecoderB width on, rna2dna's kernel paths train through the wide
# head kernel (B8) rather than the step and epoch kernels (B1, B2): on an H100
# the epoch kernel (a captured graph) was the faster at 393,216 probes and
# below, the wide head at 450,000 (``python3 chip_probes.py widths``, PERF.md).
WIDE_HEAD_MIN_DIM_B = 450_000


def uses_wide_head(task_name: str, cfg: Config) -> bool:
    """Whether a kernel path of ``task_name`` at ``cfg``'s widths trains
    through the wide head kernel (module docstring)."""
    return task_name == "rna2dna" and cfg.input_dim_b >= WIDE_HEAD_MIN_DIM_B


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


def _optimizer(name):
    if name not in optim.OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {name!r}; valid: {sorted(optim.OPTIMIZERS)}")
    return optim.OPTIMIZERS[name]


def init_carry(params0, state0, lr, moments_dtype: str = "float32", optimizer: str = "adamw",
               n_members=None):
    """Fresh training carry for a model, on the parameters' device: the
    optimizer's state from ``optim.OPTIMIZERS[optimizer]``, its moments
    stored in ``moments_dtype``. With ``n_members`` the trees are stacked on
    a member axis and the plateau and early-stop records hold one entry a
    member."""
    opt_init, _ = _optimizer(optimizer)
    device = tree_leaves(params0)[0].device
    return {
        "params": params0,
        "state": state0,
        "opt": opt_init(params0, ops_nn.resolve_compute_dtype(moments_dtype),
                        members=n_members is not None),
        "plateau": optim.plateau_init(lr, device, n_members),
        "estop": optim.early_stop_init(device, n_members),
        "best": {"params": params0, "state": state0},
    }


# the hyperparameters a trial population may set a member (JAX
# ``vmap_meta.fit_trials`` broadcasts the others)
POPULATION_KEYS = ("lr", "weight_decay", "beta_start", "gamma")


def hyperparams(cfg: Config, **overrides):
    """Hyperparameter bundle; an unknown override name raises. An override
    of a `POPULATION_KEYS` entry may be a (P,) array, one value a member of
    a population, kept as fp32 as the JAX package keeps it; the other keys
    stay scalars."""
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
        if np.ndim(v) == 0:
            hp[k] = type(hp[k])(v)
        elif k in POPULATION_KEYS and np.ndim(v) == 1:
            hp[k] = np.asarray(v, np.float32)
        else:
            raise ValueError(f"hyperparameter {k!r} has shape {np.shape(v)}: only "
                             f"{POPULATION_KEYS} take one value a member, (P,)")
    return hp


def beta_schedule(epoch: int, hp):
    """β of a 0-based global epoch, in float32 as the JAX engine computes it:
    a float, or one fp32 value a member when ``hp["beta_start"]`` is (P,)."""
    warm = np.float32(hp["warmup_epochs"])
    frac = np.float32(epoch) / max(warm, np.float32(1.0)) if warm > 0 else np.float32(1.0)
    beta = np.minimum(np.float32(1.0), np.float32(frac)) * np.asarray(hp["beta_start"],
                                                                         np.float32)
    return beta.astype(np.float32) if beta.ndim else float(beta)


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


def check_sizes(n_trs, n_vas, batch_size: int, drop_last: bool):
    """The host checks of every member's true sizes (JAX
    ``_check_masked_sizes``): a masked run's sizes do not reach a check
    that the exact shapes meet (an empty grid, torch's BatchNorm on one
    row), so they are made here."""
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


class GridBatch(NamedTuple):
    """One batch of a masked-size grid: its slots [lo, hi) of the epoch's
    partitioned permutation, the row mask (None where every member's slots
    are valid rows) and the (P,) active flags (None where every member has
    rows in it)."""

    lo: int
    hi: int
    mask: Optional[ops_nn.RowMask]
    active: Optional[torch.Tensor]


class MaskedGrid(NamedTuple):
    """The batch grid of a masked-size run or population (`masked_grid`)."""

    batches: list  # the GridBatch of every grid batch some member has rows in
    n_batches: object  # each member's batches an epoch, the train loss's divisor
    n_true: object  # the true sizes: an int, or a (P, 1) tensor
    partition: bool  # whether some true size is below the maximum

    def permute(self, perm):
        """The epoch's permutation with each member's valid ids first, in
        their order (a stable partition)."""
        if not self.partition:
            return perm
        order = torch.argsort((perm >= self.n_true).to(torch.uint8), dim=-1, stable=True)
        return perm.gather(-1, order)

    def rows(self, perm, gb: GridBatch):
        """The row ids of grid batch ``gb``: a member's pad slots re-gather
        its first row in the batch (a row of the batch's own statistics, so
        the pad rows normalise as that row does), or the epoch's first row
        where it has no row in the batch."""
        idx = perm[..., gb.lo:gb.hi]
        if gb.mask is None:
            return idx
        fill = idx[..., :1]
        if gb.active is not None:
            fill = torch.where(gb.active[:, None], fill, perm[..., :1])
        return torch.where(gb.mask.valid, idx, fill)


def masked_grid(n_true, n_max: int, batch_size: int, drop_last: bool, device) -> MaskedGrid:
    """The grid of ``n_max`` padded rows for the true sizes ``n_true`` (an
    int, or one int a member): full batches, then the remainder of
    ``n_max`` unless ``drop_last``. A member trains on its first
    floor(n / B)·B (``drop_last``) or n valid slots, so it steps exactly its
    own batch count; a batch no member has rows in is left out."""
    single = np.ndim(n_true) == 0
    sizes = [int(n_true)] if single else [int(n) for n in n_true]
    if max(sizes) > n_max:
        raise ValueError(f"true sizes {sizes} exceed the padded maximum {n_max}")
    used = [(n // batch_size) * batch_size if drop_last else n for n in sizes]
    n_grid = n_max // batch_size if drop_last else -(-n_max // batch_size)
    used_t = torch.tensor(used, device=device)
    valid = torch.arange(n_max, device=device) < used_t[:, None]
    batches = []
    for b in range(n_grid):
        lo, hi = b * batch_size, min((b + 1) * batch_size, n_max)
        counts = [min(max(u - lo, 0), hi - lo) for u in used]
        if not any(counts):
            continue
        mask = None
        if min(counts) < hi - lo:
            mask = (ops_nn.RowMask(valid[0, lo:hi], counts[0]) if single
                    else ops_nn.RowMask(valid[:, lo:hi], tuple(counts)))
        active = None
        if not all(counts):
            active = torch.tensor([c > 0 for c in counts], device=device)
        batches.append(GridBatch(lo, hi, mask, active))
    per_member = [u // batch_size if drop_last else -(-u // batch_size) for u in used]
    n_batches = (float(per_member[0]) if single
                 else torch.tensor(per_member, dtype=torch.float32, device=device))
    n_true_t = sizes[0] if single else torch.tensor(sizes, device=device)[:, None]
    return MaskedGrid(batches, n_batches, n_true_t, min(sizes) < n_max)


def masked_validation(n_true, n_max: int, batch_size: int, device):
    """(row mask or None, divisor) of a validation table padded to
    ``n_max`` rows: the valid prefix of each member and ceil(n / B) of its
    true size (an int, or one int a member)."""
    single = np.ndim(n_true) == 0
    sizes = [int(n_true)] if single else [int(n) for n in n_true]
    divisors = [-(-n // batch_size) for n in sizes]
    if single:
        divisor = float(divisors[0])
    else:
        divisor = torch.tensor(divisors, dtype=torch.float32, device=device)
    if min(sizes) == n_max:
        return None, divisor
    valid = torch.arange(n_max, device=device) < torch.tensor(sizes, device=device)[:, None]
    mask = (ops_nn.RowMask(valid[0], sizes[0]) if single
            else ops_nn.RowMask(valid, tuple(sizes)))
    return mask, divisor


def gate(active, new, old):
    """``new`` where a member is ``active``, else ``old``, leaf by leaf."""
    return tree_map(lambda n, o: torch.where(ops_nn.per_member(active, n), n, o), new, old)


def _check_supported(task_name, cfg, fused_step, fused_epoch, masked_sizes, mesh):
    if masked_sizes and (fused_step or fused_epoch):
        raise ValueError("masked_sizes is a plain-path feature: the CUDA kernels are "
                         "exact-shape programs")
    if masked_sizes and mesh is not None and mesh.size > 1:
        raise ValueError("masked_sizes composes with POPULATION sharding (parallel/vmap_meta), "
                         "not with intra-run data sharding")
    if mesh is not None and (fused_step or fused_epoch):
        raise ValueError(
            "mesh-sharded fit requires the plain path: the CUDA kernels are single-device "
            "programs (use parallel/vmap_meta population sharding for multi-device kernel "
            "workloads)")
    compute = ops_nn.resolve_compute_dtype(cfg.compute_dtype)
    moments = ops_nn.resolve_compute_dtype(cfg.moments_dtype)
    _optimizer(cfg.optimizer)
    if fused_step and fused_epoch:
        raise ValueError("choose one of fused_step and fused_epoch")
    if (fused_step or fused_epoch) and task_name not in FUSED:
        raise ValueError(f"task {task_name!r} has no fused kernels; the kernel paths train "
                         f"{sorted(FUSED)}")
    if fused_step or fused_epoch:
        for name, value, reduced in (("compute_dtype", cfg.compute_dtype, compute),
                                     ("moments_dtype", cfg.moments_dtype, moments),
                                     ("optimizer", cfg.optimizer, cfg.optimizer)):
            if reduced not in (torch.float32, "adamw"):
                raise ValueError(f"{name}={value!r} applies to the plain path only: the CUDA "
                                 "kernels are fp32 AdamW programs")


def _resumed_carry(resume_carry, cfg, device):
    """The resume carry on ``device``; its optimizer state rules (module
    docstring)."""
    carry = tree_from_numpy(resume_carry, device)
    found = "adafactor" if "vr" in carry["opt"] else "adamw"
    if found != cfg.optimizer:
        raise ValueError(f"resume checkpoint holds {found!r} optimizer state but "
                         f"Config.optimizer is {cfg.optimizer!r} — resume with the optimizer "
                         "the run was started with")
    want = ops_nn.resolve_compute_dtype(cfg.moments_dtype)
    stored = {leaf.dtype for key in ("m", "v", "vr", "vc") if key in carry["opt"]
              for leaf in tree_leaves(carry["opt"][key])}
    if stored and stored != {want}:
        names = "/".join(sorted(str(d).removeprefix("torch.") for d in stored))
        print(f"Note: resume checkpoint stores optimizer moments as {names}; "
              f"Config.moments_dtype={cfg.moments_dtype!r} is ignored for this run (the knob "
              "applies to fresh runs)")
    return carry


def _nan_check(epoch, step, losses, params=None):
    """DEBUG_NANS: raise at the first non-finite loss (``losses``: a step's
    loss or an epoch's per-step losses) or updated parameter."""
    named = [] if params is None else _named_leaves(params)
    flags = torch.stack([torch.isfinite(losses).all()]
                        + [torch.isfinite(t).all() for _, t in named])
    if bool(flags.all()):
        return
    bad = torch.nonzero(~torch.isfinite(losses.reshape(-1))).reshape(-1)
    if bad.numel():
        what = "loss"
        step = int(bad[0]) if step is None else step
    else:
        what = "updated parameter " + ", ".join(
            name for (name, _), ok in zip(named, flags[1:].tolist()) if not ok)
    where = f"epoch {epoch + 1}" + ("" if step is None else f", step {step + 1}")
    raise FloatingPointError(f"DEBUG_NANS: non-finite {what} at {where}")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _named_leaves(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _split_head(tree):
    """(the tree without ``decoder_dna/fc3``, that layer's subtree)."""
    dec = dict(tree["decoder_dna"])
    head = dec.pop("fc3")
    return {**tree, "decoder_dna": dec}, head


def _join_head(trunk, head, like):
    """``trunk`` with ``head`` back at ``decoder_dna/fc3``, keys in ``like``'s order."""
    dec = {k: head if k == "fc3" else trunk["decoder_dna"][k] for k in like["decoder_dna"]}
    return {k: dec if k == "decoder_dna" else trunk[k] for k in like}


def _wide_head_step(params, state, opt, batch, beta, generator, lr, weight_decay):
    """One rna2dna step with DecoderB's output layer in the wide head kernel
    (module docstring); returns (loss, params, state, opt)."""
    trunk, head = _split_head(params)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), trunk)
    h, mu, logvar, state = directional_vae.rna2dna_vae_hidden(
        _join_head(leaves, head, params), state, rna=batch.tpm, site=batch.site, train=True,
        generator=generator)
    (_, m_head), (_, v_head) = _split_head(opt["m"]), _split_head(opt["v"])
    new_w, new_b, m_w, v_w, m_b, v_b, _, dh, bce = fw.fused_wide_output_step(
        h.detach(), batch.beta, head["w"], head["b"], m_head["w"], v_head["w"], m_head["b"],
        v_head["b"], opt["step"], lr, weight_decay)
    kld_term = beta * losses.kl_divergence(mu, logvar)
    flat = tree_leaves(leaves)
    # dh back through the trunk as the gradient of the scalar Σ h·dh: the
    # product's backward hands h exactly dh
    grads_flat = iter(torch.autograd.grad(torch.sum(h * dh) + kld_term, flat))
    grads = tree_map(lambda _: next(grads_flat), leaves)
    trunk_opt = {"step": opt["step"], "m": _split_head(opt["m"])[0],
                 "v": _split_head(opt["v"])[0]}
    trunk, trunk_opt = optim.adamw_update(trunk, grads, trunk_opt, lr, weight_decay)
    new_opt = {"step": trunk_opt["step"],
               "m": _join_head(trunk_opt["m"], {"w": m_w, "b": m_b}, params),
               "v": _join_head(trunk_opt["v"], {"w": v_w, "b": v_b}, params)}
    params = _join_head(trunk, {"w": new_w, "b": new_b}, params)
    return (bce + kld_term).detach(), params, tree_map(torch.Tensor.detach, state), new_opt


def epoch_noise(seed: int, epoch: int, n_train: int, device):
    """The plain path's generator of one epoch, seeded by
    ``epoch_seed(seed, epoch)``, and the shuffle it draws first."""
    gen = torch.Generator(device=device).manual_seed(epoch_seed(seed, epoch))
    return gen, torch.randperm(n_train, generator=gen, device=device)


def _dp_grads(task, params, state, batch, beta, gen, mesh, compute_dtype, loss_kw):
    """The data-parallel path's (global loss sum, summed gradients, new
    state) of a training batch: this rank's rows of it (module docstring)."""
    from vae_los_angeles_torch.parallel.sharding import sharded_loss_and_grads

    lo, hi = mesh.row_range(len(batch))
    return sharded_loss_and_grads(task, params, state, Batch(*(t[lo:hi] for t in batch)), beta,
                                  gen, mesh, len(batch), compute_dtype, split=False, **loss_kw)


def plain_grads(task, params, state, batch, beta, gen, loss_kw, compute_dtype, debug, epoch, b,
                members: bool = False, row_mask=None):
    """The plain path's loss, gradients and new state of one training batch.
    With ``members`` every leaf is stacked on a member axis, ``gen`` holds
    one generator a member and the loss one entry a member; the members are
    independent, so the gradient of their sum is each member's own.
    ``row_mask`` masks a padded batch's pad slots (module docstring)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    # cast inside the differentiated loss: the grads reach the fp32 masters
    loss, state = task.loss(ops_nn.cast_matmul_params(leaves, compute_dtype, members),
                            state, batch, beta, True, gen, row_mask=row_mask, **loss_kw)
    if debug:
        _nan_check(epoch, b, loss.detach())
    flat = tree_leaves(leaves)
    grads_flat = iter(torch.autograd.grad(loss.sum() if members else loss, flat))
    grads = tree_map(lambda _: next(grads_flat), leaves)
    return loss.detach(), grads, tree_map(torch.Tensor.detach, state)


def _dp_context(mesh, n: int):
    """A data-parallel ``ShardContext`` for an ``n``-row batch and this
    rank's (lo, hi) of it."""
    from vae_los_angeles_torch.parallel.sharding import ShardContext

    ctx = ShardContext(mesh)
    return ctx, ctx.set_rows(n)


def end_epoch(task, carry, params, state, opt, val, beta, gen, hp, loss_kw, compute_dtype,
              n_val_batches, epoch, members: bool = False, mesh=None, row_mask=None):
    """An epoch's close: the validation loss over the whole set (its sum
    over ceil(n_val / batch) batches), the plateau, the strict-improvement
    early stop and the best snapshot; returns (val_loss, carry). With
    ``members`` every record has one entry a member; with a data-parallel
    ``mesh`` each rank sums its rows and the sums are added up; ``row_mask``
    leaves a padded table's pad rows out of the sum (`masked_validation`)."""
    fwd = ops_nn.cast_matmul_params(params, compute_dtype, members)
    with torch.no_grad():
        if mesh is None:
            val_sum, _ = task.loss(fwd, state, val, beta, False, gen, row_mask=row_mask,
                                   **loss_kw)
        else:
            ctx, (lo, hi) = _dp_context(mesh, len(val))
            with ops_nn.sharded(ctx):
                val_sum, _ = task.loss(fwd, state, Batch(*(t[lo:hi] for t in val)), beta, False,
                                       gen, **loss_kw)
            val_sum = mesh.psum(val_sum.reshape(1), "data")[0]
    val_loss = val_sum / n_val_batches
    plateau = optim.plateau_step(carry["plateau"], val_loss, hp["sched_factor"],
                                 hp["sched_patience"])
    estop, snap = optim.early_stop_step(carry["estop"], val_loss, epoch, hp["patience"])
    best = tree_map(lambda b_, c_: torch.where(ops_nn.per_member(snap, c_), c_, b_),
                    carry["best"], {"params": params, "state": state})
    return val_loss, {"params": params, "state": state, "opt": opt, "plateau": plateau,
                      "estop": estop, "best": best}


def fit(task_name: str, cfg: Config, train_arrays, val_arrays, seed: int, n_sites: int, *,
        num_epochs: Optional[int] = None, drop_last: bool = True, hp=None, init_params=None,
        init_state=None, resume_carry=None, start_epoch: int = 0, fused_step: bool = False,
        fused_epoch: bool = False, device=None,
        masked_sizes: bool = False, true_sizes=None, mesh=None,
        class_weights=None) -> FitResult:
    """Train a task end to end; returns the best-validation snapshot.

    ``train_arrays``/``val_arrays`` are (tpm, beta, site) arrays or tensors;
    ``seed`` seeds the initialisation (when neither ``init_params`` nor
    ``resume_carry`` is given), the shuffles and the noise;
    ``class_weights`` (n_sites,) weighs the tri-modal cross-entropy term.
    Runs on the card unless ``device="cpu"`` or ``cfg.platform == "cpu"``;
    ``mesh`` trains data-parallel; ``masked_sizes`` trains tables padded to
    row maxima at their ``true_sizes`` (n_train, n_val), by default the
    tables' own lengths (module docstring)."""
    _check_supported(task_name, cfg, fused_step, fused_epoch, masked_sizes, mesh)
    if mesh is not None and mesh.size == 1:
        mesh = None  # one device: the plain program
    kernels = fused_step or fused_epoch
    wide_head = kernels and uses_wide_head(task_name, cfg)
    fused_step, fused_epoch = fused_step and not wide_head, fused_epoch and not wide_head
    task = get_task(task_name)
    device = resolve_device(device, cfg)
    if num_epochs is None:  # an explicit 0 means "no training epochs"
        num_epochs = cfg.num_epochs
    hp = hyperparams(cfg) if hp is None else hp
    if any(np.ndim(hp[k]) for k in POPULATION_KEYS):
        raise ValueError("hyperparameters with one value a member train as a population: "
                         "use parallel.vmap_meta.fit_trials")
    train, val = _as_batch(train_arrays, device), _as_batch(val_arrays, device)
    if class_weights is not None:
        class_weights = torch.as_tensor(np.asarray(class_weights, np.float32)).to(device)
    loss_kw = {"gamma": hp["gamma"], "class_weights": class_weights}
    fused_kw = FUSED[task_name].loss_args(**loss_kw) if kernels else {}
    batch_size = int(cfg.batch_size)
    n_train, n_val = len(train), len(val)
    grid = val_mask = None
    if masked_sizes:
        n_tr_true, n_va_true = (n_train, n_val) if true_sizes is None else map(int, true_sizes)
        if n_va_true > n_val:
            raise ValueError(f"true n_val={n_va_true} exceeds the padded table's {n_val} rows")
        check_sizes([n_tr_true], [n_va_true], batch_size, drop_last)
        grid = masked_grid(n_tr_true, n_train, batch_size, drop_last, device)
        val_mask, n_val_batches = masked_validation(n_va_true, n_val, batch_size, device)
    elif true_sizes is not None:
        raise ValueError("true_sizes applies to masked_sizes=True")
    n_full = n_train // batch_size
    remainder = 0 if drop_last else n_train % batch_size
    n_batches = n_full + (1 if remainder else 0) if grid is None else len(grid.batches)
    if n_batches == 0:
        raise ValueError(
            f"no training batches: n_train={n_train} < batch_size={batch_size} with "
            "drop_last=True — lower batch_size or pass drop_last=False")
    if n_val == 0:
        raise ValueError("empty validation set: n_val=0")
    if kernels and remainder:
        raise ValueError(
            f"the fused kernels need full batches: n_train={n_train} is not divisible by "
            f"batch_size={batch_size} — use drop_last=True or the plain path")
    if grid is None:
        n_val_batches = -(-n_val // batch_size)
    if (train.tpm.shape[1], train.beta.shape[1]) != (cfg.input_dim_a, cfg.input_dim_b):
        raise ValueError(
            f"data widths {train.tpm.shape[1]}/{train.beta.shape[1]} differ from the config's "
            f"input_dim_a/input_dim_b {cfg.input_dim_a}/{cfg.input_dim_b}")

    if resume_carry is not None:
        carry = _resumed_carry(resume_carry, cfg, device)
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
    if kernels and any(
            leaf.dtype != torch.float32 for key in ("m", "v") if key in carry["opt"]
            for leaf in tree_leaves(carry["opt"][key])):
        raise ValueError("moments_dtype='bfloat16' applies to the plain path only: the CUDA "
                         "kernels are fp32 AdamW programs (the resume carry stores reduced "
                         "moments)")
    compute_dtype = ops_nn.resolve_compute_dtype(cfg.compute_dtype)
    _, opt_update = _optimizer(cfg.optimizer)
    step_host = int(carry["opt"]["step"])  # one read at the start of the run

    debug = bool(cfg.debug_nans)
    anomaly = (torch.autograd.set_detect_anomaly(True) if debug and not kernels
               else contextlib.nullcontext())
    with anomaly:
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
            gen, perm = epoch_noise(seed, epoch, n_train, device)
            if grid is not None:
                perm = grid.permute(perm)
            params, state, opt = carry["params"], carry["state"], carry["opt"]
            if fused_epoch:
                ep = train.take(perm[: n_full * batch_size])
                losses, params, m, v, state = FUSED[task_name].epoch(
                    params, opt["m"], opt["v"], state, *FUSED[task_name].epoch_rows(ep),
                    ep.site, n_sites, seed=eseed, beta=beta, lr=lr,
                    weight_decay=hp["weight_decay"], step0=step_host, n_batches=n_full,
                    **fused_kw)
                if debug:
                    _nan_check(epoch, None, losses, params)
                opt = {"step": opt["step"] + n_full, "m": m, "v": v}
                train_sum = losses.sum()
            else:
                train_sum = torch.zeros((), device=device)
                for b in range(n_batches):
                    row_mask = None
                    if grid is None:
                        batch = train.take(perm[b * batch_size:(b + 1) * batch_size])
                    else:
                        batch = train.take(grid.rows(perm, grid.batches[b]))
                        row_mask = grid.batches[b].mask
                    if wide_head:
                        loss, params, state, opt = _wide_head_step(
                            params, state, opt, batch, beta, gen, lr, hp["weight_decay"])
                        if debug:
                            _nan_check(epoch, b, loss, params)
                        train_sum = train_sum + loss
                        continue
                    if fused_step:
                        loss, grads, state = FUSED[task_name].step(
                            params, state, batch.tpm, batch.beta, batch.site, n_sites,
                            seed=eseed, step=b, beta=beta, **fused_kw)
                    elif mesh is not None:
                        loss, grads, state = _dp_grads(task, params, state, batch, beta, gen,
                                                       mesh, compute_dtype, loss_kw)
                        if debug:
                            _nan_check(epoch, b, loss)
                    else:
                        loss, grads, state = plain_grads(task, params, state, batch, beta, gen,
                                                         loss_kw, compute_dtype, debug, epoch, b,
                                                         row_mask=row_mask)
                    params, opt = opt_update(params, grads, opt, lr, hp["weight_decay"])
                    if debug and fused_step:
                        _nan_check(epoch, b, loss, params)
                    train_sum = train_sum + loss
            step_host += n_batches
            train_loss = train_sum / n_batches

            val_loss, carry = end_epoch(task, carry, params, state, opt, val, beta, gen, hp,
                                        loss_kw, compute_dtype, n_val_batches, epoch, mesh=mesh,
                                        row_mask=val_mask)
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


def predict(task_name: str, params, state, arrays, seed: int = 0, mesh=None, chunk_size=None,
            compute_dtype: str = "float32", device=None):
    """Eval-mode prediction of ``task_name``'s target over a full table
    ``arrays`` ((tpm, beta, site) arrays or tensors). ``params``/``state``
    are trees of arrays or tensors; the noise a VAE samples comes from one
    generator seeded by ``seed``. ``compute_dtype`` "bfloat16" casts the
    2-D weights as training does (use the dtype the model trained with).
    Returns a tensor on the device; with ``chunk_size`` the table goes to
    the device ``chunk_size`` rows at a time (keep it on the host for that)
    and the result comes back as one numpy array of the same rows, the
    chunks drawing their noise from the one generator in turn. Runs on the
    card unless ``device="cpu"``. With a ``mesh`` (every rank calls it with
    the whole table) each rank predicts its rows of each call or chunk,
    drawing for them the noise the single call draws, and every rank returns
    the whole result; a mesh of one device is the single call."""
    if mesh is not None and mesh.size == 1:
        mesh = None
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    task = get_task(task_name)
    device = resolve_device(device)
    dtype = ops_nn.resolve_compute_dtype(compute_dtype)
    params = ops_nn.cast_matmul_params(tree_from_numpy(params, device), dtype)
    state = tree_from_numpy(state, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = len(arrays[0])
    if n == 0:
        raise ValueError("cannot predict an empty table")

    def serve(table):
        if mesh is None:
            return task.predict(params, state, _as_batch(table, device), gen)
        rows = len(table[0])
        ctx, (lo, hi) = _dp_context(mesh, rows)
        with ops_nn.sharded(ctx):
            part = task.predict(params, state, _as_batch([a[lo:hi] for a in table], device), gen)
        return comm.all_gather_rows(part, mesh.row_counts(rows), mesh.group("data"))

    with torch.no_grad():
        if chunk_size is None:
            return serve(arrays)
        return np.concatenate([serve([a[start:start + chunk_size] for a in arrays]).cpu().numpy()
                               for start in range(0, n, chunk_size)])


def replicate_for_serving(tree, mesh=None, device=None):
    """A params/state tree placed on this rank's device once (every rank
    holds the whole tree), so that repeated `predict` calls reuse it."""
    del mesh  # every rank of any mesh holds the replicated tree
    return tree_from_numpy(tree, resolve_device(device))


def samples_trained(n_train: int, batch_size: int, epochs: int, drop_last: bool = True) -> int:
    """Rows a run of ``epochs`` epochs trains on (drop_last discards the rest)."""
    per_epoch = (n_train // batch_size) * batch_size if drop_last else n_train
    return per_epoch * epochs


__all__ = ["FUSED", "FitResult", "POPULATION_KEYS", "WIDE_HEAD_MIN_DIM_B", "beta_schedule",
           "check_sizes", "epoch_seed", "fit", "hyperparams", "init_carry", "masked_grid",
           "masked_validation", "predict", "replicate_for_serving", "samples_trained",
           "uses_wide_head"]
