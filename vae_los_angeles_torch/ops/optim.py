"""Optimizer and scheduler state machines (counterpart of
``vae_los_angeles_tpu/ops/optim.py``), on tensors that stay on the device.

  * AdamW as ``torch.optim.AdamW`` computes it: decoupled decay applied
    multiplicatively BEFORE the Adam step, bias correction at the global
    step, eps added after the square root; betas (0.9, 0.999), eps 1e-8.
    The moments may be STORED in bfloat16 (``adamw_init(params,
    "bfloat16")``): the update upcasts them, computes in fp32 and rounds
    back to nearest even, as the JAX package's ``astype`` does, so the same
    fp32 values give the same stored bits.
  * Adafactor (Shazeer & Stern 2018) with an external learning rate and no
    first moment: factored row and column statistics of g² + eps1 for
    leaves of two or more dimensions, a full statistic for 1-D leaves;
    β₂ₜ = 1 − t^−0.8, the update RMS-clipped to 1, decoupled decay first.
    State keys ``step``, ``vr`` and ``vc`` as in JAX (``vc`` is a (0,)
    placeholder for a 1-D leaf).
  * ReduceLROnPlateau, torch's defaults: mode 'min', threshold 1e-4
    relative, cooldown 0; ``lr`` is the rate for the NEXT epoch.
  * Early stopping on strict improvement, with the flag that tells the
    trainer to take a best snapshot.

Every state is a dict of 0-d tensors updated with ``torch.where``, so a
trainer reads nothing back to the host to step them. `OPTIMIZERS` maps
``Config.optimizer`` to its (init, update) pair.

A member axis (the fold populations): AdamW takes stacked leaves and an
``lr`` of shape (P,), broadcast over each member's leaves; its decay factor
1 - lr·wd is formed in float64 and rounded once, as a single run forms it
on the host from its Python float rate, so each member's update has a
single run's bits for the same gradient. ``plateau_init(lr, n_members=P)``
and ``early_stop_init(n_members=P)`` hold one record a member, which the
steps update elementwise.
"""

from __future__ import annotations

import torch

from vae_los_angeles_torch.ops.nn import per_member, resolve_compute_dtype
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
PLATEAU_THRESHOLD = 1e-4  # torch default, threshold_mode='rel'


def _step_of(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params, moments_dtype=None):
    """Fresh AdamW state: step 0 and zero moments shaped like ``params``,
    stored in ``moments_dtype`` ("bfloat16", a torch dtype, or None/"float32"
    for the parameters' own dtype)."""
    dt = None if moments_dtype is None else resolve_compute_dtype(moments_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    return {"step": _step_of(params), "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def bias_corrections(step):
    """(step + 1, 1 - β1^t, 1 - β2^t) at t = step + 1, in fp32 on the step's
    device, as `adamw_update` computes them."""
    new_step = step + 1
    t = new_step.to(torch.float32)
    # fills, not copies from the host: a copy to the card waits for its queue to drain
    bc1 = 1.0 - torch.pow(torch.full((), ADAM_B1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.full((), ADAM_B2, dtype=torch.float32, device=t.device), t)
    return new_step, bc1, bc2


def adamw_update(params, grads, state, lr, weight_decay):
    """One AdamW step; ``lr`` and ``weight_decay`` may be floats or 0-d
    tensors, or ``lr`` one fp32 rate a member of stacked leaves (module
    docstring; ``weight_decay`` a float then). Moments stored reduced are
    upcast, updated in fp32 and rounded back to their storage dtype.
    Returns (new_params, new_state)."""
    step, bc1, bc2 = bias_corrections(state["step"])
    members = isinstance(lr, torch.Tensor) and lr.dim() == 1
    decay = (1.0 - lr.double() * weight_decay).float() if members else 1.0 - lr * weight_decay

    def leaf(p, g, m, v):
        mdt, vdt = m.dtype, v.dtype
        m = ADAM_B1 * m.to(torch.float32) + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v.to(torch.float32) + (1.0 - ADAM_B2) * torch.square(g)
        p = p * per_member(decay, p)  # torch order: decay first
        p = p - per_member(lr, p) * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        return p, m.to(mdt), v.to(vdt)

    out = tree_map(leaf, params, grads, state["m"], state["v"])  # leaves: (p, m, v)

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return pick(0), {"step": step, "m": pick(1), "v": pick(2)}


ADAFACTOR_EPS1 = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_DECAY = -0.8


def adafactor_init(params, moments_dtype=None):
    """Fresh Adafactor state: step 0, row statistics ``vr`` (the full
    statistic of a 1-D leaf) and column statistics ``vc`` (a (0,)
    placeholder for a 1-D leaf), zeros in ``moments_dtype`` (default fp32)."""
    dt = resolve_compute_dtype(moments_dtype)

    def row(p):
        shape = p.shape[:-1] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=dt, device=p.device)

    def col(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (0,)
        return torch.zeros(shape, dtype=dt, device=p.device)

    return {"step": _step_of(params), "vr": tree_map(row, params), "vc": tree_map(col, params)}


def adafactor_update(params, grads, state, lr, weight_decay):
    """One Adafactor step: β₂ₜ = 1 − t^−0.8; a factored leaf's statistics
    are the row and column means of g² + eps1 and approximate rsqrt(v) as
    rsqrt(row / mean(row)) ⊗ rsqrt(col); the update is RMS-clipped to 1,
    scaled by ``lr`` and applied after the decoupled decay. Math in fp32,
    statistics rounded back to their storage dtype."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2t = 1.0 - torch.pow(t, ADAFACTOR_DECAY)

    def leaf(p, g, vr, vc):
        vrdt, vcdt = vr.dtype, vc.dtype
        u = torch.square(g) + ADAFACTOR_EPS1
        if p.dim() >= 2:
            vr = beta2t * vr.to(torch.float32) + (1.0 - beta2t) * u.mean(-1)
            vc = beta2t * vc.to(torch.float32) + (1.0 - beta2t) * u.mean(-2)
            r = torch.rsqrt(vr / vr.mean(-1, keepdim=True))
            c = torch.rsqrt(vc)
            upd = r[..., :, None] * c[..., None, :] * g
        else:
            vr = beta2t * vr.to(torch.float32) + (1.0 - beta2t) * u
            upd = torch.rsqrt(vr) * g
        rms = torch.sqrt(torch.mean(torch.square(upd)))
        upd = upd / torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
        p = p * (1.0 - lr * weight_decay)  # decoupled decay first, as HF orders it
        p = p - lr * upd
        return p, vr.to(vrdt), vc.to(vcdt)

    out = tree_map(leaf, params, grads, state["vr"], state["vc"])

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return pick(0), {"step": step, "vr": pick(1), "vc": pick(2)}


# (init, update) pairs the trainer selects from by Config.optimizer
OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),  # the torch-parity default
    "adafactor": (adafactor_init, adafactor_update),  # the wide-regime choice
}


def plateau_init(lr, device=None, n_members=None):
    """A fresh plateau record, or ``n_members`` of them stacked."""
    shape = () if n_members is None else (n_members,)
    return {
        "lr": torch.as_tensor(lr, dtype=torch.float32, device=device).expand(shape).clone(),
        "best": torch.full(shape, float("inf"), dtype=torch.float32, device=device),
        "bad_epochs": torch.zeros(shape, dtype=torch.int32, device=device),
    }


def plateau_step(state, metric, factor, patience):
    """Returns the updated state; its ``lr`` is the rate for the NEXT epoch."""
    improved = metric < state["best"] * (1.0 - PLATEAU_THRESHOLD)
    best = torch.where(improved, metric, state["best"])
    bad = torch.where(improved, torch.zeros_like(state["bad_epochs"]), state["bad_epochs"] + 1)
    reduce_now = bad > patience
    lr = torch.where(reduce_now, state["lr"] * factor, state["lr"])
    bad = torch.where(reduce_now, torch.zeros_like(bad), bad)
    return {"lr": lr, "best": best, "bad_epochs": bad}


def early_stop_init(device=None, n_members=None):
    """A fresh early-stop record, or ``n_members`` of them stacked."""
    shape = () if n_members is None else (n_members,)
    return {
        "best_val": torch.full(shape, float("inf"), dtype=torch.float32, device=device),
        "trigger": torch.zeros(shape, dtype=torch.int32, device=device),
        "stopped": torch.zeros(shape, dtype=torch.bool, device=device),
        "best_epoch": torch.zeros(shape, dtype=torch.int32, device=device),
    }


def early_stop_step(state, val_loss, epoch, patience):
    """Returns (new_state, take_snapshot): the snapshot flag is True on a
    strict improvement while not stopped."""
    improved = (val_loss < state["best_val"]) & ~state["stopped"]
    best_val = torch.where(improved, val_loss, state["best_val"])
    trigger = torch.where(improved, torch.zeros_like(state["trigger"]), state["trigger"] + 1)
    stopped = state["stopped"] | (trigger >= patience)
    epoch_t = torch.as_tensor(epoch, dtype=torch.int32, device=state["best_epoch"].device)
    best_epoch = torch.where(improved, epoch_t, state["best_epoch"])
    return (
        {"best_val": best_val, "trigger": trigger, "stopped": stopped, "best_epoch": best_epoch},
        improved,
    )
