"""Optimizer and scheduler state machines (counterpart of
``vae_los_angeles_tpu/ops/optim.py``), on tensors that stay on the device.

  * AdamW as ``torch.optim.AdamW`` computes it: decoupled decay applied
    multiplicatively BEFORE the Adam step, bias correction at the global
    step, eps added after the square root; betas (0.9, 0.999), eps 1e-8.
    fp32 moments only.
  * ReduceLROnPlateau, torch's defaults: mode 'min', threshold 1e-4
    relative, cooldown 0; ``lr`` is the rate for the NEXT epoch.
  * Early stopping on strict improvement, with the flag that tells the
    trainer to take a best snapshot.

Every state is a dict of 0-d tensors updated with ``torch.where``, so a
trainer reads nothing back to the host to step them. Adafactor and bf16
moments are not ported: they raise.
"""

from __future__ import annotations

import torch

from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
PLATEAU_THRESHOLD = 1e-4  # torch default, threshold_mode='rel'


def adamw_init(params, moments_dtype=None):
    """Fresh AdamW state: step 0 and zero moments shaped like ``params``."""
    if moments_dtype not in (None, "float32", "fp32", torch.float32):
        raise ValueError(f"moments_dtype={moments_dtype!r}: the port keeps fp32 moments only")
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
    }


def adamw_update(params, grads, state, lr, weight_decay):
    """One AdamW step; ``lr`` and ``weight_decay`` may be floats or 0-d
    tensors. Returns (new_params, new_state)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=t.device), t)

    def leaf(p, g, m, v):
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * torch.square(g)
        p = p * (1.0 - lr * weight_decay)  # torch order: decay first
        p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        return p, m, v

    out = tree_map(leaf, params, grads, state["m"], state["v"])  # leaves: (p, m, v)

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return pick(0), {"step": step, "m": pick(1), "v": pick(2)}


def plateau_init(lr, device=None):
    return {
        "lr": torch.as_tensor(lr, dtype=torch.float32, device=device).clone(),
        "best": torch.tensor(float("inf"), dtype=torch.float32, device=device),
        "bad_epochs": torch.zeros((), dtype=torch.int32, device=device),
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


def early_stop_init(device=None):
    return {
        "best_val": torch.tensor(float("inf"), dtype=torch.float32, device=device),
        "trigger": torch.zeros((), dtype=torch.int32, device=device),
        "stopped": torch.zeros((), dtype=torch.bool, device=device),
        "best_epoch": torch.zeros((), dtype=torch.int32, device=device),
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
