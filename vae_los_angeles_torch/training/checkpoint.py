"""Checkpoints and the run-id protocol (counterpart of
``vae_los_angeles_tpu/training/checkpoint.py``).

The format is the JAX package's, so a checkpoint either package writes
loads in the other:

  * ``checkpoints/best_{model}_{run_id}.npz``: the ``params`` and ``state``
    pytrees (JAX layout, see ``utils.weights``) flattened with ``/``
    separators under the ``params/…`` and ``state/…`` roots, an empty dict
    kept as a ``__empty_dict__`` marker leaf;
  * ``latest_{model}_run_id.txt`` in the working root names the run;
  * ``checkpoints/resume_{model}_{run_id}.npz``: the full training carry
    under ``carry/…`` and ``meta/epochs_done`` (+ ``meta/seed``), so a run
    continues exactly (`save_resume` / `load_resume`).

The port is fp32: a bfloat16 leaf (``.__bf16__`` in the archive, or a
bfloat16 tensor to save) raises.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Tuple

import numpy as np
import torch

_EMPTY = "__empty_dict__"
_BF16 = ".__bf16__"


def new_run_id() -> str:
    """Timestamp run id, same format as the reference's."""
    return datetime.now().strftime("%Y%m%d_%H%M%S")


def _leaf(x, where):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError(f"bfloat16 leaf at '{where}': the port stores fp32 checkpoints only")
        return x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        raise ValueError(f"bfloat16 leaf at '{where}': the port stores fp32 checkpoints only")
    return arr


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + _EMPTY] = np.asarray(0)
            return out
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(
                    f"checkpoint key {k!r} (at '{prefix}') contains '/', "
                    "which is the flattened-path separator"
                )
            if str(k).endswith(_BF16):
                raise ValueError(
                    f"checkpoint key {k!r} (at '{prefix}') ends with the "
                    f"reserved bfloat16 storage marker {_BF16!r}"
                )
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        raise TypeError(
            "checkpoint pytrees must be nested dicts with array leaves; got "
            f"{type(tree).__name__} at '{prefix[:-1] or '<root>'}'"
        )
    else:
        out[prefix[:-1]] = _leaf(tree, prefix[:-1])
    return out


def _unflatten(flat):
    tree = {}
    for key, val in flat.items():
        if key.endswith(_BF16):
            raise ValueError(
                f"checkpoint leaf {key!r} is stored as bfloat16; this port "
                "serves fp32 checkpoints only"
            )
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != _EMPTY:
            node[parts[-1]] = val
    return tree


def save(path: str, params, state=None):
    """Save a (params, bn_state) pair as a flat .npz archive."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params}
    if state is not None:
        payload["state"] = state
    np.savez(path, **_flatten(payload))


def load(path: str) -> Tuple[dict, dict]:
    """(params, state) with numpy leaves."""
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files}
    tree = _unflatten(flat)
    return tree.get("params", {}), tree.get("state", {})


def checkpoint_path(model_name: str, run_id: str, checkpoint_dir: str = "checkpoints"):
    return os.path.join(checkpoint_dir, f"best_{model_name}_{run_id}.npz")


def run_id_file(model_name: str) -> str:
    return f"latest_{model_name}_run_id.txt"


def save_best(model_name: str, run_id: str, params, state=None,
              checkpoint_dir: str = "checkpoints"):
    path = checkpoint_path(model_name, run_id, checkpoint_dir)
    save(path, params, state)
    return path


def write_run_id(model_name: str, run_id: str, root: str = "."):
    with open(os.path.join(root, run_id_file(model_name)), "w") as f:
        f.write(run_id)


def resume_path(model_name: str, run_id: str, checkpoint_dir: str = "checkpoints"):
    return os.path.join(checkpoint_dir, f"resume_{model_name}_{run_id}.npz")


def save_resume(model_name: str, run_id: str, carry, n_epochs_done: int,
                checkpoint_dir: str = "checkpoints", seed: Optional[int] = None):
    """Persist the full training carry; ``seed`` is the run's seed, which a
    resumed run needs to continue the same noise schedule."""
    path = resume_path(model_name, run_id, checkpoint_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"epochs_done": np.asarray(n_epochs_done)}
    if seed is not None:
        meta["seed"] = np.asarray(seed)
    np.savez(path, **_flatten({"carry": carry, "meta": meta}))
    return path


def load_resume(model_name: str, run_id: Optional[str] = None,
                checkpoint_dir: str = "checkpoints", root: str = "."):
    """(carry with numpy leaves, epochs_done, run_id, seed or None)."""
    if run_id is None:
        run_id = get_run_id(model_name, root)
    if run_id is None:
        raise FileNotFoundError(f"no run id recorded for model '{model_name}'")
    path = resume_path(model_name, run_id, checkpoint_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(f"resume checkpoint not found: {path}")
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files}
    tree = _unflatten(flat)
    meta = tree["meta"]
    seed = int(meta["seed"]) if "seed" in meta else None
    return tree["carry"], int(meta["epochs_done"]), run_id, seed


def get_run_id(model_name: str = "rna2dna", root: str = ".") -> Optional[str]:
    """The latest run id of a model, or None."""
    path = os.path.join(root, run_id_file(model_name))
    if not os.path.exists(path):
        return None
    with open(path) as f:
        run_id = f.read().strip()
    return run_id or None


def load_best(model_name: str, run_id: Optional[str] = None,
              checkpoint_dir: str = "checkpoints", root: str = "."):
    """(params, state, run_id) of the best checkpoint, via the run-id file
    when ``run_id`` is None."""
    if run_id is None:
        run_id = get_run_id(model_name, root)
    if run_id is None:
        raise FileNotFoundError(
            f"no run id recorded for model '{model_name}' "
            f"(expected {run_id_file(model_name)})"
        )
    path = checkpoint_path(model_name, run_id, checkpoint_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    params, state = load(path)
    return params, state, run_id
