"""Reference PyTorch checkpoints (``.pt`` state_dicts) in and out of the
port's ``.npz`` checkpoints (counterpart of
``vae_los_angeles_tpu/utils/torch_import.py``).

The reference ships ``torch.save(model.state_dict(), ...)`` checkpoints;
the port's modules use the reference's key names, and `utils.weights`
holds the one layout table of the five model types (Linear weights
transposed, BatchNorm running statistics in the ``state`` tree,
``num_batches_tracked`` dropped on the way in and written as 0 on the way
out). So:

  * `import_main` (``python -m vae_los_angeles_torch.import_torch_checkpoint
    best_rna2dna_<run_id>.pt [--model M] [--out X.npz] [--write-run-id]``)
    converts a ``.pt`` into the ``.npz`` format that both packages read, and
    with ``--write-run-id`` registers it under the run-id protocol
    (``<CHECKPOINT_DIR>/best_<model>_<run_id>.npz`` and
    ``latest_<model>_run_id.txt``), where the loaders serve it;
  * `export_main` (``python -m vae_los_angeles_torch.export_torch_checkpoint
    X.npz [--model M] [--out X.pt]``) writes a ``.pt`` that the reference's
    modules load with ``strict=True``.

Every state_dict entry must be consumed: a leftover key raises, so a
checkpoint converted under the wrong ``--model`` fails instead of serving a
half-mapped model. ``torch.load`` reads with ``weights_only=True``.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.training import checkpoint
from vae_los_angeles_torch.utils import weights
from vae_los_angeles_torch.utils.tree import tree_leaves

__all__ = ["MODEL_TYPES", "convert_state_dict", "export_state_dict", "export_main",
           "import_main", "infer_model_type", "load_torch_state_dict"]

# the reference's checkpoint families (weights.MODEL_TYPES also holds the
# port's internal CV and HPO task layouts, which no reference file uses)
MODEL_TYPES = ("rna2dna", "dna2rna", "rna2dna_ae", "dna2rna_ae", "multivae")


def _check_model(model_type):
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model type {model_type!r}; expected one of "
                         f"{sorted(MODEL_TYPES)}")


def infer_model_type(path: str):
    """The model family of the reference's checkpoint naming
    (``best_<model>_<run_id>.pt``), else None."""
    base = os.path.basename(path)
    # longest names first, so best_rna2dna_ae_* does not match rna2dna
    for name in sorted(MODEL_TYPES, key=len, reverse=True):
        if re.match(rf"(best_)?{name}([_.]|$)", base):
            return name
    return None


def load_torch_state_dict(path: str) -> dict:
    """A ``.pt`` state_dict as {key: np.ndarray}, read with
    ``weights_only=True``; a ``{"state_dict": ...}`` or
    ``{"model_state_dict": ...}`` container is unwrapped, anything else
    that is not tensor-valued raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(
            f"{path} did not contain a state_dict (got {type(sd).__name__}"
            + (f" with keys {sorted(sd)[:6]}" if isinstance(sd, dict) else "")
            + "); reference checkpoints are saved via torch.save(model.state_dict())")
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()}


def convert_state_dict(sd: dict, model_type: str):
    """A reference state_dict ({key: array or tensor}) → the port's
    (params, state) trees with float32 numpy leaves."""
    _check_model(model_type)
    return weights.jax_from_state_dict(sd, model_type)


def export_state_dict(params, state, model_type: str) -> dict:
    """Inverse of `convert_state_dict`: (params, state) → a reference
    state_dict ({key: np.ndarray}) that loads with ``strict=True``
    (``num_batches_tracked`` 0 for each BatchNorm)."""
    _check_model(model_type)
    sd = {k: v.numpy() for k, v in weights.state_dict_from_jax(params, state,
                                                               model_type).items()}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def _model(ap, args, path):
    model = args.model or infer_model_type(path)
    if model is None:
        ap.error(f"cannot infer the model type from {path!r}; pass "
                 f"--model {{{','.join(sorted(MODEL_TYPES))}}}")
    return model


def import_main(argv=None):
    """``.pt`` → ``.npz`` (and, with ``--write-run-id``, the run-id protocol)."""
    ap = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint (.pt state_dict) to the .npz format")
    ap.add_argument("pt_path", help="reference .pt state_dict checkpoint")
    ap.add_argument("--model", choices=sorted(MODEL_TYPES), default=None,
                    help="architecture (default: inferred from the filename)")
    ap.add_argument("--out", default=None,
                    help="output .npz (default: the input path with .npz; with --write-run-id "
                         "the run-id protocol's path, which --out may only repeat)")
    ap.add_argument("--write-run-id", action="store_true",
                    help="register under the run-id protocol: write the .npz to "
                         "<CHECKPOINT_DIR>/best_<model>_<run_id>.npz and record the run id "
                         "in latest_<model>_run_id.txt")
    args = ap.parse_args(argv)
    model = _model(ap, args, args.pt_path)

    # the destination first, so a protocol conflict fails before anything is written
    run_id = None
    if args.write_run_id:
        m = re.search(r"_(\d{8}_\d{6})\.pt$", os.path.basename(args.pt_path))
        run_id = m.group(1) if m else checkpoint.new_run_id()
        out = checkpoint.checkpoint_path(model, run_id, Config.from_env().checkpoint_dir)
        if args.out and os.path.abspath(args.out) != os.path.abspath(out):
            ap.error(f"--write-run-id registers the checkpoint at {out!r} (where the run-id "
                     "protocol's consumers resolve it); drop --out or point it there")
    else:
        out = args.out or re.sub(r"\.pt$", "", args.pt_path) + ".npz"

    params, state = convert_state_dict(load_torch_state_dict(args.pt_path), model)
    checkpoint.save(out, params, state)
    n = sum(x.size for x in tree_leaves(params))
    print(f"converted {args.pt_path} [{model}] -> {out} ({n:,} parameters)")
    if args.write_run_id:
        checkpoint.write_run_id(model, run_id)
        print(f"run id {run_id} -> {checkpoint.run_id_file(model)}")


def export_main(argv=None):
    """``.npz`` → a reference-loadable ``.pt``."""
    ap = argparse.ArgumentParser(
        description="Export a .npz checkpoint as a reference-compatible torch state_dict (.pt)")
    ap.add_argument("npz_path", help=".npz checkpoint")
    ap.add_argument("--model", choices=sorted(MODEL_TYPES), default=None,
                    help="architecture (default: inferred from the filename)")
    ap.add_argument("--out", default=None, help="output .pt (default: the input path with .pt)")
    args = ap.parse_args(argv)
    model = _model(ap, args, args.npz_path)

    params, state = checkpoint.load(args.npz_path)
    sd = export_state_dict(params, state, model)
    out = args.out or re.sub(r"\.npz$", "", args.npz_path) + ".pt"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out)
    print(f"exported {args.npz_path} [{model}] -> {out} ({len(sd)} tensors)")
