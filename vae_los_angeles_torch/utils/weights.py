"""Weight bridge between the JAX package's parameter pytrees and the port's
``state_dict``s (counterpart of the layout half of
``vae_los_angeles_tpu/utils/torch_import.py``).

  * JAX stores a Linear's ``w`` as (in, out); torch as (out, in).
  * BatchNorm ``gamma``/``beta`` are torch ``weight``/``bias``; the running
    ``mean``/``var`` live in the JAX package's separate ``state`` tree.
  * An Embedding's ``table`` is torch's ``weight``.
  * ``num_batches_tracked`` has no JAX counterpart: it is not emitted
    (``load_state_dict`` fills it in) and is ignored when read.

Only the directional VAEs (``rna2dna``, ``dna2rna``) are covered so far.

The trainer's own trees stay in the JAX layout, so moving them across is a
copy: `tree_to_numpy` and `tree_from_numpy` carry any nested dict of arrays
each way with dtypes kept — parameters, BatchNorm state, the AdamW moments
and the full training carry (params, state, opt {step, m, v}, plateau,
estop, best).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MODEL_TYPES", "jax_from_state_dict", "state_dict_from_jax", "tree_from_numpy",
           "tree_to_numpy"]


def _linear(key, path):
    return [(f"{key}.weight", "params", path + ("w",), True),
            (f"{key}.bias", "params", path + ("b",), False)]


def _batchnorm(key, path):
    return [(f"{key}.weight", "params", path + ("gamma",), False),
            (f"{key}.bias", "params", path + ("beta",), False),
            (f"{key}.running_mean", "state", path + ("mean",), False),
            (f"{key}.running_var", "state", path + ("var",), False)]


def _encoder_c(key, path):
    return ([(f"{key}.embedding.weight", "params", path + ("embedding", "table"), False)]
            + _linear(f"{key}.fc_mu", path + ("mu",))
            + _linear(f"{key}.fc_logvar", path + ("logvar",)))


# (state_dict key, JAX tree, path in that tree, transposed) for each tensor
MODEL_TYPES = {
    "rna2dna": (
        _linear("encoder_rna.fc.0", ("encoder_rna", "fc"))
        + _batchnorm("encoder_rna.fc.1", ("encoder_rna", "bn"))
        + _linear("encoder_rna.fc_mu", ("encoder_rna", "mu"))
        + _linear("encoder_rna.fc_logvar", ("encoder_rna", "logvar"))
        + _encoder_c("encoder_site", ("encoder_site",))
        + _linear("decoder_dna.fc.0", ("decoder_dna", "fc1"))
        + _linear("decoder_dna.fc.2", ("decoder_dna", "fc2"))
        + _linear("decoder_dna.fc.4", ("decoder_dna", "fc3"))
    ),
    "dna2rna": (
        _linear("encoder_dna.fc.0", ("encoder_dna", "fc1"))
        + _batchnorm("encoder_dna.fc.1", ("encoder_dna", "bn1"))
        + _linear("encoder_dna.fc.4", ("encoder_dna", "fc2"))
        + _batchnorm("encoder_dna.fc.5", ("encoder_dna", "bn2"))
        + _linear("encoder_dna.fc_mu", ("encoder_dna", "mu"))
        + _linear("encoder_dna.fc_logvar", ("encoder_dna", "logvar"))
        + _encoder_c("encoder_site", ("encoder_site",))
        + _linear("decoder_rna.fc.0", ("decoder_rna", "fc1"))
        + _linear("decoder_rna.fc.2", ("decoder_rna", "fc2"))
    ),
}


def _layout(model_type):
    try:
        return MODEL_TYPES[model_type]
    except KeyError:
        raise ValueError(
            f"unknown model type {model_type!r}; expected one of {sorted(MODEL_TYPES)}"
        ) from None


def state_dict_from_jax(params, state, model_type: str) -> dict:
    """JAX (params, state) pytrees with array leaves → ``{key: tensor}`` that
    the port's model loads with ``load_state_dict(strict=True)``."""
    trees = {"params": params, "state": state}
    sd = {}
    for key, tree, path, transposed in _layout(model_type):
        node = trees[tree]
        for i, p in enumerate(path):
            if not isinstance(node, dict) or p not in node:
                raise KeyError(
                    f"{tree} tree is missing {'/'.join(path[: i + 1])!r} — "
                    f"wrong model_type {model_type!r}?"
                )
            node = node[p]
        v = np.asarray(node, np.float32)
        sd[key] = torch.from_numpy(np.array(v.T if transposed else v, order="C"))  # own copy
    return sd


def jax_from_state_dict(sd: dict, model_type: str):
    """Inverse of `state_dict_from_jax`: returns (params, state) with float32
    numpy leaves. Every key but ``num_batches_tracked`` must be consumed."""
    rest = {k: v for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    trees = {"params": {}, "state": {}}
    for key, tree, path, transposed in _layout(model_type):
        if key not in rest:
            raise KeyError(f"state_dict is missing {key!r} — wrong model_type {model_type!r}?")
        v = rest.pop(key)
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        v = np.ascontiguousarray(v.astype(np.float32).T if transposed else v.astype(np.float32))
        node = trees[tree]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    if rest:
        raise ValueError(f"unconsumed state_dict keys for {model_type!r}: {sorted(rest)}")
    return trees["params"], trees["state"]


def tree_to_numpy(tree):
    """Nested dict of tensors (or arrays) → the same tree of numpy arrays,
    dtypes kept (a 0-d tensor becomes a 0-d array)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def tree_from_numpy(tree, device=None):
    """Nested dict of arrays (numpy, JAX or tensors) → tensors on ``device``,
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return torch.from_numpy(np.array(tree)).to(device)  # own copy
