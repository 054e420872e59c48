"""Weight bridge between the JAX package's parameter pytrees and the port's
``state_dict``s (counterpart of the layout half of
``vae_los_angeles_tpu/utils/torch_import.py``).

  * JAX stores a Linear's ``w`` as (in, out); torch as (out, in).
  * BatchNorm ``gamma``/``beta`` are torch ``weight``/``bias``; the running
    ``mean``/``var`` live in the JAX package's separate ``state`` tree.
  * An Embedding's ``table`` is torch's ``weight``.
  * ``num_batches_tracked`` has no JAX counterpart: it is not emitted
    (``load_state_dict`` fills it in) and is ignored when read.

The directional VAEs (``rna2dna``, ``dna2rna``), the directional
autoencoders (``rna2dna_ae``, ``dna2rna_ae``: each encoder a bare Sequential,
keys ``encoder_rna.0/.1/.4`` and ``encoder_dna.0/.1/.4/.5/.8``, the site path
``site_embedding`` and ``site_projection``), the tri-modal VAE
(``multivae``) and the unified tasks (``rna2dna_unified``,
``dna2rna_unified``: the directional VAE's keys and the state's ``kl_on``
scalar under the key ``kl_on``, which a module does not hold: drop it before
``load_state_dict``) are covered.

The trainer's own trees stay in the JAX layout, so moving them across is a
copy: `tree_to_numpy` and `tree_from_numpy` carry any nested dict of arrays
each way with dtypes kept — parameters, BatchNorm state, the optimizer's
state and the full training carry (params, state, opt {step, m, v} or
{step, vr, vc}, plateau, estop, best). numpy has no bfloat16: a bf16 tensor
stays a CPU bf16 tensor in a numpy tree, and `tree_from_numpy` also takes a
numpy array of ``ml_dtypes.bfloat16`` (what ``jax.device_get`` returns),
bit for bit.
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


def _encoder_a(key, path):
    return (_linear(f"{key}.fc.0", path + ("fc",)) + _batchnorm(f"{key}.fc.1", path + ("bn",))
            + _linear(f"{key}.fc_mu", path + ("mu",))
            + _linear(f"{key}.fc_logvar", path + ("logvar",)))


def _encoder_b(key, path):
    return (_linear(f"{key}.fc.0", path + ("fc1",)) + _batchnorm(f"{key}.fc.1", path + ("bn1",))
            + _linear(f"{key}.fc.4", path + ("fc2",)) + _batchnorm(f"{key}.fc.5", path + ("bn2",))
            + _linear(f"{key}.fc_mu", path + ("mu",))
            + _linear(f"{key}.fc_logvar", path + ("logvar",)))


def _decoder(key, path, n_layers):
    """A Sequential of Linear → ReLU pairs: keys fc.0, fc.2, ... → fc1, fc2, ..."""
    return [t for i in range(n_layers)
            for t in _linear(f"{key}.fc.{2 * i}", path + (f"fc{i + 1}",))]


def _site_path():
    """The autoencoders' site path: Embedding, then a Linear to the latent."""
    return ([("site_embedding.weight", "params", ("site_embedding", "table"), False)]
            + _linear("site_projection", ("site_projection",)))


# (state_dict key, JAX tree, path in that tree, transposed) for each tensor
MODEL_TYPES = {
    "rna2dna": (
        _encoder_a("encoder_rna", ("encoder_rna",))
        + _encoder_c("encoder_site", ("encoder_site",))
        + _decoder("decoder_dna", ("decoder_dna",), 3)
    ),
    "dna2rna": (
        _encoder_b("encoder_dna", ("encoder_dna",))
        + _encoder_c("encoder_site", ("encoder_site",))
        + _decoder("decoder_rna", ("decoder_rna",), 2)
    ),
    "rna2dna_ae": (
        _linear("encoder_rna.0", ("enc_fc1",)) + _batchnorm("encoder_rna.1", ("enc_bn",))
        + _linear("encoder_rna.4", ("enc_fc2",)) + _site_path()
        + _decoder("decoder_dna", ("decoder_dna",), 3)
    ),
    "dna2rna_ae": (
        _linear("encoder_dna.0", ("enc_fc1",)) + _batchnorm("encoder_dna.1", ("enc_bn1",))
        + _linear("encoder_dna.4", ("enc_fc2",)) + _batchnorm("encoder_dna.5", ("enc_bn2",))
        + _linear("encoder_dna.8", ("enc_fc3",)) + _site_path()
        + _decoder("decoder_rna", ("decoder_rna",), 2)
    ),
    # MultiModalVAE: EncoderA/B/C, DecoderA (RNA), DecoderB (DNA), DecoderC (site)
    "multivae": (
        _encoder_a("encoder_a", ("encoder_a",))
        + _encoder_b("encoder_b", ("encoder_b",))
        + _encoder_c("encoder_c", ("encoder_c",))
        + _decoder("decoder_a", ("decoder_a",), 2)
        + _decoder("decoder_b", ("decoder_b",), 3)
        + _decoder("decoder_c", ("decoder_c",), 2)
    ),
}


# the unified tasks: the directional VAE and its kl_on state scalar
for _direction in ("rna2dna", "dna2rna"):
    MODEL_TYPES[f"{_direction}_unified"] = (MODEL_TYPES[_direction]
                                            + [("kl_on", "state", ("kl_on",), False)])


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
        v = v.astype(np.float32).T if transposed else v.astype(np.float32)
        v = np.ascontiguousarray(v).reshape(v.shape)  # a 0-d entry (kl_on) stays 0-d
        node = trees[tree]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    if rest:
        raise ValueError(f"unconsumed state_dict keys for {model_type!r}: {sorted(rest)}")
    return trees["params"], trees["state"]


def tree_to_numpy(tree):
    """Nested dict of tensors (or arrays) → the same tree of numpy arrays,
    dtypes kept (a 0-d tensor becomes a 0-d array; a bf16 tensor becomes a
    CPU bf16 tensor)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        return tree if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree)


def tree_from_numpy(tree, device=None):
    """Nested dict of arrays (numpy, JAX or tensors) → tensors on ``device``,
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    arr = np.array(tree)  # own copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
