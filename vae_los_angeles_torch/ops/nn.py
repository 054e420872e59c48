"""Layer primitives (counterpart of ``vae_los_angeles_tpu/ops/nn.py``).

The layers themselves are PyTorch's ``nn.Linear``, ``nn.BatchNorm1d`` and
``nn.Embedding``: their default inits are the distributions the JAX
package's ``linear_init`` and ``embedding_init`` reproduce
(U(±1/√fan_in) for a Linear's weight and bias, N(0, 1) for an Embedding).
`reset_parameters` redraws them from an explicit ``torch.Generator`` so a
model is a function of its seed.

`fold_bn_eval` is the host-side algebra the fused eval kernels rely on
(``ops/pallas/fused_vae.py`` ``fold_bn_eval``): eval-mode BatchNorm is
affine, so it folds into the preceding Linear.

The trainer's functional layers follow the JAX package's ``ops/nn.py``
semantics, on tensors in its layout (a Linear's ``w`` is (in, out)):
`batchnorm_apply` normalises with the biased batch variance in train mode
and tracks the unbiased one (factor B/(B-1)) with momentum 0.1;
`dropout_apply` zeroes with probability ``rate`` and scales what it keeps
by 1/(1 - rate), from an injected mask or an explicit ``torch.Generator``;
`layernorm_apply` (the downstream classifiers') normalises each row with
its biased variance.

Mixed precision (``Config.compute_dtype = "bfloat16"``), the JAX package's
policy: `cast_matmul_params` casts the 2-D leaves (Linear weights and the
Embedding table) to bf16 inside the differentiated loss, so the gradients
reach the fp32 masters as fp32; `linear_apply` follows the weight's dtype
and returns fp32. JAX's ``jnp.dot(bf16, bf16, preferred_element_type=f32)``
is an fp32 product of bf16 values; ``torch.matmul`` of two bf16 tensors
would round its result to bf16, so both operands are upcast to fp32 first.
A product of two bf16 values is exact in fp32, so this is JAX's arithmetic
up to the order of the sum, and it has autograd on every device (the
``torch.mm(..., out_dtype=float32)`` overload has no derivative).

A member axis (the fold populations, ``parallel.vmap_meta``): every apply
takes a 2-D ``(rows, features)`` batch with the single model's leaves, or a
3-D ``(members, rows, features)`` batch with every leaf stacked on a leading
member axis. A stacked Linear is one batched product (``torch.matmul`` of
(P, rows, in) by (P, in, out)) with its bias broadcast over the rows;
BatchNorm reduces over the row axis (-2); `embedding_lookup` gathers each
member's rows from its own table. The 2-D path is the single-run code, bit
for bit. Noise for a population comes from one generator a member
(`draw`): member i's draws are the ones a single run with that generator
makes, in the same order and shapes.

Masked rows (the masked-size populations, ``parallel.vmap_meta``): a batch
padded past its true rows carries a ``row_mask``, a bool (rows,) tensor or
(P, rows) on a member axis, or a `RowMask` that also holds the host's count
of each member's valid rows (the trainer's valid rows are a prefix, and the
RNA→DNA loss pair takes that prefix, ``ops.kernels.fused_loss``).
`batchnorm_apply` takes its train-mode statistics over the valid rows only
(row 0 always counts, so an all-masked batch makes no NaN) and scales the
running variance by the valid count's n/(n - 1); ``where`` keeps NaN padding
out of every sum, and an all-true mask gives the unmasked bits.

Data and tensor parallelism (``parallel.sharding``): while a
`ShardContext`-like object is active (`sharded`), `linear_apply`,
`batchnorm_apply` and `draw` hand 2-D batches to it: a rank's rows of the
global batch, the Megatron column/row linears, BatchNorm over the global
batch's statistics and on a column slice, and noise drawn for the global
batch (and whole columns) and sliced to the rank's part. Without one they
are the single-device code above.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple, Union

import torch
from torch import nn

BN_EPS = 1e-5  # nn.BatchNorm1d's default, as in the JAX package
BN_MOMENTUM = 0.1
LN_EPS = 1e-5  # nn.LayerNorm's default, as the JAX classifiers'

# the active data/tensor-parallel context (parallel.sharding.ShardContext), or None
_SHARD = [None]


@contextlib.contextmanager
def sharded(ctx):
    """Run the layers of this module through ``ctx`` (module docstring)."""
    prev, _SHARD[0] = _SHARD[0], ctx
    try:
        yield ctx
    finally:
        _SHARD[0] = prev


def fold_bn_eval(linear, bn_params, bn_state):
    """Fold eval-mode BN into the preceding Linear; returns (W', b').

    Arguments and results use the JAX package's layout: ``linear["w"]`` is
    (in, out), ``bn_params`` holds gamma/beta, ``bn_state`` mean/var.
    W' = W·s and b' = (b − μ)·s + β with s = γ/√(σ² + ε)."""
    s = bn_params["gamma"] / torch.sqrt(bn_state["var"] + BN_EPS)
    w = linear["w"] * s[None, :]
    b = (linear["b"] - bn_state["mean"]) * s + bn_params["beta"]
    return w, b


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every Linear and Embedding of ``module`` from ``generator``
    with PyTorch's default distributions; BatchNorm keeps its defaults
    (γ=1, β=0, running mean 0, running var 1)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, 1.0, generator=generator)
    return module


def per_member(t, like):
    """A per-member (P,) tensor shaped to broadcast over ``like``'s
    (P, ...) leaf; a scalar, a 0-d tensor or None as it is."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def draw(sampler, shape, generator, device, dtype=torch.float32):
    """``sampler(shape, generator=, device=, dtype=)`` (``torch.rand`` or
    ``torch.randn``); with a list of generators, one a member, the members'
    draws of ``shape[1:]`` stacked, each from its own generator."""
    if _SHARD[0] is not None and len(shape) == 2 and not isinstance(generator, (list, tuple)):
        return _SHARD[0].draw(sampler, shape, generator, device, dtype)
    return draw_plain(sampler, shape, generator, device, dtype)


def draw_plain(sampler, shape, generator, device, dtype=torch.float32):
    """`draw` without a parallel context."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for {shape[0]} members")
        return torch.stack([sampler(tuple(shape[1:]), generator=g, device=device, dtype=dtype)
                            for g in generator])
    return sampler(tuple(shape), generator=generator, device=device, dtype=dtype)


def embedding_lookup(table, ids):
    """Rows ``ids`` of an Embedding ``table``; a stacked (P, n, d) table
    gathers each member's (P, rows) ids from its own table."""
    if table.dim() == 3:
        return table[torch.arange(table.shape[0], device=ids.device)[:, None], ids]
    return table[ids]


def flatten_rows(x, w):
    """``x`` with its features flattened for a product with the Linear
    weight ``w``: (rows, -1), or (P, rows, -1) for a stacked (P, in, out)."""
    return x.reshape(*x.shape[: w.dim() - 1], -1)


def linear_apply(params, x):
    """``x @ w + b`` with ``w`` stored (in, out), or a member axis in front
    of both (one batched product, the bias broadcast over the rows). A
    reduced-precision weight casts ``x`` to its dtype and the product is
    taken in fp32 (module docstring); the result is fp32 either way."""
    if _SHARD[0] is not None and x.dim() == 2:
        return _SHARD[0].linear(params, x)
    return linear_plain(params, x)


def linear_plain(params, x):
    """`linear_apply` without a parallel context."""
    w, b = params["w"], params["b"]
    if w.dim() == 3:
        b = b.unsqueeze(-2)
    if w.dtype == torch.float32:
        return x @ w + b
    x = x.to(w.dtype)
    return x.to(torch.float32) @ w.to(torch.float32) + b


def resolve_compute_dtype(compute_dtype):
    """Map a ``Config.compute_dtype`` (or ``moments_dtype``) string, or a
    torch dtype, to a torch dtype; anything else raises."""
    if compute_dtype in ("float32", "fp32", None, torch.float32):
        return torch.float32
    if compute_dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(
        f"unsupported compute_dtype {compute_dtype!r}; valid: 'float32' (default), 'bfloat16'"
    )


def cast_matmul_params(params, dtype, members: bool = False):
    """Cast every 2-D leaf of a params tree (Linear weights, Embedding
    tables; 3-D with ``members``, the stacked ones) to ``dtype``; the other
    leaves (biases, BatchNorm gamma/beta) stay fp32. ``params`` itself when
    ``dtype`` is fp32. Differentiable: the gradient of a cast leaf comes
    back in the master's dtype."""
    if dtype == torch.float32:
        return params
    if isinstance(params, dict):
        return {k: cast_matmul_params(v, dtype, members) for k, v in params.items()}
    return params.to(dtype) if params.dim() == 2 + members else params


class RowMask(NamedTuple):
    """The valid rows of a padded batch, a prefix of each member's rows:
    ``valid`` bool (rows,) or (P, rows) on the device, and ``counts`` their
    number a member on the host (an int without a member axis)."""

    valid: torch.Tensor
    counts: Union[int, Tuple[int, ...]]


def mask_tensor(row_mask):
    """The bool tensor of a ``row_mask`` (a tensor or a `RowMask`)."""
    return row_mask.valid if isinstance(row_mask, RowMask) else row_mask


def mask_counts(row_mask):
    """The valid rows a member of a ``row_mask`` whose valid rows are a
    prefix: a `RowMask`'s host counts, or a bool tensor's, read back from
    its device once (a mask that is not a prefix raises)."""
    if isinstance(row_mask, RowMask):
        return row_mask.counts
    counts = row_mask.sum(-1)
    prefix = torch.arange(row_mask.shape[-1], device=row_mask.device) < counts.unsqueeze(-1)
    if not torch.equal(prefix, row_mask.bool()):
        raise ValueError("row_mask's valid rows must be a prefix of each member's rows")
    return tuple(counts.tolist()) if counts.dim() else int(counts)


def batchnorm_apply(params, state, x, *, train: bool, row_mask=None):
    """BatchNorm1d forward: returns (y, new_state). Train mode normalises
    with the biased batch statistics (over the row axis, -2) and moves the
    running mean and the UNBIASED running variance by momentum 0.1; eval
    mode uses the running statistics and returns ``state`` unchanged.
    ``row_mask`` restricts the train-mode statistics to the valid rows
    (module docstring); eval mode ignores it."""
    if _SHARD[0] is not None and x.dim() == 2:
        if row_mask is not None:
            raise ValueError("row_mask does not compose with intra-run data sharding")
        return _SHARD[0].batchnorm(params, state, x, train)
    return batchnorm_plain(params, state, x, train, row_mask)


def batchnorm_plain(params, state, x, train: bool, row_mask=None):
    """`batchnorm_apply` without a parallel context."""
    if train:
        n = x.shape[-2]
        if row_mask is None:
            if n <= 1:
                raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {n}")
            mean = x.mean(-2)
            var = torch.square(x - _rows(mean)).mean(-2)  # biased, used to normalise
            unbiased = var * (n / (n - 1))
        else:
            mean, var, unbiased = _masked_moments(x, mask_tensor(row_mask))
        new_state = {
            "mean": (1.0 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1.0 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = ((x - _rows(mean)) * _rows(torch.rsqrt(var + BN_EPS)) * _rows(params["gamma"])
         + _rows(params["beta"]))
    return y, new_state


def _masked_moments(x, valid):
    """(mean, biased var, unbiased var) of ``x``'s valid rows, each member's
    own. Row 0 always counts (an all-masked batch, a member's inactive
    trailing batch, gives finite numbers that the trainer discards). A
    member whose rows are all valid takes the unmasked ``mean(-2)``, its
    bits; the others the sum of the ``where``-zeroed rows over their count,
    the JAX package's arithmetic. The unbiased factor n/(n - 1) of the valid
    count n is formed in float64 and rounded once, as a Python float is (0
    when no row is valid, as in the JAX package)."""
    n = x.shape[-2]
    first = torch.arange(n, device=valid.device) == 0
    safe = (valid | first).unsqueeze(-1)
    count = safe.sum(-2, dtype=x.dtype)
    full = count == n

    def mean_of(t):
        t = torch.where(safe, t, 0.0)
        return torch.where(full, t.mean(-2), t.sum(-2) / count)

    mean = mean_of(x)
    var = mean_of(torch.square(x - _rows(mean)))
    n_valid = valid.sum(-1, dtype=torch.float64)
    unbiased = var * (n_valid / torch.clamp(n_valid - 1.0, min=1.0)).to(x.dtype).unsqueeze(-1)
    return mean, var, unbiased


def layernorm_apply(params, x):
    """LayerNorm over the last axis (``nn.LayerNorm``): the row's mean and
    biased variance, eps 1e-5, then γ and β; with a member axis, γ and β
    are (P, features) and broadcast over each member's rows."""
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    gamma, beta = params["gamma"], params["beta"]
    if x.dim() == 3:
        gamma, beta = _rows(gamma), _rows(beta)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * gamma + beta


def _rows(t):
    """A per-feature statistic, (features,) or (P, features), broadcast over
    the row axis."""
    return t.unsqueeze(-2)


def dropout_apply(x, rate: float, *, train: bool, mask=None, generator=None):
    """Inverted dropout (``torch.nn.Dropout``): ``x * mask / (1 - rate)``
    with a {0, 1} ``mask`` that is injected or drawn from ``generator`` (a
    list of them for a member axis: `draw`), keep with probability
    1 - rate. The identity in eval mode."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = (draw(torch.rand, x.shape, generator, x.device) < keep).to(x.dtype)
    return x * mask / keep
