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
by 1/(1 - rate), from an injected mask or an explicit ``torch.Generator``.

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
"""

from __future__ import annotations

import math

import torch
from torch import nn

BN_EPS = 1e-5  # nn.BatchNorm1d's default, as in the JAX package
BN_MOMENTUM = 0.1


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


def batchnorm_apply(params, state, x, *, train: bool):
    """BatchNorm1d forward: returns (y, new_state). Train mode normalises
    with the biased batch statistics (over the row axis, -2) and moves the
    running mean and the UNBIASED running variance by momentum 0.1; eval
    mode uses the running statistics and returns ``state`` unchanged."""
    if train:
        n = x.shape[-2]
        if n <= 1:
            raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {n}")
        mean = x.mean(-2)
        var = torch.square(x - _rows(mean)).mean(-2)  # biased, used to normalise
        new_state = {
            "mean": (1.0 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1.0 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * var * (n / (n - 1)),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = ((x - _rows(mean)) * _rows(torch.rsqrt(var + BN_EPS)) * _rows(params["gamma"])
         + _rows(params["beta"]))
    return y, new_state


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
