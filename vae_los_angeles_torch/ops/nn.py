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


def linear_apply(params, x):
    """``x @ w + b`` with ``w`` stored (in, out). A reduced-precision weight
    casts ``x`` to its dtype and the product is taken in fp32 (module
    docstring); the result is fp32 either way."""
    w = params["w"]
    if w.dtype == torch.float32:
        return x @ w + params["b"]
    x = x.to(w.dtype)
    return x.to(torch.float32) @ w.to(torch.float32) + params["b"]


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


def cast_matmul_params(params, dtype):
    """Cast every 2-D leaf of a params tree (Linear weights, Embedding
    tables) to ``dtype``; 1-D leaves (biases, BatchNorm gamma/beta) stay
    fp32. ``params`` itself when ``dtype`` is fp32. Differentiable: the
    gradient of a cast leaf comes back in the master's dtype."""
    if dtype == torch.float32:
        return params
    if isinstance(params, dict):
        return {k: cast_matmul_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.dim() == 2 else params


def batchnorm_apply(params, state, x, *, train: bool):
    """BatchNorm1d forward: returns (y, new_state). Train mode normalises
    with the biased batch statistics and moves the running mean and the
    UNBIASED running variance by momentum 0.1; eval mode uses the running
    statistics and returns ``state`` unchanged."""
    if train:
        n = x.shape[0]
        if n <= 1:
            raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {n}")
        mean = x.mean(0)
        var = torch.square(x - mean).mean(0)  # biased, used to normalise
        new_state = {
            "mean": (1.0 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1.0 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * var * (n / (n - 1)),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + BN_EPS) * params["gamma"] + params["beta"]
    return y, new_state


def dropout_apply(x, rate: float, *, train: bool, mask=None, generator=None):
    """Inverted dropout (``torch.nn.Dropout``): ``x * mask / (1 - rate)``
    with a {0, 1} ``mask`` that is injected or drawn from ``generator``
    (keep with probability 1 - rate). The identity in eval mode."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = (torch.rand(x.shape, generator=generator, device=x.device) < keep).to(x.dtype)
    return x * mask / keep
