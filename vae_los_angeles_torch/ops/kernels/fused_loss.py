"""The RNA→DNA loss with its closed-form backward (counterpart of
``vae_los_angeles_tpu/ops/pallas/fused_loss.py``).

``rna2dna_loss_fused(logits, dna, mu, logvar, beta)`` is BCE-with-logits sum
+ beta * KLD, a ``torch.autograd.Function`` whose backward is closed form:

    dlogits = (sigmoid(logits) - dna) * g,   dmu = beta * mu * g,
    dlogvar = -beta/2 * (1 - e^logvar) * g,  dbeta = KLD * g,

and no gradient for ``dna``: zeros where ``dna`` requires grad, as the JAX
``custom_vjp`` returns, else None (no ``dna``-sized tensor is made). beta
may be a float or a 0-d tensor (a tensor that requires grad gets dbeta).

  * CUDA tensors: the forward is one launch of ``rna2dna_loss_forward`` and
    the backward one of ``rna2dna_loss_backward`` (``csrc/fused_loss.cu``,
    built at first use). The forward's workspace (its partial sums and the
    ticket of its last block) is made once a (device, stream), zeroed, and
    kept. A tensor the kernels do not take raises; nothing falls back.
  * CPU tensors: the plain versions beside them, `loss_forward_reference`
    (``ops.losses.rna2dna_loss``) and `loss_backward_reference`.

``launches`` counts the kernel launches of each entry, so a run can show
that its path went through them.

`rna2dna_loss_fused_members` is the fold populations' loss: one call of the
pair a member, on that member's contiguous (rows, dna) slice, the shapes the
kernels are held at. ``RNA2DNALoss`` is an old-style autograd Function and
its CUDA entries have no batching rule, so it is never put under
``torch.func.vmap``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_los_angeles_torch.ops import losses
from vae_los_angeles_torch.ops.kernels._build import build

launches = {"rna2dna_loss_forward": 0, "rna2dna_loss_backward": 0}
_workspaces = {}  # (device index, stream) -> the forward's workspace


def loss_forward_reference(logits, dna, mu, logvar, beta):
    """Plain version of the forward kernel: returns (loss, kld)."""
    total, aux = losses.rna2dna_loss(logits, dna, mu, logvar, beta)
    return total, aux["kld"]


def loss_backward_reference(logits, dna, mu, logvar, beta, g):
    """Plain version of the backward kernel: (dlogits, dmu, dlogvar)."""
    return ((torch.sigmoid(logits) - dna) * g, beta * mu * g,
            -0.5 * beta * (1.0 - torch.exp(logvar)) * g)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build("fused_loss").lib
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.rna2dna_loss_forward.argtypes = [p, p, n, p, p, n, p, p, p, p]
    lib.rna2dna_loss_forward.restype = ctypes.c_int
    lib.rna2dna_loss_backward.argtypes = [p, p, n, p, p, n, p, p, p, p, p, p]
    lib.rna2dna_loss_backward.restype = ctypes.c_int
    lib.rna2dna_loss_workspace_floats.argtypes = []  # for the current device
    lib.rna2dna_loss_workspace_floats.restype = ctypes.c_int
    lib.fused_loss_error_string.argtypes = [ctypes.c_int]
    lib.fused_loss_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, entry):
    if err != 0:
        msg = lib.fused_loss_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err} ({msg})")


def _check(logits, dna, mu, logvar, beta):
    for name, t in (("logits", logits), ("dna", dna), ("mu", mu), ("logvar", logvar),
                    ("beta", beta)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on {logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dna.shape != logits.shape:
        raise ValueError(f"dna {tuple(dna.shape)} and logits {tuple(logits.shape)} differ")
    if mu.shape != logvar.shape:
        raise ValueError(f"mu {tuple(mu.shape)} and logvar {tuple(logvar.shape)} differ")
    if beta.numel() != 1:
        raise ValueError("beta must hold one value")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {logits.device}")


def _workspace(lib, device, stream):
    """The forward's workspace on ``stream``: made and zeroed at its first
    use, then kept; each launch leaves its ticket at 0 again. One a stream,
    so that two streams never share a ticket. Call with ``device`` current."""
    work = _workspaces.get((device.index, stream))
    if work is None:
        floats = lib.rna2dna_loss_workspace_floats()
        if floats <= 0:
            _raise_on(lib, -floats, "rna2dna_loss_workspace_floats")
        work = torch.zeros(floats, device=device, dtype=torch.float32)
        _workspaces[(device.index, stream)] = work
    return work


def _empty_like_aligned(x):
    """An empty tensor like ``x`` at the same offset from a 16-byte boundary
    (the allocator's blocks start on one), so that the backward's float4 route
    takes ``x`` and its gradient together."""
    off = x.data_ptr() % 16 // x.element_size()
    if off == 0:
        return torch.empty_like(x)
    return torch.empty(x.numel() + off, device=x.device, dtype=x.dtype)[off:].view(x.shape)


def _forward(logits, dna, mu, logvar, beta):
    if logits.device.type == "cpu":
        return loss_forward_reference(logits, dna, mu, logvar, beta.reshape(()))
    lib = _library()
    out = torch.empty(2, device=logits.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        work = _workspace(lib, logits.device, stream)
        err = lib.rna2dna_loss_forward(logits.data_ptr(), dna.data_ptr(), logits.numel(),
                                       mu.data_ptr(), logvar.data_ptr(), mu.numel(),
                                       beta.data_ptr(), out.data_ptr(), work.data_ptr(), stream)
    _raise_on(lib, err, "rna2dna_loss_forward")
    launches["rna2dna_loss_forward"] += 1
    return out[0], out[1]


def _backward(logits, dna, mu, logvar, beta, g):
    if logits.device.type == "cpu":
        return loss_backward_reference(logits, dna, mu, logvar, beta.reshape(()), g)
    lib = _library()
    g = g.detach().to(torch.float32).contiguous()
    dlogits = _empty_like_aligned(logits)
    dmu, dlv = torch.empty_like(mu), torch.empty_like(logvar)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        err = lib.rna2dna_loss_backward(logits.data_ptr(), dna.data_ptr(), logits.numel(),
                                        mu.data_ptr(), logvar.data_ptr(), mu.numel(),
                                        beta.data_ptr(), g.data_ptr(), dlogits.data_ptr(),
                                        dmu.data_ptr(), dlv.data_ptr(), stream)
    _raise_on(lib, err, "rna2dna_loss_backward")
    launches["rna2dna_loss_backward"] += 1
    return dlogits, dmu, dlv


class RNA2DNALoss(torch.autograd.Function):
    """BCE-with-logits sum + beta * KLD with the closed-form backward."""

    @staticmethod
    def forward(ctx, logits, dna, mu, logvar, beta):
        loss, kld = _forward(logits, dna, mu, logvar, beta)
        ctx.save_for_backward(logits, dna, mu, logvar, beta, kld)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, dna, mu, logvar, beta, kld = ctx.saved_tensors
        dlogits, dmu, dlv = _backward(logits, dna, mu, logvar, beta, g)
        ddna = torch.zeros_like(dna) if ctx.needs_input_grad[1] else None
        dbeta = (kld * g).reshape(beta.shape) if ctx.needs_input_grad[4] else None
        return dlogits, ddna, dmu, dlv, dbeta


def rna2dna_loss_fused(logits, dna, mu, logvar, beta=1e-3):
    """BCE-with-logits sum + beta * KLD (0-d tensor), differentiable in
    logits, mu, logvar and a tensor beta."""
    if not isinstance(beta, torch.Tensor):
        # a fill, not a copy from the host (which waits for the card's queue to drain)
        beta = torch.full((), float(beta), dtype=torch.float32, device=logits.device)
    _check(logits, dna, mu, logvar, beta)
    return RNA2DNALoss.apply(logits, dna, mu, logvar, beta)


def rna2dna_loss_fused_members(logits, dna, mu, logvar, beta=1e-3):
    """(P,) losses of a member axis: `rna2dna_loss_fused` of each member's
    (rows, dna) slice; ``beta`` a float, a 0-d tensor or one value a
    member."""
    if isinstance(beta, torch.Tensor) and beta.dim() == 1:
        betas = beta.unbind(0)
    else:
        betas = [beta] * logits.shape[0]
    return torch.stack([rna2dna_loss_fused(*member, b) for *member, b in zip(
        logits.unbind(0), dna.unbind(0), mu.unbind(0), logvar.unbind(0), betas)])
