"""One train step of the wide sigmoid/BCE output layer (counterpart of
``vae_los_angeles_tpu/ops/pallas/fused_wide.py``): the whole-methylome-width
regime's head, DecoderB's d_in x D output layer at D = 450,000.

``fused_wide_output_step(h, target, w, b, m_w, v_w, m_b, v_b, step, lr,
weight_decay)`` returns ``(new_w, new_b, new_m_w, new_v_w, new_m_b, new_v_b,
new_step, dh, loss_sum)`` with the JAX function's semantics:

  * logits = h @ w + b; loss_sum = Σ max(l, 0) − l·t + log1p(e^−|l|);
  * dW = hᵀ·dy, db = Σ_rows dy, dh = dy·Wᵀ with dy = sigmoid(l) − t and the
    PRE-update W;
  * AdamW in torch order (decay first, bias correction at step + 1), as
    ``ops.optim.adamw_update``; ``new_step`` = step + 1.

  * CUDA tensors: ``csrc/fused_wide.cu`` (built at first use). Up to 32
    rows and d_in up to 512 (the wide path's batch): two launches, one
    persistent sweep that reads W once and forms dh in it, and the
    fixed-order sum of the blocks' dh and loss partials. More rows: three
    launches, the column sweep, the split-over-D dh partials and their sum,
    with an n x D scratch for dy. The new W, m and v are written into
    tensors the wrapper allocates (as JAX returns new arrays), not in place:
    the three-launch design reads the pre-update W after its sweep has
    written the update, so in place is not safe for every batch the wrapper
    takes. The inputs are neither copied nor changed, so at 512 x 450,000 a
    call holds three new 0.92 GB tensors beside the old ones. A tensor the
    kernel does not take raises; nothing falls back.
  * CPU tensors: `fused_wide_output_step_reference`, autograd of the same
    loss plus ``ops.optim.adamw_update``.

``lr`` and ``weight_decay`` may be floats or 0-d tensors; ``step`` an int or
a 0-d int tensor. ``launches`` counts the kernel's calls, so a run can show
that its path went through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_los_angeles_torch.ops import losses, optim
from vae_los_angeles_torch.ops.kernels._build import build

launches = {"fused_wide_output_step": 0}


def _step_tensor(step, device):
    return torch.as_tensor(step, dtype=torch.int32).to(device).reshape(())


def fused_wide_output_step_reference(h, target, w, b, m_w, v_w, m_b, v_b, step, lr,
                                     weight_decay):
    """Plain version: autograd of the BCE sum and ``optim.adamw_update``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (w, b, h)]
        loss = losses.bce_with_logits_sum(leaves[2] @ leaves[0] + leaves[1], target)
        gw, gb, dh = torch.autograd.grad(loss, leaves)
    opt = {"step": _step_tensor(step, w.device), "m": {"w": m_w, "b": m_b},
           "v": {"w": v_w, "b": v_b}}
    new, new_opt = optim.adamw_update({"w": w, "b": b}, {"w": gw, "b": gb}, opt, lr,
                                      weight_decay)
    return (new["w"], new["b"], new_opt["m"]["w"], new_opt["v"]["w"], new_opt["m"]["b"],
            new_opt["v"]["b"], new_opt["step"], dh, loss.detach())


@functools.lru_cache(maxsize=None)
def _library():
    lib = build("fused_wide").lib
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_wide_output_step.argtypes = [p] * 9 + [i, i, n] + [p] * 10
    lib.fused_wide_output_step.restype = ctypes.c_int
    lib.fused_wide_workspace_floats.argtypes = [i, i, n]
    lib.fused_wide_workspace_floats.restype = ctypes.c_longlong
    lib.fused_wide_max_rows.argtypes = []
    lib.fused_wide_max_rows.restype = ctypes.c_int
    lib.fused_wide_error_string.argtypes = [ctypes.c_int]
    lib.fused_wide_error_string.restype = ctypes.c_char_p
    return lib


def _check(h, target, w, b, m_w, v_w, m_b, v_b):
    named = (("h", h), ("target", target), ("w", w), ("b", b), ("m_w", m_w), ("v_w", v_w),
             ("m_b", m_b), ("v_b", v_b))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} (the kernel is an fp32 "
                            "AdamW program)")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the wrapper copies no state)")
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError("h must be (n, d_in) and w (d_in, D)")
    n, d_in = h.shape
    big = w.shape[1]
    if w.shape[0] != d_in or target.shape != (n, big):
        raise ValueError(f"shapes differ: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"target {tuple(target.shape)}")
    for name, t in (("m_w", m_w), ("v_w", v_w)):
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from w {tuple(w.shape)}")
    for name, t in (("b", b), ("m_b", m_b), ("v_b", v_b)):
        if t.shape != (big,):
            raise ValueError(f"{name} must be ({big},), got {tuple(t.shape)}")
    if n < 1:
        raise ValueError("h has no rows")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {w.device}")


def fused_wide_output_step(h, target, w, b, m_w, v_w, m_b, v_b, step, lr, weight_decay):
    """One fused train step of the wide output layer (module docstring)."""
    _check(h, target, w, b, m_w, v_w, m_b, v_b)
    if w.device.type == "cpu":
        return fused_wide_output_step_reference(h, target, w, b, m_w, v_w, m_b, v_b, step, lr,
                                                weight_decay)
    lib = _library()
    n, d_in = h.shape
    big = w.shape[1]
    if n > lib.fused_wide_max_rows():
        raise ValueError(f"the wide kernel takes at most {lib.fused_wide_max_rows()} rows a "
                         f"call, got {n}")
    dev = w.device
    new_step, bc1, bc2 = optim.bias_corrections(_step_tensor(step, dev))
    def f32(x):  # a number goes in as a fill: a copy from the host would wait for the card
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32).reshape(())
        return torch.full((), x, dtype=torch.float32, device=dev)

    # as adamw_update forms them: lr and 1 - lr·wd in the caller's types, then fp32
    scal = torch.stack([bc1, bc2, f32(lr), f32(1.0 - lr * weight_decay)])
    new_w, new_m_w, new_v_w = (torch.empty_like(w) for _ in range(3))
    new_b, new_m_b, new_v_b = (torch.empty_like(b) for _ in range(3))
    dh = torch.empty_like(h)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    work = torch.empty(lib.fused_wide_workspace_floats(n, d_in, big), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_wide_output_step(
            h.data_ptr(), target.data_ptr(), w.data_ptr(), b.data_ptr(), m_w.data_ptr(),
            v_w.data_ptr(), m_b.data_ptr(), v_b.data_ptr(), scal.data_ptr(), n, d_in, big,
            new_w.data_ptr(), new_b.data_ptr(), new_m_w.data_ptr(), new_v_w.data_ptr(),
            new_m_b.data_ptr(), new_v_b.data_ptr(), dh.data_ptr(), loss.data_ptr(),
            work.data_ptr(), stream)
    if err != 0:
        msg = lib.fused_wide_error_string(err).decode()
        raise RuntimeError(f"fused_wide_output_step failed to launch: CUDA error {err} ({msg})")
    launches["fused_wide_output_step"] += 1
    return new_w, new_b, new_m_w, new_v_w, new_m_b, new_v_b, new_step, dh, loss


__all__ = ["fused_wide_output_step", "fused_wide_output_step_reference", "launches"]
