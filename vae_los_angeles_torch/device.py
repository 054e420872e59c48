"""The port's one device and precision policy.

  * Every tensor is float32, except where the caller asks for bfloat16
    (``Config.compute_dtype`` or ``moments_dtype``): then the 2-D weights of
    a forward or the optimizer's stored moments are bf16, and every product
    and sum is still taken in fp32.
  * TF32 is off for matrix products and for cuDNN. A float32 product on an
    H100 would otherwise be free to round its inputs to TF32 (about three
    decimal digits); the reference runs with
    ``jax_default_matmul_precision=highest``, and the plain versions the
    kernels are checked against must be true fp32 too.
  * The entry points run on the card. They run on the CPU only when the
    caller asks: ``device="cpu"``, or ``Config.platform == "cpu"``
    (``DEVICE=cpu``). Without a card and without that request they raise
    (`require_cuda`); nothing falls back.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """CUDA device 0, or a RuntimeError saying why there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}); "
            "this path runs on an NVIDIA GPU unless asked for the CPU "
            "(device='cpu' or DEVICE=cpu)"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None, cfg=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, the CPU
    when ``cfg.platform`` is "cpu", else the card (`require_cuda`)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            require_cuda()
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        return device
    if cfg is not None and (cfg.platform or "").lower() == "cpu":
        return torch.device("cpu")
    return require_cuda()
