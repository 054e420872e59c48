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
  * Under a process group (``parallel.comm``) a rank's card is
    ``cuda:LOCAL_RANK``, or ``cuda:0`` for every rank when the ranks share
    one card by request (`share_card`; several gloo ranks on one card).
    Without a card a rank raises like any other caller.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


_SHARED_CARD = {"on": False}


def share_card(on: bool):
    """Put every rank of the process group on card 0 (`rank_device`)."""
    _SHARED_CARD["on"] = bool(on)


def _no_card():
    return RuntimeError(
        "no CUDA device: torch.cuda.is_available() is False "
        f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}); "
        "this path runs on an NVIDIA GPU unless asked for the CPU "
        "(device='cpu' or DEVICE=cpu)"
    )


def rank_device(local_rank: int) -> torch.device:
    """The card of the rank with ``local_rank``: ``cuda:local_rank``, or
    ``cuda:0`` when the ranks share one card; a RuntimeError when there is no such card."""
    if not torch.cuda.is_available():
        raise _no_card()
    index = 0 if _SHARED_CARD["on"] else int(local_rank)
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"LOCAL_RANK={local_rank} needs cuda:{index}, but {count} CUDA "
                           "device(s) are visible (share one card with comm.init(share_card=True))")
    return torch.device("cuda", index)


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def require_cuda() -> torch.device:
    """The caller's card, or a RuntimeError saying why there is none: CUDA
    device 0, or under a process group the rank's card (`rank_device`)."""
    if not torch.cuda.is_available():
        raise _no_card()
    if _in_group():
        return rank_device(int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", 0)


def resolve_device(device=None, cfg=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, the CPU
    when ``cfg.platform`` is "cpu", else the card (`require_cuda`)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            require_cuda()
            if device.index is None:
                device = (require_cuda() if _in_group()
                          else torch.device("cuda", torch.cuda.current_device()))
        return device
    if cfg is not None and (cfg.platform or "").lower() == "cpu":
        return torch.device("cpu")
    return require_cuda()
