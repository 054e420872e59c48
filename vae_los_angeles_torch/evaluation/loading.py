"""Model loading for serving (counterpart of
``vae_los_angeles_tpu/evaluation/loading.py``).

Rebuilds a directional VAE from the run-id + checkpoint protocol and wraps it
in a callable with the reference's forward signature:

    model = load_rna2dna()          # via latest_rna2dna_run_id.txt
    recon, mu, logvar = model(rna=x, site=s)   # numpy in, numpy out

At load the checkpoint's weights are BN-folded and staged on the device
once. The loaders run on the card (one launch of the fused kernel,
``ops.kernels.fused_vae``, per call) and raise without one, unless the
caller asks for the CPU (``device="cpu"`` or ``DEVICE=cpu``), where the
kernel's plain version serves.
The tri-modal loader is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.ops.kernels.fused_vae import FusedDNA2RNA, FusedRNA2DNA
from vae_los_angeles_torch.training import checkpoint


class LoadedDirectionalVAE:
    """Callable over one directional VAE's weights: returns (recon, mu,
    logvar) as numpy arrays, like the reference's forward."""

    def __init__(self, fused_cls, input_kw: str, params, state, run_id=None, device=None,
                 cfg: Optional[Config] = None):
        self._kw = input_kw  # "rna" or "dna"
        self.device = resolve_device(device, cfg)
        self._fused = fused_cls(params, state, self.device)
        self.run_id = run_id

    def __call__(self, site=None, generator: Optional[torch.Generator] = None, **kwargs):
        """``generator`` gives the seed of the sampled z; without one every
        call uses the same fixed seed, as the JAX loader's fixed key does."""
        x = kwargs.get(self._kw)
        if x is None:
            raise ValueError(
                f"{self._kw}= is required: site-only imputation is not served by the port yet"
            )
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        site_t = None
        if site is not None:
            site = np.asarray(site)
            n_sites = self._fused.n_sites
            if site.size and (site.min() < 0 or site.max() >= n_sites):
                raise ValueError(f"site labels must lie in [0, {n_sites})")
            site_t = torch.as_tensor(site.astype(np.int64)).to(self.device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
        recon, mu, logvar = self._fused(x, site_t, seed=seed)
        return recon.cpu().numpy(), mu.cpu().numpy(), logvar.cpu().numpy()


def _load(model_name, label, fused_cls, input_kw, run_id, cfg, root, device):
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)  # raises before any file is read
    if cfg.compute_dtype not in ("float32", "fp32"):
        raise ValueError(
            f"COMPUTE_DTYPE={cfg.compute_dtype}: the port serves fp32 only"
        )
    try:
        params, state, rid = checkpoint.load_best(model_name, run_id, cfg.checkpoint_dir, root)
    except FileNotFoundError as e:
        print(f"Warning: {e}")
        return None
    print(f"✓ {label} model loaded successfully (run {rid})")
    return LoadedDirectionalVAE(fused_cls, input_kw, params, state, rid, device, cfg)


def load_rna2dna(run_id: Optional[str] = None, cfg: Optional[Config] = None,
                 root: str = ".", device=None) -> Optional[LoadedDirectionalVAE]:
    return _load("rna2dna", "RNA2DNAVAE", FusedRNA2DNA, "rna", run_id, cfg, root, device)


def load_dna2rna(run_id: Optional[str] = None, cfg: Optional[Config] = None,
                 root: str = ".", device=None) -> Optional[LoadedDirectionalVAE]:
    return _load("dna2rna", "DNA2RNAVAE", FusedDNA2RNA, "dna", run_id, cfg, root, device)
