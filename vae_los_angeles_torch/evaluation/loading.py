"""Model loading for serving (counterpart of
``vae_los_angeles_tpu/evaluation/loading.py``).

Rebuilds a model from the run-id + checkpoint protocol and wraps it in a
callable with the reference's forward signature:

    model = load_rna2dna()          # via latest_rna2dna_run_id.txt
    recon, mu, logvar = model(rna=x, site=s)   # numpy in, numpy out
    model = load_multimodal()       # via latest_multivae_run_id.txt
    out_a, out_b, out_c, mu, logvar = model(a=x)   # any subset of a, b, site

A directional model routes as the JAX loader does. With ``USE_PALLAS``
(``cfg.use_pallas``) and fp32 compute its weights are also BN-folded and
staged on the device once, and a call with an input row is one launch of
the fused kernel (``ops.kernels.fused_vae``); every other call (no
``USE_PALLAS``, or site-only imputation, ``rna=None``/``dna=None``) serves
through the plain eval forward (``models.directional_vae``). A call the
fused kernel refuses (a DNA width it cannot stage in shared memory) raises;
it never falls back to the plain forward. The tri-modal model serves through
its plain eval-mode forward (``models.vae.multimodal_vae_apply``, BatchNorm
on its running statistics): the JAX loader runs no Pallas kernel there
either. The loaders run on the card and raise without one, unless the
caller asks for the CPU (``device="cpu"`` or ``DEVICE=cpu``), where the
kernels' plain versions serve.

With ``COMPUTE_DTYPE=bfloat16`` (``cfg.compute_dtype``) every model serves
through its plain eval forward with its 2-D weights cast to bf16 once at
load (``ops.nn.cast_matmul_params``; fp32 products, fp32 biases and
BatchNorm), as the JAX loader serves bf16 through its XLA path; the
directional kernels are fp32 programs, and with ``USE_PALLAS`` set the
loader says so.

Under a process group of two or more ranks (``vmap_meta.population_mesh``)
every loaded model serves its rows sharded, as the JAX loader does on
several devices: every rank calls with the whole cohort, serves its
contiguous rows (through the fused kernel under ``USE_PALLAS``, with the
rank's first row as the kernel's ``row0``, so the drawn noise is the
whole call's), and every rank returns the whole result.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.models.directional_vae import dna2rna_vae_apply, rna2dna_vae_apply
from vae_los_angeles_torch.models.vae import multimodal_vae_apply
from vae_los_angeles_torch.ops.kernels.fused_vae import FusedDNA2RNA, FusedRNA2DNA
from vae_los_angeles_torch.ops.nn import cast_matmul_params, resolve_compute_dtype, sharded
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.parallel.sharding import ShardContext
from vae_los_angeles_torch.parallel.vmap_meta import population_mesh
from vae_los_angeles_torch.training import checkpoint
from vae_los_angeles_torch.utils.weights import tree_from_numpy


def _check_sites(site, n_sites):
    site = np.asarray(site)
    if site.size and (site.min() < 0 or site.max() >= n_sites):
        raise ValueError(f"site labels must lie in [0, {n_sites})")
    return site.astype(np.int64)


def _place(params, state, device, cfg):
    """(params with 2-D leaves in the serving dtype, state) on ``device``."""
    dtype = resolve_compute_dtype(cfg.compute_dtype if cfg is not None else None)
    return (cast_matmul_params(tree_from_numpy(params, device), dtype),
            tree_from_numpy(state, device))


def _seed_of(generator: Optional[torch.Generator]) -> int:
    """A seed drawn from ``generator``; without one every call uses the same
    fixed seed, as the JAX loader's fixed key does."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))


_PLAIN_APPLY = {"rna": rna2dna_vae_apply, "dna": dna2rna_vae_apply}


class LoadedDirectionalVAE:
    """Callable over one directional VAE's weights: returns (recon, mu,
    logvar) as numpy arrays, like the reference's forward. With
    ``cfg.use_pallas`` and fp32 compute, a call with an input row is one
    launch of the fused kernel; otherwise (site-only imputation included)
    the plain eval forward serves, with bf16 weights when
    ``cfg.compute_dtype`` is bfloat16."""

    def __init__(self, fused_cls, input_kw: str, params, state, run_id=None, device=None,
                 cfg: Optional[Config] = None):
        self._kw = input_kw  # "rna" or "dna"
        self.device = resolve_device(device, cfg)
        self.run_id = run_id
        self._fused = None
        use_pallas = cfg is not None and cfg.use_pallas
        fp32 = cfg is None or resolve_compute_dtype(cfg.compute_dtype) == torch.float32
        if use_pallas and not fp32:
            print(f"COMPUTE_DTYPE={cfg.compute_dtype}: serving via the plain path (the CUDA "
                  "kernels are fp32 programs)")
        elif use_pallas:
            self._fused = fused_cls(params, state, self.device)
        self._plain = _place(params, state, self.device, cfg)
        self.n_sites = self._plain[0]["encoder_site"]["embedding"]["table"].shape[0]

    def __call__(self, site=None, generator: Optional[torch.Generator] = None, **kwargs):
        """``generator`` gives the seed of the sampled z; without one every
        call uses the same fixed seed, as the JAX loader's fixed key does.
        Without an input row the posterior is the site's alone."""
        x = kwargs.get(self._kw)
        if x is None and site is None:
            raise ValueError(f"at least one of {self._kw}/site must be provided")
        n = len(x if x is not None else site)
        mesh = population_mesh()
        lo, hi = (0, n) if mesh is None else mesh.row_range(n)
        if x is not None:
            x = torch.as_tensor(np.asarray(x, np.float32)[lo:hi]).to(self.device)
        site_t = None
        if site is not None:
            site_t = torch.as_tensor(_check_sites(site, self.n_sites)[lo:hi]).to(self.device)
        seed = _seed_of(generator)
        if self._fused is not None and x is not None:
            rows = {} if mesh is None else {"row0": lo, "rows_total": n}
            out = self._fused(x, site_t, seed=seed, **rows)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            ctx = ShardContext(mesh) if mesh is not None else None
            if ctx is not None:
                ctx.set_rows(n)
            with torch.no_grad(), (sharded(ctx) if ctx else contextlib.nullcontext()):
                res = _PLAIN_APPLY[self._kw](*self._plain, site=site_t, train=False,
                                             generator=gen, **{self._kw: x})
            out = res.recon, res.mu, res.logvar
        if mesh is not None:
            out = [comm.all_gather_rows(t, mesh.row_counts(n)) for t in out]
        return tuple(t.cpu().numpy() for t in out)


class LoadedMultiModalVAE:
    """Callable over a MultiModalVAE's weights: returns (out_a, out_b,
    out_c, mu, logvar) as numpy arrays, like the reference's forward."""

    def __init__(self, params, state, run_id=None, device=None, cfg: Optional[Config] = None):
        self.device = resolve_device(device, cfg)
        self.params, self.state = _place(params, state, self.device, cfg)
        self.n_sites = self.params["encoder_c"]["embedding"]["table"].shape[0]
        self.run_id = run_id

    def __call__(self, a=None, b=None, site=None, generator: Optional[torch.Generator] = None):
        """Any subset of RNA ``a``, DNA ``b`` and ``site``; z is sampled
        from a device generator seeded from ``generator`` (`_seed_of`)."""
        given = [t for t in (a, b, site) if t is not None]
        n = len(given[0]) if given else 0
        mesh = population_mesh()
        lo, hi = (0, n) if mesh is None else mesh.row_range(n)
        to = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32)[lo:hi]).to(self.device)
        site_t = None
        if site is not None:
            site_t = torch.as_tensor(_check_sites(site, self.n_sites)[lo:hi]).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(_seed_of(generator))
        ctx = ShardContext(mesh) if mesh is not None else None
        if ctx is not None:
            ctx.set_rows(n)
        with torch.no_grad(), (sharded(ctx) if ctx else contextlib.nullcontext()):
            out = multimodal_vae_apply(self.params, self.state, a=to(a), b=to(b), site=site_t,
                                       train=False, generator=gen)
        out = (out.out_a, out.out_b, out.out_c, out.mu, out.logvar)
        if mesh is not None:
            out = [comm.all_gather_rows(t, mesh.row_counts(n)) for t in out]
        return tuple(t.cpu().numpy() for t in out)


def _read(model_name, label, run_id, cfg, root, device):
    """(params, state, run id, device, cfg) of the named run's best
    checkpoint, or None (with a warning) when there is none."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)  # raises before any file is read
    resolve_compute_dtype(cfg.compute_dtype)  # an unknown dtype raises here too
    try:
        params, state, rid = checkpoint.load_best(model_name, run_id, cfg.checkpoint_dir, root)
    except FileNotFoundError as e:
        print(f"Warning: {e}")
        return None
    print(f"✓ {label} model loaded successfully (run {rid})")
    return params, state, rid, device, cfg


def _load(model_name, label, fused_cls, input_kw, run_id, cfg, root, device):
    got = _read(model_name, label, run_id, cfg, root, device)
    return None if got is None else LoadedDirectionalVAE(fused_cls, input_kw, *got)


def load_rna2dna(run_id: Optional[str] = None, cfg: Optional[Config] = None,
                 root: str = ".", device=None) -> Optional[LoadedDirectionalVAE]:
    return _load("rna2dna", "RNA2DNAVAE", FusedRNA2DNA, "rna", run_id, cfg, root, device)


def load_dna2rna(run_id: Optional[str] = None, cfg: Optional[Config] = None,
                 root: str = ".", device=None) -> Optional[LoadedDirectionalVAE]:
    return _load("dna2rna", "DNA2RNAVAE", FusedDNA2RNA, "dna", run_id, cfg, root, device)


def load_multimodal(run_id: Optional[str] = None, cfg: Optional[Config] = None,
                    root: str = ".", device=None) -> Optional[LoadedMultiModalVAE]:
    got = _read("multivae", "MultiModalVAE", run_id, cfg, root, device)
    return None if got is None else LoadedMultiModalVAE(*got)
