"""vae_los_angeles_torch — the PyTorch/CUDA port of ``vae_los_angeles_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is found at the same place:

  * ``config`` — the port's own copy of the JAX package's ``Config``;
  * ``device`` holds the one device/precision policy (fp32, TF32 off, the
    card unless the CPU is asked for);
  * ``data`` — synthetic generator, split protocol, dataset, the
    pandas-free artifacts (``data.artifacts``) and the data preparation;
  * ``ops.nn`` / ``ops.losses`` / ``ops.optim`` / ``ops.metrics`` — layers,
    the RNA→DNA loss, AdamW and the scheduler state machines, metrics;
  * ``ops.kernels`` — the hand-written CUDA kernels (``csrc/``) with their
    plain versions: the directional VAEs' eval forwards (``fused_vae``), the
    RNA→DNA train step and whole epoch (``fused_train``, ``fused_epoch``)
    and the loss with its backward (``fused_loss``);
  * ``models`` — encoders, decoders and the directional VAEs as
    ``nn.Module``s with the reference's state_dict key names, and the
    functional train-mode RNA2DNAVAE;
  * ``utils.weights`` — the JAX-pytree ↔ state_dict and carry bridge;
    ``utils.torch_import`` the reference ``.pt`` import/export,
    ``utils.profiling`` the timers and the profiler trace, ``utils.native``
    the data preparation's C++ pivot;
  * ``parallel`` — the CV fold and HPO trial populations (``vmap_meta``)
    and the multi-device port: the process group and its collectives
    (``comm``, one process a device), the ("data", "model") mesh with data-
    and tensor-parallel training (``sharding``), the row-sharded evaluation
    programs (``sharded_eval``) and the dry run (``dryrun``);
  * ``training`` — the ``.npz`` + run-id + resume protocol, shared with the
    JAX package byte for byte; the tasks, the engine and the CLI;
  * ``evaluation`` — model loading, the directional imputation comparison
    (the serving path), evaluation, the kNN comparison, the cross-modality
    CV and the hyperparameter search.

It imports ``torch`` and numpy, never ``jax`` and nothing of the JAX package.
"""

__version__ = "0.1.0"

from vae_los_angeles_torch.config import Config  # noqa: F401
