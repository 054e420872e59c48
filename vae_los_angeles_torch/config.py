"""Training and model configuration (counterpart of
``vae_los_angeles_tpu/config.py``).

The port keeps its own copy: it imports nothing of the JAX package. The
fields, their defaults and the environment overrides are the JAX package's,
field for field (``tests/test_torch_config.py`` holds the two against each
other). Defaults mirror the reference's static ``Config`` class
(``src/config.py:7-42``); every field can be overridden by the upper-case
name of the field in the environment, and ``DEVICE`` sets ``platform``.

In the port ``platform`` is the device policy's one switch
(``vae_los_angeles_torch.device.resolve_device``): ``DEVICE=cpu`` runs the
entry points on the CPU; anything else runs them on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default, cast):
    raw = os.getenv(name)
    if raw is None:
        return default
    return cast(raw)


@dataclasses.dataclass
class Config:
    """Hyperparameters for model architecture, training and evaluation."""

    # Model architecture (reference src/config.py:11-13)
    input_dim_a: int = 1177  # RNA expression dimension
    input_dim_b: int = 1211  # DNA methylation dimension
    latent_dim: int = 20
    embed_dim: int = 32  # site-embedding width (reference encoders.py:51)

    # Training parameters (reference src/config.py:16-19)
    batch_size: int = 32
    num_epochs: int = 200
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5

    # Loss parameters (reference src/config.py:22-24)
    beta_start: float = 1e-3  # KL weight after warmup
    beta_warmup_epochs: int = 50
    gamma: float = 1.0  # classification loss weight

    # Early stopping (reference src/config.py:27)
    patience: int = 15

    # LR scheduler: ReduceLROnPlateau semantics (reference src/config.py:30-31)
    lr_scheduler_factor: float = 0.5
    lr_scheduler_patience: int = 5

    # Paths (reference src/config.py:34-35)
    checkpoint_dir: str = "checkpoints"
    best_model_name: str = "best_multivae"
    data_dir: str = "data"
    plots_dir: str = "plots"

    # Data split (reference src/config.py:41-42)
    train_test_split: float = 0.2
    random_seed: int = 42

    # Regularisation inside encoders (reference encoders.py:16)
    dropout_rate: float = 0.1

    # Accelerator knobs (no reference equivalent)
    use_pallas: bool = False  # the hand-written kernels (the port's name for it)
    platform: Optional[str] = None  # "cpu" runs on the CPU; else the card
    # Mixed precision of the plain training and serving paths: "float32"
    # (the reference's fp32 recipe) or "bfloat16" (2-D parameters cast to
    # bf16 inside the loss, fp32 products, fp32 masters/BN/losses/optimizer;
    # ops.nn.cast_matmul_params).
    compute_dtype: str = "float32"  # env override: COMPUTE_DTYPE=bfloat16
    # Optimizer moment STORAGE dtype: "float32" or "bfloat16" (updates still
    # computed in fp32; ops.optim.adamw_init).
    moments_dtype: str = "float32"  # env override: MOMENTS_DTYPE=bfloat16
    # "adamw" (torch-parity recipe) or "adafactor" (factored second moments,
    # no first moment; ops.optim.adafactor_init). The CUDA kernels are fp32
    # AdamW programs, so the three knobs above train on the plain path.
    optimizer: str = "adamw"  # env override: OPTIMIZER=adafactor
    debug_nans: bool = False  # env override: DEBUG_NANS=1

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build a config applying env-var overrides then keyword overrides.

        Env names match the reference's (INPUT_DIM_A, INPUT_DIM_B, LATENT_DIM,
        DEVICE) plus uppercase versions of every other field.
        """
        cfg = cls()
        field_casts = {
            f.name: (int if f.type == "int" else float if f.type == "float" else str)
            for f in dataclasses.fields(cls)
            if f.type in ("int", "float", "str")
        }
        values = {}
        for name, cast in field_casts.items():
            values[name] = _env(name.upper(), getattr(cfg, name), cast)
        for bool_field, env_name in (("use_pallas", "USE_PALLAS"),
                                     ("debug_nans", "DEBUG_NANS")):
            raw = os.getenv(env_name)
            if raw is not None:
                values[bool_field] = raw.lower() in ("1", "true", "yes")
        device = os.getenv("DEVICE")
        if device is not None:
            values["platform"] = device
        values.update(overrides)
        return cls(**values)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


__all__ = ["Config"]
