"""Data layer of the port: synthetic generator and artifacts, split
protocol, dataset, and the data preparation (``prepare_data``,
``prepare_dna``, ``ingest_manifest``).

Importing it pulls in numpy only; pandas is imported when a JAX-package
frame is unpickled and inside the preparation's functions.
"""

from vae_los_angeles_torch.data.dataset import MultiModalDataset  # noqa: F401
from vae_los_angeles_torch.data.splits import (  # noqa: F401
    cv_inner_split,
    kfold_indices,
    train_val_indices,
)
from vae_los_angeles_torch.data.synthetic import (  # noqa: F401
    SITE_NAMES,
    generate_synthetic_arrays,
)

__all__ = [
    "MultiModalDataset",
    "SITE_NAMES",
    "cv_inner_split",
    "generate_synthetic_arrays",
    "kfold_indices",
    "train_val_indices",
]
