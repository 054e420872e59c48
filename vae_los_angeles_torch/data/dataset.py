"""Multi-modal dataset (counterpart of ``vae_los_angeles_tpu/data/dataset.py``).

Dense host arrays over the processed-data schema
(``scripts/prepare_data.py`` of the reference):

  tpm_unstranded: list[float], log1p'd RNA TPM      → ``tpm_data``  (n, dim_a) f32
  beta_value:     list[float] in [0,1], methylation → ``beta_data`` (n, dim_b) f32
  primary_site_encoded: int label                   → ``primary_site`` (n,) i32

Serving stages only what it imputes, so there is no ``to_device`` here;
training's batch helpers come with the trainer.
"""

from __future__ import annotations

import numpy as np

from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.evaluation import tables


class MultiModalDataset:
    """Construct from a table (the port's dict of arrays or a DataFrame),
    from arrays (`from_numpy`) or from the pickle artifact (`from_pickle`,
    either package's)."""

    def __init__(self, table):
        self.tpm_data = tables.column(table, "tpm_unstranded").astype(np.float32)
        self.beta_data = tables.column(table, "beta_value").astype(np.float32)
        self.primary_site = np.asarray(
            tables.column(table, "primary_site_encoded")).astype(np.int32)

    def __len__(self):
        return len(self.tpm_data)

    def __getitem__(self, idx):
        return self.tpm_data[idx], self.beta_data[idx], self.primary_site[idx]

    @classmethod
    def from_numpy(cls, tpm_data, beta_data, primary_site) -> "MultiModalDataset":
        obj = cls.__new__(cls)
        obj.tpm_data = np.asarray(tpm_data, dtype=np.float32)
        obj.beta_data = np.asarray(beta_data, dtype=np.float32)
        obj.primary_site = np.asarray(primary_site, dtype=np.int32)
        return obj

    @classmethod
    def from_pickle(cls, path) -> "MultiModalDataset":
        return cls(artifacts.read_table(path))
