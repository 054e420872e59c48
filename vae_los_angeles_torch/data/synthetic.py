"""Synthetic multi-omics arrays (counterpart of
``vae_los_angeles_tpu/data/synthetic.py``).

Bit-identical to the JAX package's `generate_synthetic_arrays` for the same
arguments: the same numpy ``default_rng`` draws in the same order. Samples
share a per-site latent factor, so the cross-modal maps are learnable and a
trained VAE beats the mean baseline.

`unmatched_cohorts` is the array half of the JAX package's
``write_synthetic_artifacts``: the matched table and the two unmatched
cohorts, bit-equal to the frames that writer pickles. The pandas/sklearn
artifact writers (``make_dataframe``, ``write_synthetic_artifacts``) are not
ported yet.
"""

from __future__ import annotations

import numpy as np

SITE_NAMES = [
    "Breast", "Lung", "Kidney", "Brain", "Colon", "Prostate", "Thyroid",
    "Stomach", "Liver", "Ovary", "Pancreas", "Skin", "Bladder", "Uterus",
    "Esophagus", "Cervix", "Testis", "Adrenal gland", "Bone", "Eye",
    "Larynx", "Pleura", "Thymus", "Bile duct",
]


def generate_synthetic_arrays(
    n_samples: int = 1024,
    dim_a: int = 1177,
    dim_b: int = 1211,
    n_sites: int = 24,
    latent_dim: int = 12,
    noise: float = 0.3,
    seed: int = 0,
):
    """Returns (tpm, beta, site): float32 (n, dim_a), float32 (n, dim_b) in
    (0, 1), int64 (n,)."""
    rng = np.random.default_rng(seed)
    site = rng.integers(0, n_sites, size=n_samples)
    site_centroids = rng.normal(scale=2.0, size=(n_sites, latent_dim))
    z = site_centroids[site] + rng.normal(scale=1.0, size=(n_samples, latent_dim))
    w_a = rng.normal(scale=1.0 / np.sqrt(latent_dim), size=(latent_dim, dim_a))
    w_b = rng.normal(scale=1.0 / np.sqrt(latent_dim), size=(latent_dim, dim_b))
    # RNA: log1p of non-negative expression
    raw_a = z @ w_a + noise * rng.normal(size=(n_samples, dim_a))
    tpm = np.log1p(np.exp(np.clip(raw_a, -10, 10)) * 5.0).astype(np.float32)
    # DNA: β-values in (0, 1)
    raw_b = z @ w_b + noise * rng.normal(size=(n_samples, dim_b))
    beta = (1.0 / (1.0 + np.exp(-raw_b))).astype(np.float32)
    beta = np.clip(beta, 1e-6, 1.0 - 1e-6)
    return tpm, beta, site.astype(np.int64)


def unmatched_cohorts(n_samples: int = 1024, n_unmatched: int = 128, dim_a: int = 1177,
                      dim_b: int = 1211, n_sites: int = 24, seed: int = 0):
    """(matched, rna_only, dna_only) of one draw of ``n_samples + 2 *
    n_unmatched`` rows, as the JAX package's ``write_synthetic_artifacts``
    splits it:

      * matched: (tpm, beta, site), the first ``n_samples`` rows;
      * rna_only: (raw TPM, site), the next ``n_unmatched`` rows, their
        log1p values taken back with ``np.expm1`` (the unmatched RNA cohort
        ships raw TPM; the reconstruction applies log1p), no β;
      * dna_only: (beta, site), the last ``n_unmatched`` rows, no TPM.

    Each array is bit-equal to the matching column of the frame that writer
    pickles; the site codes stand for its site names."""
    tpm, beta, site = generate_synthetic_arrays(n_samples + 2 * n_unmatched, dim_a, dim_b,
                                                n_sites, seed=seed)
    rna, dna = slice(n_samples, n_samples + n_unmatched), slice(n_samples + n_unmatched, None)
    # row by row, as the writer applies it to each row of its list column
    raw_tpm = np.stack([np.expm1(row) for row in tpm[rna]]).reshape(-1, dim_a)
    return ((tpm[:n_samples], beta[:n_samples], site[:n_samples]), (raw_tpm, site[rna]),
            (beta[dna], site[dna]))
