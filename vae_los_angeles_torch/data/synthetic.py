"""Synthetic multi-omics arrays (counterpart of
``vae_los_angeles_tpu/data/synthetic.py``).

Bit-identical to the JAX package's `generate_synthetic_arrays` for the same
arguments: the same numpy ``default_rng`` draws in the same order. Samples
share a per-site latent factor, so the cross-modal maps are learnable and a
trained VAE beats the mean baseline.

`unmatched_cohorts` is the array half of the JAX package's
``write_synthetic_artifacts``: the matched table and the two unmatched
cohorts, bit-equal to the frames that writer pickles.
`write_synthetic_artifacts` writes its five files in the port's pandas-free
form (``data.artifacts``): the same columns, values, site names, barcodes
and feature names, as dicts of arrays and a ``LabelCodes``;
`ensure_synthetic_artifacts` is the ``--synthetic`` flag of the training
and HPO CLIs.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data.splits import LabelCodes
from vae_los_angeles_torch.parallel import comm

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


def site_names(n_sites: int = 24):
    """The synthetic site names a code indexes (sorted, as the JAX package's
    ``make_dataframe`` takes them, so the codes are the label encoder's)."""
    return sorted((SITE_NAMES * ((n_sites // len(SITE_NAMES)) + 1))[:n_sites])


def make_label_encoder(n_sites: int = 24) -> LabelCodes:
    """The encoder of `site_names` (the JAX package's ``make_label_encoder``)."""
    return LabelCodes().fit(site_names(n_sites))


def write_synthetic_artifacts(data_dir: str = "data", n_samples: int = 1024, dim_a: int = 1177,
                              dim_b: int = 1211, n_sites: int = 24, seed: int = 0,
                              n_unmatched: int = 128):
    """The artifact set of the data preparation, synthetically:
    processed_data.pkl, label_encoder.pkl, rna_only_unmatched.pkl,
    dna_only_unmatched.pkl and feature_names.pkl, the JAX package's
    ``write_synthetic_artifacts`` column for column (barcodes ``SYN-00000``
    onward over all rows, the RNA-only TPM raw). Returns (the matched table, the
    label encoder)."""
    (tpm, beta, site), (raw_tpm, rna_site), (dna_beta, dna_site) = unmatched_cohorts(
        n_samples, n_unmatched, dim_a, dim_b, n_sites, seed)
    barcodes = np.array([f"SYN-{i:05d}" for i in range(n_samples + 2 * n_unmatched)])
    names = np.array(site_names(n_sites))

    def table(rows, codes, **features):
        return {"case_barcode": barcodes[rows], **features, "primary_site": names[codes],
                "primary_site_encoded": codes.astype(np.int64)}

    matched = table(slice(0, n_samples), site, tpm_unstranded=tpm, beta_value=beta)
    label_encoder = make_label_encoder(n_sites)
    # feature_names.pkl: expected by create_boxplots but never produced by
    # the reference's preparation, so the JAX package emits it; so does this
    feature_names = {"gene_names": [f"GENE_{i:04d}" for i in range(dim_a)],
                     "probe_ids": [f"cg{i:08d}" for i in range(dim_b)]}
    artifacts.write_artifacts(
        data_dir, matched, label_encoder, feature_names,
        rna_only=table(slice(n_samples, n_samples + n_unmatched), rna_site,
                       tpm_unstranded=raw_tpm),
        dna_only=table(slice(n_samples + n_unmatched, None), dna_site, beta_value=dna_beta))
    return matched, label_encoder


@comm.writes_files
def ensure_synthetic_artifacts(data_dir: str, target_pkl: str = None, dim_a: int = 1177,
                               dim_b: int = 1211) -> bool:
    """The ``--synthetic`` bootstrap of the training and HPO CLIs: nothing
    when ``target_pkl`` (default ``data_dir/processed_data.pkl``) exists;
    otherwise the artifacts are written into a scratch directory under
    ``data_dir`` and moved without overwriting (the requested pickle, then
    each other file only where it is missing), so real artifacts beside a
    missing custom ``target_pkl`` stay as they are. Returns True when it
    wrote artifacts (on the writing rank of a process group; None on the
    others, which wait for it)."""
    target_pkl = target_pkl or os.path.join(data_dir, "processed_data.pkl")
    if os.path.exists(target_pkl):
        return False
    print("Generating synthetic data artifacts...")
    os.makedirs(data_dir, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=".synthetic_", dir=data_dir)
    try:
        write_synthetic_artifacts(staging, dim_a=dim_a, dim_b=dim_b)
        os.replace(os.path.join(staging, "processed_data.pkl"), target_pkl)
        for name in sorted(os.listdir(staging)):
            dest = os.path.join(data_dir, name)
            if not os.path.exists(dest):
                os.replace(os.path.join(staging, name), dest)
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return True
