"""Imputation of the missing modality of the unmatched cohorts (counterpart
of ``vae_los_angeles_tpu/evaluation/reconstruct_unmatched.py``, the
reference's ``reconstruct_unmatched.py``).

    python -m vae_los_angeles_torch.evaluation.reconstruct_unmatched

The RNA-only samples get DNA from RNA2DNAVAE (log1p applied to their raw
TPM on the host, their sites label-encoded), the DNA-only samples get RNA
from DNA2RNAVAE with ``site=None`` (they have no site the model may use).
RNA-only rows of a site the label encoder does not know are dropped first.
With pickles (``cfg.data_dir``'s ``rna_only_unmatched.pkl`` and
``dna_only_unmatched.pkl``, read with pandas) it writes
``rna_with_reconstructed_dna_<ts>.pkl`` and
``dna_with_reconstructed_rna_<ts>.pkl`` with the JAX frames' columns, for
`clustering.cluster_reconstructed`; ``main(data=...)`` takes the three
parts of `data.synthetic.unmatched_cohorts` (the site codes stand for the
names) and returns each cohort as a dict of arrays under the same column
names. Both write the statistics pickle.

With ``USE_PALLAS`` on the card each cohort is one launch of its serving
kernel (B0a for the RNA-only rows, B0b without a site for the DNA-only
rows); a kernel that fails raises. Runs on the card unless the CPU is asked
for (``device="cpu"`` or ``DEVICE=cpu``).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import SiteCodes
from vae_los_angeles_torch.device import resolve_device
from vae_los_angeles_torch.evaluation import tables
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.training import checkpoint


def reconstruct_dna_from_rna(rna2dna_model, rna_df, label_encoder):
    """The RNA-only cohort with ``reconstructed_beta_value`` and
    ``primary_site_encoded`` added."""
    print("\n" + "=" * 80)
    print("RECONSTRUCTING DNA FROM RNA-ONLY SAMPLES")
    print("=" * 80)
    print(f"Number of RNA-only samples: {tables.n_rows(rna_df)}")

    rna_data = np.log1p(tables.column(rna_df, "tpm_unstranded").astype(np.float32))
    site_labels = label_encoder.transform(tables.column(rna_df, "primary_site"))
    recon_dna, _, _ = rna2dna_model(rna=rna_data, site=site_labels)
    print(f"✓ Reconstructed DNA shape: {recon_dna.shape}")
    return tables.with_columns(rna_df, reconstructed_beta_value=recon_dna,
                               primary_site_encoded=site_labels)


def reconstruct_rna_from_dna(dna2rna_model, dna_df, label_encoder):
    """The DNA-only cohort with ``reconstructed_tpm_unstranded`` added,
    imputed without a site."""
    print("\n" + "=" * 80)
    print("RECONSTRUCTING RNA FROM DNA-ONLY SAMPLES")
    print("=" * 80)
    print(f"Number of DNA-only samples: {tables.n_rows(dna_df)}")
    print("Note: DNA-only samples have no primary_site; using site=None...")

    dna_data = tables.column(dna_df, "beta_value").astype(np.float32)
    recon_rna, _, _ = dna2rna_model(dna=dna_data, site=None)
    print(f"✓ Reconstructed RNA shape: {recon_rna.shape}")
    return tables.with_columns(dna_df, reconstructed_tpm_unstranded=recon_rna)


def save_reconstruction_stats(rna_df, dna_df, run_timestamp, data_dir="data"):
    """Write and return the statistics dict: sample counts, and the RNA-only
    cohort's count a primary site (numpy in place of pandas'
    ``value_counts``)."""
    stats = {
        "timestamp": run_timestamp,
        "rna_only_samples": 0 if rna_df is None else tables.n_rows(rna_df),
        "dna_only_samples": 0 if dna_df is None else tables.n_rows(dna_df),
    }
    if rna_df is not None:
        sites, counts = np.unique(tables.column(rna_df, "primary_site"), return_counts=True)
        stats["rna_only_primary_sites"] = {getattr(s, "item", lambda: s)(): int(c)
                                           for s, c in zip(sites, counts)}
    path = os.path.join(data_dir, f"reconstruction_stats_{run_timestamp}.pkl")
    with open(path, "wb") as f:
        pickle.dump(stats, f)
    print(f"\n✓ Reconstruction statistics saved to: {path}")
    return stats


def _cohorts(cfg, data):
    """(label encoder, RNA-only table or None, DNA-only table or None)."""
    if data is not None:
        (_, _, site), (raw_tpm, rna_site), (beta, dna_site) = data
        rna = {"tpm_unstranded": raw_tpm, "primary_site": rna_site,
               "primary_site_encoded": rna_site}
        dna = {"beta_value": beta, "primary_site": dna_site, "primary_site_encoded": dna_site}
        return SiteCodes(site), rna, dna
    import pandas as pd  # only here: the card's machine has no pandas

    with open(os.path.join(cfg.data_dir, "label_encoder.pkl"), "rb") as f:
        label_encoder = pickle.load(f)
    out = [label_encoder]
    for name in ("rna_only_unmatched.pkl", "dna_only_unmatched.pkl"):
        path = os.path.join(cfg.data_dir, name)
        if not os.path.exists(path):
            print(f"\n⚠ {name.split('_')[0].upper()}-only data file not found: {path}")
        out.append(pd.read_pickle(path) if os.path.exists(path) else None)
    return tuple(out)


def main(cfg: Optional[Config] = None, data=None, device=None, root: str = "."):
    """Reconstruct both unmatched cohorts with the latest directional runs
    (their run-id files in ``root``). ``data`` is ``(matched, rna_only,
    dna_only)`` of `unmatched_cohorts` (the matched sites are the known
    ones); None reads the pickles. Returns (RNA-only table, DNA-only table),
    either None when its model or cohort is missing."""
    cfg = cfg or Config.from_env()
    device = resolve_device(device, cfg)
    run_timestamp = checkpoint.new_run_id()
    print("=" * 80)
    print("UNMATCHED DATA RECONSTRUCTION")
    print("=" * 80)

    label_encoder, rna_only_df, dna_only_df = _cohorts(cfg, data)
    print(f"✓ Label encoder loaded ({len(label_encoder.classes_)} classes)")
    rna2dna_model = load_rna2dna(cfg=cfg, root=root, device=device)
    dna2rna_model = load_dna2rna(cfg=cfg, root=root, device=device)
    os.makedirs(cfg.data_dir, exist_ok=True)

    rna_reconstructed_df = dna_reconstructed_df = None
    if rna_only_df is not None and rna2dna_model is not None:
        # keep only sites known to the encoder (reference :256)
        n0 = tables.n_rows(rna_only_df)
        rna_only_df = tables.select(rna_only_df, np.isin(
            tables.column(rna_only_df, "primary_site"), label_encoder.classes_))
        if tables.n_rows(rna_only_df) < n0:
            print(f"  Filtered out {n0 - tables.n_rows(rna_only_df)} unknown-site samples")
        if tables.n_rows(rna_only_df) > 0:
            rna_reconstructed_df = reconstruct_dna_from_rna(rna2dna_model, rna_only_df,
                                                            label_encoder)
            if data is None:
                out = os.path.join(cfg.data_dir, f"rna_with_reconstructed_dna_{run_timestamp}.pkl")
                rna_reconstructed_df.to_pickle(out)
                print(f"✓ Saved reconstructed data to: {out}")

    if dna_only_df is not None and dna2rna_model is not None:
        if tables.n_rows(dna_only_df) > 0:
            dna_reconstructed_df = reconstruct_rna_from_dna(dna2rna_model, dna_only_df,
                                                            label_encoder)
            if data is None:
                out = os.path.join(cfg.data_dir, f"dna_with_reconstructed_rna_{run_timestamp}.pkl")
                dna_reconstructed_df.to_pickle(out)
                print(f"✓ Saved reconstructed data to: {out}")

    if rna_reconstructed_df is not None or dna_reconstructed_df is not None:
        save_reconstruction_stats(rna_reconstructed_df, dna_reconstructed_df, run_timestamp,
                                  cfg.data_dir)
    print("\nReconstruction complete!")
    return rna_reconstructed_df, dna_reconstructed_df


if __name__ == "__main__":
    main()
