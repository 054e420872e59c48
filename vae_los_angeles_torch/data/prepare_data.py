"""The data preparation (counterpart of
``vae_los_angeles_tpu/data/prepare_data.py``, the reference's
``scripts/prepare_data.py``):

    python -m vae_los_angeles_torch.data.prepare_data [--synthetic]
        [--rna-parquet RNA.parquet --dna-parquet DNA.parquet]
        [--verify-ingest [MANIFEST.json]] [--data_dir data]

Downloads the two Kaggle datasets (or reads local parquet mirrors), groups
RNA TPM per ``case_barcode`` into fixed-width vectors (the cases with
exactly ``input_dim_a`` genes), groups DNA probes likewise, outer-joins on
case_barcode (the unmatched cohorts saved apart), keeps the top-24 primary
sites, log1p's RNA and label-encodes the sites. It writes the artifact set
in the port's pandas-free form (``data.artifacts``: dicts of arrays and a
``LabelCodes``), so the data is prepared on a workstation and trained on
from the card's machine, which has no pandas:
  data/processed_data.pkl, data/label_encoder.pkl,
  data/rna_only_unmatched.pkl, data/dna_only_unmatched.pkl,
  data/feature_names.pkl (which the reference's boxplots read and its
  preparation never wrote).

The stages are pure functions of DataFrames, testable without Kaggle;
pandas, pyarrow (through ``read_parquet``) and kagglehub are imported only
inside the functions that need them. ``--synthetic`` writes the synthetic
artifact set instead.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data import artifacts, ingest_manifest
from vae_los_angeles_torch.data.splits import LabelCodes

RNA_DATASET = "martininf1n1ty/rna-mutations-all-datasets"
DNA_DATASET = "martininf1n1ty/dna-methylation-final-adnotated"


def download_datasets():
    import kagglehub

    print("Downloading RNA and mutations dataset...")
    rna_path = kagglehub.dataset_download(RNA_DATASET)
    print(f"RNA dataset downloaded to: {rna_path}")
    print("\nDownloading DNA methylation dataset...")
    dna_path = kagglehub.dataset_download(DNA_DATASET)
    print(f"DNA methylation dataset downloaded to: {dna_path}")
    return rna_path, dna_path


def _group_vectors_fast(df, feat_col: str, val_col: str, width: int,
                        site_col=None, dedup: bool = True):
    """Vectorized sort → dedup → per-case vector grouping → width filter.

    Equivalent to the pandas formulation in `prepare_rna_data` /
    `prepare_dna_methylation_data` (feature-sorted vectors, one row per
    case sorted by case id, first-occurrence dedup of duplicate
    (case, feature) pairs, keep cases with exactly ``width`` features) but
    built from factorize/argsort/bincount over flat arrays instead of
    ``groupby().agg(list)`` — the difference between seconds and minutes on
    multi-million-row expression/methylome tables. Returns
    (case_names_kept, value_matrix (n_kept, width), feat_names_of_first_kept,
    site_first_or_None).

    One documented refinement over the reference: dedup is deterministic
    (first occurrence in INPUT order wins, via stable sorts) where the
    reference's non-stable ``sort_values`` leaves the kept duplicate
    unspecified when conflicting values exist for the same (case, feature).
    """
    cases = df["case_barcode"].to_numpy()
    feats = df[feat_col].to_numpy()
    vals = df[val_col].to_numpy()
    if len(df) == 0:
        site0 = df[site_col].to_numpy() if site_col is not None else None
        return cases, vals.reshape(0, width), [], site0
    import pandas as pd

    def sorted_codes(values):
        # hash-factorize then rank-remap: only the uniques get string-sorted
        # (np.searchsorted over millions of strings costs ~billions of
        # string compares — measured 3× slower than the pandas oracle)
        codes, uniques = pd.factorize(values)
        if (codes < 0).any():  # factorize maps null keys to -1
            raise ValueError("null keys in grouping column")
        uniques = np.asarray(uniques)
        sorter = np.argsort(uniques)
        rank = np.empty(len(sorter), dtype=np.int64)
        rank[sorter] = np.arange(len(sorter))
        return rank[codes], uniques[sorter]

    case_code, case_names = sorted_codes(cases)  # sorted, like groupby(sort=True)
    feat_code, feat_names = sorted_codes(feats)  # sorted, like sort_values(feat)

    # feature-major stable order; dedup keeps the first (case, feat)
    # occurrence in input order (the RNA path's drop_duplicates — the DNA
    # path keeps duplicates, whose values then count toward the width,
    # exactly like the reference's dedup-free probe grouping)
    order = np.argsort(feat_code, kind="stable")
    cc, fc, ov = case_code[order], feat_code[order], order
    if dedup:
        key = cc.astype(np.int64) * len(feat_names) + fc
        first = ~pd.Series(key).duplicated().to_numpy()
        cc, fc, ov = cc[first], fc[first], ov[first]
    # case-major stable sort preserves the feature order within each case
    o2 = np.argsort(cc, kind="stable")
    cc, fc, ov = cc[o2], fc[o2], ov[o2]

    counts = np.bincount(cc, minlength=len(case_names))
    kept_cases = counts == width
    kept_rows = kept_cases[cc]
    matrix = vals[ov[kept_rows]].reshape(-1, width)
    if kept_rows.any():
        first_feats = feat_names[fc[kept_rows][:width]].tolist()
    else:
        first_feats = feat_names[:width].tolist()
    site_first = None
    if site_col is not None:
        # groupby-'first' semantics: the first NON-NULL site per case (a
        # literal first-row read would return NaN where the oracle skips it)
        firsts = pd.Series(df[site_col].to_numpy()[ov]).groupby(cc).first()
        site_first = firsts.reindex(np.flatnonzero(kept_cases)).to_numpy()
    return case_names[kept_cases], matrix, first_feats, site_first


def prepare_rna_data(df_expressions, input_dim_a: int, engine: str = "auto"):
    """Group per-case TPM vectors; keep rows with exactly input_dim_a genes
    (reference :28-49). Also returns sorted gene names for feature_names.pkl.

    ``engine="auto"`` uses the vectorized grouping (`_group_vectors_fast`);
    "pandas" is the reference formulation, kept as the equivalence oracle."""
    import pandas as pd

    if engine not in ("auto", "pandas"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto":
        try:
            kept, matrix, gene_names, sites = _group_vectors_fast(
                df_expressions, "gene_name", "tpm_unstranded", input_dim_a,
                site_col="primary_site",
            )
        except (ValueError, TypeError) as e:
            # null keys (factorize code -1 → ValueError) or incomparable
            # uniques (TypeError from argsort); anything else is a real bug
            # and must surface
            print(f"vectorized grouping unavailable ({e}); using pandas path")
            return prepare_rna_data(df_expressions, input_dim_a, engine="pandas")
        filtered = pd.DataFrame(
            {
                # match the input's (pandas-version-dependent) string dtype
                "case_barcode": pd.Series(kept).astype(
                    df_expressions["case_barcode"].dtype
                ),
                "tpm_unstranded": pd.Series(
                    [r.tolist() for r in matrix], dtype=object
                ),
                "primary_site": pd.Series(sites).astype(
                    df_expressions["primary_site"].dtype
                ),
            }
        )
        print(f"RNA data shape: {filtered.shape}")
        return filtered, list(gene_names)
    df_sorted = df_expressions.sort_values(by="gene_name")
    df_sorted = df_sorted.drop_duplicates(subset=["case_barcode", "gene_name"])
    grouped = (
        df_sorted.groupby("case_barcode")
        .agg({"tpm_unstranded": list, "gene_name": list, "primary_site": "first"})
        .reset_index()
    )
    filtered = grouped[grouped["tpm_unstranded"].apply(len) == input_dim_a]
    # feature_names must be the genes actually composing the kept vectors —
    # a kept case's own sorted gene list, NOT the alphabetically-first
    # input_dim_a of ALL genes (which may not match any kept row)
    if len(filtered):
        gene_names = list(filtered.iloc[0]["gene_name"])
    else:
        gene_names = sorted(df_sorted["gene_name"].unique().tolist())[:input_dim_a]
    filtered = filtered.drop(columns=["gene_name"])
    print(f"RNA data shape: {filtered.shape}")
    return filtered, gene_names


def prepare_dna_methylation_data(df, input_dim_b: int, engine: str = "auto"):
    """Group per-case β-value vectors; keep rows of width input_dim_b
    (reference :55-66). Engines as in `prepare_rna_data` — "auto" is the
    vectorized grouping, "pandas" the reference-formulation oracle."""
    import pandas as pd

    if engine not in ("auto", "pandas"):
        raise ValueError(f"unknown engine {engine!r}")
    probe_col = "probe_id_id" if "probe_id_id" in df.columns else "probe_id"
    if engine == "auto":
        try:
            kept, matrix, probe_ids, _ = _group_vectors_fast(
                df, probe_col, "beta_value", input_dim_b, dedup=False
            )
        except (ValueError, TypeError) as e:  # see prepare_rna_data
            print(f"vectorized grouping unavailable ({e}); using pandas path")
            return prepare_dna_methylation_data(df, input_dim_b, engine="pandas")
        filtered = pd.DataFrame(
            {
                "case_barcode": pd.Series(kept).astype(
                    df["case_barcode"].dtype
                ),
                "beta_value": pd.Series(
                    [r.tolist() for r in matrix], dtype=object
                ),
            }
        )
        print(f"DNA methylation data shape: {filtered.shape}")
        return filtered, list(probe_ids)
    df_sorted = df.sort_values(by=probe_col)
    grouped = (
        df_sorted.groupby("case_barcode")
        .agg({"beta_value": list, probe_col: list})
        .reset_index()
    )
    filtered = grouped[grouped["beta_value"].apply(len) == input_dim_b]
    # same rule as gene_names: the probes of an actual kept vector
    if len(filtered):
        probe_ids = list(filtered.iloc[0][probe_col])
    else:
        probe_ids = sorted(df_sorted[probe_col].unique().tolist())[:input_dim_b]
    filtered = filtered.drop(columns=[probe_col])
    print(f"DNA methylation data shape: {filtered.shape}")
    return filtered, probe_ids


def merge_and_normalize_data(rna_df, dna_df, top_n_sites: int = 24, data_dir="data"):
    """Outer join, unmatched-cohort extraction (written to ``data_dir`` in the
    port's form), top-N site filter, log1p RNA, label encoding (reference
    :69-137). Returns (the matched table as the port's dict of arrays, its
    ``LabelCodes``)."""
    import pandas as pd

    print("\nMerging datasets...")
    merged_df = pd.merge(rna_df, dna_df, on="case_barcode", how="outer", indicator=True)

    os.makedirs(data_dir, exist_ok=True)
    rna_only = merged_df[merged_df["_merge"] == "left_only"].copy()
    if len(rna_only) > 0:
        print(f"Found {len(rna_only)} RNA samples without matching DNA data")
        rna_only = rna_only[["case_barcode", "tpm_unstranded", "primary_site"]]
        artifacts.write_pickle(os.path.join(data_dir, "rna_only_unmatched.pkl"),
                               artifacts.table_from_frame(rna_only))
    dna_only = merged_df[merged_df["_merge"] == "right_only"].copy()
    if len(dna_only) > 0:
        print(f"Found {len(dna_only)} DNA samples without matching RNA data")
        dna_only = dna_only[["case_barcode", "beta_value"]]
        artifacts.write_pickle(os.path.join(data_dir, "dna_only_unmatched.pkl"),
                               artifacts.table_from_frame(dna_only))

    merged_df = merged_df[merged_df["_merge"] == "both"].copy()
    merged_df = merged_df.drop(columns=["_merge"])

    site_counts = merged_df["primary_site"].value_counts()
    top_sites = site_counts.head(top_n_sites).index.tolist()
    merged_df = merged_df[merged_df["primary_site"].isin(top_sites)].reset_index(
        drop=True
    )
    print(f"Merged data shape after top-{top_n_sites} site filter: {merged_df.shape}")

    print("Normalizing RNA expression data (log1p)...")
    merged_df["tpm_unstranded"] = merged_df["tpm_unstranded"].apply(
        lambda x: np.log1p(np.array(x))
    )

    label_encoder = LabelCodes()
    merged_df["primary_site_encoded"] = label_encoder.fit_transform(
        merged_df["primary_site"]
    )
    return artifacts.table_from_frame(merged_df), label_encoder


def save_artifacts(merged, label_encoder, gene_names, probe_ids, data_dir="data"):
    """processed_data.pkl, label_encoder.pkl and feature_names.pkl in the
    port's form (a DataFrame ``merged`` converted first)."""
    artifacts.write_artifacts(data_dir, merged, label_encoder,
                              {"gene_names": gene_names, "probe_ids": probe_ids})
    print(f"Processed data saved to: {os.path.join(data_dir, 'processed_data.pkl')}")
    print(f"Label encoder saved to: {os.path.join(data_dir, 'label_encoder.pkl')}")
    print(f"Feature names saved to: {os.path.join(data_dir, 'feature_names.pkl')}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Prepare multi-omics data")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="generate synthetic artifacts instead of downloading from Kaggle",
    )
    parser.add_argument("--n_samples", type=int, default=1024)
    # default honors the DATA_DIR env override like every other CLI
    parser.add_argument(
        "--data_dir", type=str, default=os.getenv("DATA_DIR", "data")
    )
    parser.add_argument(
        "--verify-ingest", nargs="?", const="builtin", default=None,
        metavar="MANIFEST.json",
        help="validate the raw tables' schema against the recorded ingest "
        "manifest (data/ingest_manifest.py) and exit — no processing. "
        "Optionally pass a JSON manifest recorded from live tables "
        "(ingest_manifest.record_manifest); default is the built-in "
        "contract transcribed from the reference's access patterns",
    )
    parser.add_argument(
        "--rna-parquet", default=None,
        help="local path to the RNA expression parquet (skips the Kaggle "
        "download — lets --verify-ingest and full prep run against a "
        "pre-downloaded mirror in offline environments)",
    )
    parser.add_argument(
        "--dna-parquet", default=None,
        help="local path to the annotated DNA methylation parquet "
        "(see --rna-parquet)",
    )
    args = parser.parse_args(argv)

    cfg = Config.from_env()
    if args.synthetic:
        from vae_los_angeles_torch.data.synthetic import write_synthetic_artifacts

        print("Generating synthetic data artifacts (offline mode)...")
        write_synthetic_artifacts(
            args.data_dir, n_samples=args.n_samples,
            dim_a=cfg.input_dim_a, dim_b=cfg.input_dim_b,
        )
        print("Synthetic data preparation complete!")
        return

    if bool(args.rna_parquet) != bool(args.dna_parquet):
        # one flag alone would be SILENTLY discarded and both tables
        # re-downloaded — fail loudly instead
        raise SystemExit(
            "--rna-parquet and --dna-parquet must be given together "
            "(local-mirror mode replaces the whole Kaggle download)"
        )
    if args.rna_parquet and args.dna_parquet:
        rna_file, dna_file = args.rna_parquet, args.dna_parquet
    else:
        try:
            rna_path, dna_path = download_datasets()
        except Exception as e:
            raise SystemExit(
                f"Kaggle download failed ({e}). In offline environments run "
                "with --synthetic to generate schema-compatible synthetic "
                "data, or point --rna-parquet/--dna-parquet at local mirrors."
            )
        rna_file = os.path.join(rna_path, "expression_onko_db.parquet")
        dna_files = [f for f in os.listdir(dna_path) if f.endswith(".parquet")]
        dna_file = os.path.join(dna_path, dna_files[0])

    import pandas as pd  # not for --synthetic, which runs without pandas

    df_expr = pd.read_parquet(rna_file)
    df_dna = pd.read_parquet(dna_file)

    # ingest assumptions are executable, not implicit: every real-data run
    # checks the raw tables against the recorded contract before any
    # transform touches them (--verify-ingest checks and stops there)
    manifest = (
        ingest_manifest.load_manifest(args.verify_ingest)
        if args.verify_ingest and args.verify_ingest != "builtin"
        else None
    )
    ok = ingest_manifest.report(
        {"rna_expression": df_expr, "dna_methylation": df_dna}, manifest
    )
    if args.verify_ingest:
        raise SystemExit(0 if ok else 2)
    if not ok:
        raise SystemExit(
            "raw table schema does not match the recorded ingest manifest "
            "(issues above) — the Kaggle datasets drifted or the local "
            "mirrors are wrong; re-record with "
            "ingest_manifest.record_manifest if the drift is intentional"
        )

    rna_df, gene_names = prepare_rna_data(df_expr, cfg.input_dim_a)
    dna_df, probe_ids = prepare_dna_methylation_data(df_dna, cfg.input_dim_b)

    merged_df, label_encoder = merge_and_normalize_data(
        rna_df, dna_df, data_dir=args.data_dir
    )
    save_artifacts(merged_df, label_encoder, gene_names, probe_ids, args.data_dir)
    print("\nData preparation complete!")


if __name__ == "__main__":
    main(sys.argv[1:])
