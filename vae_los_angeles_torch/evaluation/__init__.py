"""Serving and evaluation side of the port: model loading, the directional
imputation comparison, the kNN comparison, the tri-modal evaluation, the
CV, the HPO, the downstream classification, the unmatched cohorts'
reconstruction and their clustering evaluation (`clustering`)."""
