"""Serving side of the port: model loading, the directional imputation
comparison, the kNN comparison and the tri-modal evaluation."""
