"""Populations of trainings (counterpart of ``vae_los_angeles_tpu/parallel``):
`vmap_meta.fit_folds` trains one model a CV fold as one stacked population."""
