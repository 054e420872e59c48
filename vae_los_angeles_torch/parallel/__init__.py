"""Populations and devices (counterpart of ``vae_los_angeles_tpu/parallel``):
`vmap_meta` trains CV folds and HPO trials as stacked populations, sharded
over the ranks under a process group; `comm` holds the process group and
its collectives; `sharding` the ("data", "model") mesh, the Megatron table
and the data- and tensor-parallel step; `sharded_eval` the row-sharded kNN,
cluster metrics and t-SNE; `dryrun` every multi-device path once."""
