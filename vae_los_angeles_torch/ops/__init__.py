"""Numerics of the port: layers' init and BN folding (`nn`), metrics
(`metrics`), the kNN baselines (`knn`), the Gram PCA (`pca`), the exact
t-SNE (`tsne`), the silhouette and neighbourhood hit (`cluster_metrics`)
and the hand-written kernels (`kernels`)."""
