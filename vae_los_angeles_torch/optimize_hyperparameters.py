"""Hyperparameter optimization of the tri-modal MultiModalVAE (the port's
``optimize_hyperparameters.py``):

    python -m vae_los_angeles_torch.optimize_hyperparameters [--trials N]
        [--epochs E] [--prune-rungs R] [--pad-shapes] [--mode optuna]

Trial populations on the card unless ``DEVICE=cpu``; writes
``best_hyperparameters.json`` and ``checkpoints/best_multivae_optimized.npz``
(``evaluation.hpo.main``, which takes ``data=(tpm, beta, site)`` arrays when
called from Python).
"""

import sys

from vae_los_angeles_torch.evaluation.hpo import main

if __name__ == "__main__":
    main(sys.argv[1:])
