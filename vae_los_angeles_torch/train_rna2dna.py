"""Train the RNA→DNA directional VAE (the port's ``train_rna2dna.py``):

    python -m vae_los_angeles_torch.train_rna2dna [--epochs N] [--seed S]
        [--data_path data/processed_data.pkl] [--synthetic] [--resume]
        [--profile LOG_DIR]

On the card unless ``DEVICE=cpu``; ``USE_PALLAS=1`` trains through the
RNA→DNA epoch kernel (``training.cli.run_training``).
"""

import sys

from vae_los_angeles_torch.training.cli import main_rna2dna

if __name__ == "__main__":
    main_rna2dna(sys.argv[1:])
