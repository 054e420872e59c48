"""Train the DNA→RNA directional VAE (the port's ``train_dna2rna.py``):

    python -m vae_los_angeles_torch.train_dna2rna [--epochs N] [--seed S]
        [--data_path data/processed_data.pkl] [--synthetic] [--resume]
        [--profile LOG_DIR]

On the card unless ``DEVICE=cpu``; ``USE_PALLAS=1`` trains through the
DNA→RNA epoch kernel (``training.cli.run_training``).
"""

import sys

from vae_los_angeles_torch.training.cli import main_dna2rna

if __name__ == "__main__":
    main_dna2rna(sys.argv[1:])
