"""Train the tri-modal MultiModalVAE (the port's ``train.py``):

    python -m vae_los_angeles_torch.train [--epochs N] [--seed S]
        [--data_path data/processed_data.pkl] [--resume]

Balanced class weights on the site loss. On the card unless ``DEVICE=cpu``;
``USE_PALLAS=1`` trains through the tri-modal epoch kernel
(``training.cli.run_training``).
"""

import sys

from vae_los_angeles_torch.training.cli import main_multimodal

if __name__ == "__main__":
    main_multimodal(sys.argv[1:])
