"""Export a ``.npz`` checkpoint as a reference-loadable ``.pt`` state_dict
(the port's ``scripts/export_torch_checkpoint.py``):

    python -m vae_los_angeles_torch.export_torch_checkpoint checkpoints/best_rna2dna_<run_id>.npz

(``utils.torch_import.export_main``).
"""

import sys

from vae_los_angeles_torch.utils.torch_import import export_main

if __name__ == "__main__":
    export_main(sys.argv[1:])
