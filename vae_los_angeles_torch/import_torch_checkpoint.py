"""Convert a reference PyTorch checkpoint (``.pt`` state_dict) to the
``.npz`` format (the port's ``scripts/import_torch_checkpoint.py``):

    python -m vae_los_angeles_torch.import_torch_checkpoint checkpoints/best_rna2dna_<run_id>.pt
    python -m vae_los_angeles_torch.import_torch_checkpoint old.pt --model dna2rna --write-run-id

(``utils.torch_import.import_main``).
"""

import sys

from vae_los_angeles_torch.utils.torch_import import import_main

if __name__ == "__main__":
    import_main(sys.argv[1:])
