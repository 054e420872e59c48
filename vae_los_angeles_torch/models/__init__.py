"""Model family of the port: the directional VAEs and autoencoders and the
tri-modal VAE."""

from vae_los_angeles_torch.models.directional_ae import DNA2RNAAE, RNA2DNAAE  # noqa: F401
from vae_los_angeles_torch.models.directional_vae import DNA2RNAVAE, RNA2DNAVAE  # noqa: F401
from vae_los_angeles_torch.models.vae import MultiModalVAE  # noqa: F401

__all__ = ["DNA2RNAAE", "DNA2RNAVAE", "MultiModalVAE", "RNA2DNAAE", "RNA2DNAVAE"]
