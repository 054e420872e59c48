"""Model family of the port: the directional VAEs and the tri-modal VAE."""

from vae_los_angeles_torch.models.directional_vae import DNA2RNAVAE, RNA2DNAVAE  # noqa: F401
from vae_los_angeles_torch.models.vae import MultiModalVAE  # noqa: F401

__all__ = ["DNA2RNAVAE", "MultiModalVAE", "RNA2DNAVAE"]
