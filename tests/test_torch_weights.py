"""Weight bridge: JAX pytrees ↔ the port's state_dicts, held against the JAX
package's own reference-layout exporter (``utils/torch_import.py``)."""

import jax
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import (DNA2RNAAE, DNA2RNAVAE, MultiModalVAE, RNA2DNAAE,
                                          RNA2DNAVAE)
from vae_los_angeles_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from vae_los_angeles_tpu.models.directional_ae import dna2rna_ae_init, rna2dna_ae_init
from vae_los_angeles_tpu.models.directional_vae import dna2rna_vae_init, rna2dna_vae_init
from vae_los_angeles_tpu.models.vae import multimodal_vae_init
from vae_los_angeles_tpu.utils.torch_import import export_state_dict

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 40, 56, 5, 8, 6
FAMILIES = {
    "rna2dna": (rna2dna_vae_init, RNA2DNAVAE),
    "dna2rna": (dna2rna_vae_init, DNA2RNAVAE),
    "multivae": (multimodal_vae_init, MultiModalVAE),
    "rna2dna_ae": (rna2dna_ae_init, RNA2DNAAE),
    "dna2rna_ae": (dna2rna_ae_init, DNA2RNAAE),
}
# where each model keeps its site embedding's table
SITE_TABLE = {"rna2dna": ("encoder_site", "embedding"), "dna2rna": ("encoder_site", "embedding"),
              "multivae": ("encoder_c", "embedding"), "rna2dna_ae": ("site_embedding",),
              "dna2rna_ae": ("site_embedding",)}


def jax_model(model_type, seed=0):
    init, _ = FAMILIES[model_type]
    params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    state = jax.tree.map(
        lambda x: x + 0.1 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state
    )
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_state_dict_matches_reference_exporter(model_type):
    params, state = jax_model(model_type)
    want = {k: v for k, v in export_state_dict(params, state, model_type).items()
            if not k.endswith("num_batches_tracked")}
    got = state_dict_from_jax(params, state, model_type)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_round_trip_is_exact(model_type):
    params, state = jax_model(model_type)
    p2, s2 = jax_from_state_dict(state_dict_from_jax(params, state, model_type), model_type)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    for (path_a, a), (path_b, b) in zip(flat((params, state)), flat((p2, s2))):
        assert path_a == path_b
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure((params, state)) == jax.tree.structure((p2, s2))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_port_module_loads_strictly_and_exports_back(model_type):
    params, state = jax_model(model_type)
    _, model_cls = FAMILIES[model_type]
    model = model_cls(DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    model.load_state_dict(state_dict_from_jax(params, state, model_type), strict=True)
    # the module's own state_dict (num_batches_tracked included) maps back
    p2, s2 = jax_from_state_dict(model.state_dict(), model_type)
    got, want = p2, params
    for key in SITE_TABLE[model_type]:
        got, want = got[key], want[key]
    np.testing.assert_array_equal(got["table"], want["table"])
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)


def test_wrong_layout_raises():
    params, state = jax_model("rna2dna")
    with pytest.raises(KeyError):
        state_dict_from_jax(params, state, "dna2rna")
    sd = state_dict_from_jax(params, state, "rna2dna")
    with pytest.raises(ValueError, match="unconsumed"):
        jax_from_state_dict({**sd, "extra.weight": torch.zeros(1)}, "rna2dna")
    with pytest.raises(KeyError):
        jax_from_state_dict({k: v for k, v in sd.items() if "fc_mu" not in k}, "rna2dna")
    with pytest.raises(ValueError, match="unknown model type"):
        state_dict_from_jax(params, state, "multimodal")  # a task's name, not a model's
