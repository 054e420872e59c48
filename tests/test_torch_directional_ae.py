"""The directional autoencoders (RNA2DNAAE, DNA2RNAAE) of the port against
the JAX package at small widths: the modules and the functional applies
against ``vae_los_angeles_tpu.models.directional_ae`` (eval forwards with
and without a site, site-only, train mode with the JAX dropout draws), the
losses and the tasks of ``training/tasks.py`` (loss, gradients, predict and
target), three epochs of each engine from the same weights, the training
carry, and ``run_training``'s artifacts read back by both packages.

Tolerances: ``LAYER`` (1e-5) where one layer separates the two, ``CHAIN``
(1e-4) for a chain of products (fp32 on both sides, summed in other
orders), as ``test_torch_models.py``. The engines' noise differs (torch
generators against threefry), so their runs agree exactly in the epoch
count, β (0: no KL term) and the rate, and to rtol 5% in the losses: over
four seeds of each engine at this size, the 16 pairs' train losses differ
by at most 0.7% (RNA→DNA) and 1.4% (DNA→RNA), their final validation
losses by at most 0.5% and 1.8%."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.models import DNA2RNAAE, RNA2DNAAE
from vae_los_angeles_torch.models import directional_ae as pae
from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.training import tasks as port_tasks
from vae_los_angeles_torch.utils.weights import (state_dict_from_jax, tree_from_numpy,
                                                 tree_to_numpy)
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.models import directional_ae as jae
from vae_los_angeles_tpu.ops import losses as jax_losses
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt
from vae_los_angeles_tpu.training import engine as jax_engine
from vae_los_angeles_tpu.training import tasks as jax_tasks

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED, BATCH = 40, 56, 5, 8, 6, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=BATCH)
LAYER = dict(atol=1e-5, rtol=1e-5)
CHAIN = dict(atol=1e-4, rtol=1e-4)
# model type: (JAX init, JAX apply, port module, port apply, input keyword, input width)
FAMILIES = {
    "rna2dna_ae": (jae.rna2dna_ae_init, jae.rna2dna_ae_apply, RNA2DNAAE, pae.rna2dna_ae_apply,
                   "rna", DIM_A),
    "dna2rna_ae": (jae.dna2rna_ae_init, jae.dna2rna_ae_apply, DNA2RNAAE, pae.dna2rna_ae_apply,
                   "dna", DIM_B),
}


def make_pair(model_type, seed=0):
    """JAX (params, state) as numpy, with randomized BN statistics, and the
    port module holding the same weights."""
    init, _, model_cls, _, _, _ = FAMILIES[model_type]
    params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    state = jax.tree.map(
        lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state)
    params, state = jax.tree.map(np.asarray, (params, state))
    model = model_cls(DIM_A, DIM_B, N_SITES, LATENT, EMBED).eval()
    model.load_state_dict(state_dict_from_jax(params, state, model_type), strict=True)
    return params, state, model


def inputs(din, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, din)).astype(np.float32),
            rng.integers(0, N_SITES, size=(n,)))


def jax_masks(model_type, key, n):
    """The dropout masks the JAX apply draws from ``key`` (RNA2DNAAE: the key
    itself; DNA2RNAAE: the two halves of its split), as port keywords."""
    if model_type == "rna2dna_ae":
        masks = {"drop_mask": jax.random.bernoulli(key, 0.9, (n, 128))}
    else:
        k1, k2 = jax.random.split(key)
        masks = {"drop_mask1": jax.random.bernoulli(k1, 0.9, (n, 512)),
                 "drop_mask2": jax.random.bernoulli(k2, 0.9, (n, 256))}
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in masks.items()}


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
@pytest.mark.parametrize("with_site", [True, False])
def test_eval_forward_matches_the_jax_apply(model_type, with_site):
    """The module and the functional apply in eval mode, with and without a
    site, against the JAX apply."""
    _, j_apply, _, p_apply, kw, din = FAMILIES[model_type]
    params, state, model = make_pair(model_type)
    x, site = inputs(din)
    s = site if with_site else None
    want = j_apply(params, state, None, site=None if s is None else jnp.asarray(s), train=False,
                   **{kw: jnp.asarray(x)})
    ps = None if s is None else torch.from_numpy(s)
    with torch.no_grad():
        recon, logits, latent = model(**{kw: torch.from_numpy(x)}, site=ps)
        out = p_apply(tree_from_numpy(params), tree_from_numpy(state), site=ps, train=False,
                      **{kw: torch.from_numpy(x)})
    for got in ((recon, logits, latent), out[:3]):
        for a, b in zip(got, (want.recon, want.recon_logits, want.latent)):
            close(a, b, CHAIN)
    assert out.state.keys() == state.keys()


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_site_only_forward_and_at_least_one_input(model_type):
    _, j_apply, _, p_apply, kw, _ = FAMILIES[model_type]
    params, state, model = make_pair(model_type)
    _, site = inputs(4)
    want = j_apply(params, state, None, site=jnp.asarray(site), train=False)
    with torch.no_grad():
        recon, _, latent = model(site=torch.from_numpy(site))
        out = p_apply(tree_from_numpy(params), tree_from_numpy(state),
                      site=torch.from_numpy(site))
    close(latent, want.latent, LAYER)
    close(out.latent, want.latent, LAYER)
    close(recon, want.recon, CHAIN)
    close(out.recon, want.recon, CHAIN)
    with pytest.raises(ValueError, match=f"at least one of {kw}/site"):
        model()
    with pytest.raises(ValueError, match=f"at least one of {kw}/site"):
        p_apply(tree_from_numpy(params), tree_from_numpy(state))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_train_forward_with_the_jax_noise(model_type):
    """The train-mode applies: recon, logits, the fused latent and every
    BatchNorm's new running statistics, given the masks drawn from the JAX
    key as the JAX apply draws them."""
    _, j_apply, _, p_apply, kw, din = FAMILIES[model_type]
    params, state, _ = make_pair(model_type, seed=2)
    x, site = inputs(din, seed=3)
    key = jax.random.PRNGKey(5)
    want = j_apply(params, state, key, site=jnp.asarray(site), train=True,
                   **{kw: jnp.asarray(x)})
    got = p_apply(tree_from_numpy(params), tree_from_numpy(state), site=torch.from_numpy(site),
                  train=True, **jax_masks(model_type, key, len(x)), **{kw: torch.from_numpy(x)})
    for a, b in zip(got[:3], (want.recon, want.recon_logits, want.latent)):
        close(a, b, CHAIN)
    for bn, stats in jax.tree.map(np.asarray, want.state).items():
        for k, w in stats.items():
            close(got.state[bn][k], w, LAYER)
    # without injected masks a generator draws them, reproducibly
    a, b = (p_apply(tree_from_numpy(params), tree_from_numpy(state), train=True,
                    generator=torch.Generator().manual_seed(1), **{kw: torch.from_numpy(x)})
            for _ in range(2))
    assert torch.equal(a.recon, b.recon)


def test_dna2rna_ae_flattens_its_input():
    params, state, model = make_pair("dna2rna_ae")
    x, site = inputs(DIM_B)
    x3 = x.reshape(len(x), 7, 8)
    want = jae.dna2rna_ae_apply(params, state, None, dna=jnp.asarray(x3), site=jnp.asarray(site))
    with torch.no_grad():
        recon, _, _ = model(dna=torch.from_numpy(x3), site=torch.from_numpy(site))
        flat, _, _ = model(dna=torch.from_numpy(x), site=torch.from_numpy(site))
    close(recon, want.recon, CHAIN)
    assert torch.equal(recon, flat)


def test_losses_match_the_jax_losses():
    rng = np.random.default_rng(7)
    logits = rng.normal(scale=3.0, size=(9, DIM_B)).astype(np.float32)
    dna = rng.uniform(size=(9, DIM_B)).astype(np.float32)
    rna = rng.normal(size=(9, DIM_A)).astype(np.float32)
    recon = rng.normal(size=(9, DIM_A)).astype(np.float32)
    for p_loss, j_loss, args in (
            (port_losses.rna2dna_ae_loss, jax_losses.rna2dna_ae_loss, (logits, dna)),
            (port_losses.dna2rna_ae_loss, jax_losses.dna2rna_ae_loss, (recon, rna))):
        got, aux = p_loss(*map(torch.from_numpy, args))
        want, _ = j_loss(*map(jnp.asarray, args))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        assert aux.keys() == {"recon"} and aux["recon"] is got


def _named(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_task_loss_gradients_predict_and_target(model_type):
    """The tasks of both packages: the train loss and the gradients of every
    parameter (the JAX key's dropout draws injected), the new BatchNorm
    state, the eval loss, the prediction and the target; neither warms β."""
    params, state, _ = make_pair(model_type, seed=4)
    x, site = inputs(DIM_A, n=12, seed=5)
    beta = np.random.default_rng(6).uniform(size=(12, DIM_B)).astype(np.float32)
    jt, pt = jax_tasks.TASKS[model_type], port_tasks.get_task(model_type)
    assert jt.uses_kl_warmup is pt.uses_kl_warmup is False
    j_batch = MultiModalArrays(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(site))
    p_batch = port_tasks.Batch(torch.from_numpy(x), torch.from_numpy(beta),
                               torch.from_numpy(site))
    key = jax.random.PRNGKey(9)
    (j_loss, j_state), j_grads = jax.value_and_grad(
        lambda p: jt.loss(p, state, key, j_batch, 0.0, 1.0, None, True), has_aux=True)(params)
    leaves = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), params)
    masks = jax_masks(model_type, key, len(x))
    p_loss, p_state = pt.loss(leaves, tree_from_numpy(state), p_batch, 0.0, True, **masks)
    np.testing.assert_allclose(p_loss.item(), float(j_loss), rtol=1e-5)
    grads = dict(_named(jax.tree.map(np.asarray, j_grads)))
    named = list(_named(leaves))
    for (path, leaf), g in zip(named, torch.autograd.grad(p_loss, [t for _, t in named])):
        scale = max(float(np.abs(grads[path]).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), grads[path], atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=str(path))
    for path, w in _named(jax.tree.map(np.asarray, j_state)):
        close(dict(_named(p_state))[path], w, LAYER)
    with torch.no_grad():
        p_eval, _ = pt.loss(tree_from_numpy(params), tree_from_numpy(state), p_batch, 0.0, False)
        pred = pt.predict(tree_from_numpy(params), tree_from_numpy(state), p_batch)
    j_eval, _ = jt.loss(params, state, key, j_batch, 0.0, 1.0, None, False)
    np.testing.assert_allclose(p_eval.item(), float(j_eval), rtol=1e-5)
    close(pred, jt.predict(params, state, key, j_batch), CHAIN)
    assert torch.equal(pt.target(p_batch), p_batch.beta if model_type == "rna2dna_ae"
                       else p_batch.tpm)


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=0)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def jax_run(request, cohort):
    """Three epochs of the JAX engine (XLA path) from seeded weights."""
    task = request.param
    tpm, beta, site = cohort
    params, state = FAMILIES[task][0](jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT,
                                      EMBED)
    arrays = lambda s: MultiModalArrays(*(jnp.asarray(a[s]) for a in cohort))  # noqa: E731
    res = jax_engine.fit(task, JaxConfig(**DIMS), arrays(slice(0, 160)), arrays(slice(160, None)),
                         jax.random.PRNGKey(1), N_SITES, num_epochs=3, init_params=params,
                         init_state=state)
    return task, jax.device_get(res), jax.tree.map(np.asarray, (params, state))


def test_fit_agrees_with_the_jax_engine(jax_run, cohort):
    task, res, (params, state) = jax_run
    tpm, beta, site = cohort
    got = port_engine.fit(task, PortConfig(**DIMS), (tpm[:160], beta[:160], site[:160]),
                          (tpm[160:], beta[160:], site[160:]), 1, N_SITES, num_epochs=3,
                          init_params=params, init_state=state, device="cpu")
    assert got.epochs_ran == int(res.epochs_ran) == 3
    np.testing.assert_array_equal(got.betas, np.zeros(3, np.float32))
    np.testing.assert_array_equal(got.betas, np.asarray(res.betas))
    np.testing.assert_array_equal(got.lrs, np.asarray(res.lrs))
    np.testing.assert_allclose(got.train_losses, np.asarray(res.train_losses), rtol=0.05)
    np.testing.assert_allclose(got.val_losses[-1], float(res.val_losses[-1]), rtol=0.05)
    assert got.val_losses[-1] < got.val_losses[0]
    assert int(got.carry["opt"]["step"]) == int(res.carry["opt"]["step"]) == 30
    # the kernel paths stay refused: the AEs have no kernel
    for path in ("fused_step", "fused_epoch"):
        with pytest.raises(ValueError, match="has no fused kernels"):
            port_engine.fit(task, PortConfig(**DIMS), (tpm[:160], beta[:160], site[:160]),
                            (tpm[160:], beta[160:], site[160:]), 1, N_SITES, num_epochs=1,
                            device="cpu", **{path: True})


def test_carry_round_trips_jax_port_jax_exactly(jax_run):
    task, res, _ = jax_run
    carry = jax.tree.map(np.asarray, res.carry)
    back = tree_to_numpy(tree_from_numpy(carry))
    want = dict(_named(carry))
    got = dict(_named(back))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))
    assert set(carry["state"]) == ({"enc_bn"} if task == "rna2dna_ae"
                                   else {"enc_bn1", "enc_bn2"})


@pytest.mark.parametrize("task", sorted(FAMILIES))
def test_run_training_writes_what_load_best_reads(task, cohort, tmp_path, monkeypatch):
    """``run_training(task, task, ...)`` on the CPU: the best checkpoint, the
    resume carry, the run-id file and the metrics under the AE's model name;
    both packages' ``load_best`` read the checkpoint back, and the port's
    module loads it strictly."""
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig(**DIMS, checkpoint_dir=str(tmp_path / "checkpoints"),
                     plots_dir=str(tmp_path / "plots"))
    result, run_id, wall = port_cli.run_training(task, task, cfg=cfg,
                                                 argv=["--epochs", "2", "--seed", "3"],
                                                 data=cohort, n_sites=N_SITES, device="cpu",
                                                 root=str(tmp_path))
    assert result.epochs_ran == 2 and wall > 0 and np.all(result.betas == 0)
    for path in (tmp_path / "checkpoints" / f"best_{task}_{run_id}.npz",
                 tmp_path / "checkpoints" / f"resume_{task}_{run_id}.npz",
                 tmp_path / f"latest_{task}_run_id.txt",
                 tmp_path / "plots" / f"metrics_{task}_{run_id}.jsonl"):
        assert os.path.exists(path), path
    params, state, rid = port_ckpt.load_best(task, checkpoint_dir=cfg.checkpoint_dir,
                                             root=str(tmp_path))
    assert rid == run_id
    saved = dict(_named({"params": params, "state": state}))
    trained = dict(_named({"params": tree_to_numpy(result.params),
                           "state": tree_to_numpy(result.state)}))
    j_params, j_state, _ = jax_ckpt.load_best(task, checkpoint_dir=cfg.checkpoint_dir,
                                              root=str(tmp_path))
    read = dict(_named(jax.tree.map(np.asarray, {"params": j_params, "state": j_state})))
    assert saved.keys() == trained.keys() == read.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(v), trained[k], err_msg=str(k))
        np.testing.assert_array_equal(read[k], trained[k], err_msg=str(k))
    model = FAMILIES[task][2](DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    model.load_state_dict(state_dict_from_jax(params, state, task), strict=True)
    _, _, _, seed = port_ckpt.load_resume(task, run_id, cfg.checkpoint_dir)
    assert seed == 3
