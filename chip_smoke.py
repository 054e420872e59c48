"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. require a CUDA device, check that TF32 is off, print the card's name
     and power limit;
  2. build every hand-written kernel (``vae_los_angeles_torch/csrc``, one
     nvcc per source, all started together) from this checkout, printing the
     build time and ptxas's registers and spills;
  3. hold each kernel against its plain PyTorch version on the card at the
     full model width (RNA 1177, DNA 1211, latent 20, 24 sites, embedding 32):
       * the serving forwards at B in {1, 37, 205, 1600, 4096}, with and
         without a site, z = mu and injected eps, atol = rtol = 1e-4, two
         calls giving the same bits; the same at B in {37, 205} for DNA→RNA
         at DNA inputs of 6,623 and 65,536 (the input sweep) and RNA→DNA at
         a DecoderB output of 65,536 (the output sweep), with each side's
         distance from a float64 run of the plain version printed at 65,536;
         then their Philox mode: statistically, and bit for bit against the
         injected-eps call given `fused_vae.philox_normal_reference`'s draws;
       * the train step at B in {32, 7, 256} with injected noise: loss rtol
         1e-5, the 19 gradients atol 5e-4 + rtol 1e-4, BN stats atol 1e-5;
       * the epoch over 25 steps of 32 rows with injected noise: per-step
         losses rtol 1e-5, params and AdamW m atol 2e-5, BN var atol 2e-4;
         the encoder fc bias and the BN running mean at 2·lr per step
         (0.025): their true gradient through train-mode BatchNorm is zero,
         so each implementation's fp32 cancellation noise becomes Adam steps
         of up to lr in its own direction (the JAX test allows 5e-3 at 20
         steps of small, centred inputs; at the full width it does not hold);
       * the step's and the epoch's inputs are drawn (seed after seed) so
         that no ReLU pre-activation lies near its kink
         (`relu_margins`, float64, relative to the layer's
         largest): 5e-6 for the BN'd encoder units, 5e-7 for the decoder's,
         about 3x the fp32 differences measured there. Nearer, two fp32
         implementations can take different sides and their gradients differ
         by a whole term (seen at B = 32: one flipped unit moved d2w by 0.17);
       * the loss pair at B in {32, 205}, at the short valid prefixes 2, 7,
         17 and 31 rows (what a masked population's short batches hand it;
         timed there too, kernel against plain) and, as the wide paths run it, at
         32 x 450,000 (a training batch) and 103 x 450,000 (the validation
         split of 512 samples), and at 41 x 120,011 with logits and target
         4 bytes past a 16-byte boundary (an odd n, a scalar head and tail,
         more than one pass of the persistent grid): value rtol 1e-5,
         gradients rtol 1e-5 + atol 1e-7; three more forwards of each shape
         give the first call's bits; after the serving timings, one forward
         and one backward at 32 x 450,000 under torch.profiler run one
         device kernel each;
       * the training kernels' Philox noise: the same seed gives the same
         draws, another seed others, the dropout keep rate is 0.9 ± 0.005
         over 2.6e5 draws, eps has mean 0 ± 0.01 and variance 1 ± 0.02, and
         a Philox step equals the injected step given its own draws;
       * the DNA→RNA train step at B in {32, 7, 256} with injected noise:
         loss rtol 1e-5, the 21 gradients atol 1e-3 + rtol 1e-4 (the JAX
         DNA→RNA test's), BN stats atol 1e-5; its epoch over 25 steps of 32
         rows: losses rtol 1e-5, params atol 5e-5, AdamW's m atol 5e-5
         times the tensor's largest |m| (m is in the gradient's units, and
         the MSE sum over 32 x 1177 log-expression targets, ~3.7e5 a step
         here, makes |m| reach ~2e3; fp32 alone moves it by up to 8e-6 of
         that, CPU float32 against float64), BN var atol 2e-4, both encoder
         fc biases and both BN running means at 2·lr·steps; every tensor is
         checked before the first failure is raised;
         its Philox noise as above, for both dropout masks. Away from the
         kinks differently: its two BN blocks have 768 units a row (the
         RNA→DNA encoder 128), so over an epoch's 800 rows no seed clears a
         margin; instead the injected dropout masks drop the few (row, unit)
         cells whose BN output lies within 3e-5 of the kink (relative to the
         layer's largest, walking the plain version's trajectory step by
         step), where a dropped cell gives both versions the same forward
         and gradient on either side, and the decoder layer (no dropout)
         keeps the seed search at 3e-6. Both are ~7x the largest fp32
         error of those layers against float64 at B = 7;
       * both directional epochs (captured CUDA graphs, one cached a task;
         each graph's capture time and launches a step printed) also at the
         widths ``run_training`` trains them beyond the cohort's
         (`compare_wide_epochs`): RNA→DNA at DecoderB widths of 65,536,
         262,144 and 393,216 (below ``engine.WIDE_HEAD_MIN_DIM_B``), DNA→RNA at a DNA
         input of 65,536, 4 steps of 32 each, with the tolerances above,
         except that RNA→DNA's m is held within 2e-5 of each tensor's
         largest |m| (or 1) there: m is in the gradient's units, the BCE sum
         over that many columns makes |m| grow with the width (to ~10^2 at
         262,144), and its dX product sums those columns, so both fp32
         versions sit further from a float64 run in absolute terms
         (``python3 chip_probes.py epoch64``, PERF.md);
       * the tri-modal train step at B in {32, 7, 256} with injected noise
         and class weights in [0.5, 2), γ = 1.7: loss rtol 1e-5, the 39
         gradients atol 1e-3 + rtol 1e-4 (2e-3 for the three encoder fc
         biases feeding BN, as the JAX test), BN stats atol 1e-5, the
         near-kink cells of its three BN blocks (896 units a row) dropped
         and its four decoder ReLU layers (960 units a row) held at 3e-6 by
         the seed search (`mm_clear_kinks`); its epoch against the plain
         version over 4 steps of 32 (the seed search along the plain
         trajectory), then over 25 steps against a chain of the step kernel
         and AdamW (the same phase kernels, so no kink lies between them):
         losses rtol 1e-5, params atol 5e-5, m atol 5e-5 of each tensor's
         largest |m| (or 1), BN var atol 2e-4, the three fc biases and BN
         running means at 2·lr·steps; every tensor is checked before the
         first failure is raised; the epoch is a CUDA graph captured once for
         its shapes, so a second epoch through the same graph, from the
         first one's result with β, γ and lr halved, step0 11, another seed
         and new rows, is held against the plain version from that state
         with the same tolerances (nothing of the first epoch stays baked
         in); its Philox noise as above, for its three dropout masks;
       * the step graphs of RNA→DNA, DNA→RNA and the tri-modal model (one
         captured graph a call, cached a task; `compare_step_graphs`): at
         B = 32, 3 calls of each through one graph with new weights, rows,
         seed, step, β and γ against a fresh plain version (the step
         tolerances above), each call's results unchanged by the next and
         outside the graph's buffers, the three graphs alternating without a
         capture,
         each graph's node count and capture time printed; the Philox
         step at two (seed, step) pairs through one graph equal, loss,
         gradients and BN statistics bit for bit, to the injected step
         given the noise kernels' draws; and programmatic launches (PDL)
         giving the bits of plain stream launches, for the three step graphs
         and the three epoch graphs (4 steps of 32);
       * the wide head (``fused_wide_output_step``) at the whole-methylome
         width, D = 450,000 columns, d_in = 512, at batch 32 and 256, over 3
         chained steps with the state threaded through, from non-zero
         moments (as the JAX test's inputs; from zero moments the first Adam
         step is lr·g/|g|, and a gradient within rounding of 0 can take
         either sign in two fp32 implementations, moving W by 2·lr): W and b
         atol 0.02·lr (where v is small the Adam step amplifies the
         gradient's fp32 differences; measured 4.3e-6 at lr 5e-4), the
         moments and dh within 2e-5 of each tensor's largest magnitude (dh
         sums 450,000 products in another order; measured 3.3e-6), the loss
         rtol 1e-5, the step exactly;
  4. train end to end: ``run_training`` (rna2dna, USE_PALLAS, the card) on
     the 1024-sample synthetic cohort, 3 epochs of 25 steps, the epoch
     kernel once an epoch; then one epoch each of ``engine.fit``'s
     train-step path (its kernel once a step, checked) and plain path (the
     loss kernels' backward); then the same for dna2rna
     (``run_training("dna2rna", "dna2rna")``, its epoch and train-step
     kernels), and, after serving, for the tri-modal model
     (``run_training("multimodal", "multivae", use_class_weights=True)``);
     after evaluating, the directional autoencoders (`phase_autoencoders`,
     which have no kernel): one plain train step of each at B = 32 on the
     card held against the same step on the CPU (the same seeded weights,
     rows and injected dropout masks, fp32 with TF32 off; near-kink BN cells
     dropped through the masks at 3e-5 and decoder ReLU margins of 3e-6 by
     the seed search; loss rtol 1e-5, gradients atol 1e-4 + rtol 1e-4, BN
     statistics atol 1e-5), then ``run_training(task, task)`` with USE_PALLAS
     for 3 epochs (routed to the plain path: no kernel launched), a falling
     validation loss, the checkpoint read back by ``checkpoint.load_best``,
     the validation MSE beside the mean baseline's, and a timed
     ``engine.fit`` epoch; and, after that, the whole-methylome-width regime
     (`phase_train_wide`): RNA→DNA at dim_b = 450,000 on 512 synthetic
     samples, batch 32: ``run_training`` with ``--moments_dtype bfloat16``
     and USE_PALLAS (routed to the plain path) for 2 epochs, then resumed
     for one; ``run_training`` with fp32 AdamW and USE_PALLAS for 2
     epochs, which at this width trains through the wide head kernel once
     a step (``engine.uses_wide_head``, the ``wide`` path), whose
     checkpoint is then served through its loader with USE_PALLAS (the
     serving kernels, one call for the 103 validation rows: the posterior
     and the reconstruction at z = mu within atol = rtol = 1e-4 of the plain
     eval forward; the loader's call split into the rows' copy to the card,
     the kernel call and the results' copy to the host); ``run_training``
     with ``--replicates 3 --optimizer adafactor`` for 2 epochs (the plain
     population path: the loss pair once a member a step at 32 x 450,000,
     and a validation), its ms an epoch and peak device memory, and the
     first step of an Adafactor population of one against ``engine.fit``'s
     at the same seed, every updated tensor within 1e-5 of its largest
     |value|; then ``engine.fit`` for 2 epochs each with fp32 AdamW, bf16 compute, bf16
     moments and Adafactor on the plain path, and with fp32 AdamW on the
     kernel path (the wide head), each after an untimed warm-up epoch,
     from the same initial weights with the rows on the card; each with its
     ms an epoch, samples/s and peak device memory, finite losses and a
     falling train loss, and the loss pair's launches an epoch (the plain
     path: a forward and a backward a step and the validation forward; the
     wide head's path: the validation forward); after the autoencoders, the
     cross-modality CV (`phase_cross_modality_cv`): ``vmap_meta.fit_folds``
     (``mask_sizes=False``: exact size groups) of 5 folds x 3 epochs of
     rna2dna, dna2rna, rna2dna_ae and
     rna2dna_unified at kl_on = 0 on ``--subset 0.99`` of the 1024-sample
     cohort (5 folds of all 1024 leave a one-row last batch, which
     BatchNorm refuses, in the reference too), each member
     against ``engine.fit``'s plain path at its seed on the card (train and
     validation losses rtol 2e-4, the JAX package's population-against-
     sequential tolerance; epochs, best epoch and rates equal), the RNA→DNA
     populations' loss-pair launches exactly a forward a member a step and
     a validation, a backward a member a step; then
     ``cross_modality_cv.main`` (5 folds x 3 epochs, both directions, mean,
     kNN, unified VAE/AE) with its summary table, wall seconds and
     loss-pair launches (each >= 1), ten records of finite metrics; and one
     population epoch of 10 folds on the 8000-sample cohort beside one plain
     epoch of a single member and, for the VAE, one epoch of it through the
     epoch kernel (RNA→DNA VAE and AE; host clock and CUDA events); the
     device busy share and kernels a step of a 10-member population epoch
     and of a single member's (torch.profiler); then the masked-size
     populations (`phase_masked_populations`, the default mode): the same
     folds with ``mask_sizes=True`` for each CV task as one population (two
     exact groups otherwise), each member within rtol 2e-4 of its population
     of one at the same padded maxima, the largest member within it of
     ``engine.fit(masked_sizes=True)``, the RNA→DNA populations' loss pair
     exactly a forward a member a true step and a validation and a backward
     a member a true step (the short batches' calls on their valid rows);
     and one population epoch of 10 folds on an 8004-sample cohort (inner
     training sets of 6482 and 6483 rows) masked against
     ``POP_MASK_SIZES=0`` (two groups), in turns, host clock and CUDA
     events; after the CV, the HPO
     (`phase_hpo`): ``vmap_meta.fit_trials`` of four tri-modal trials (lr,
     weight decay, β and γ each their own, balanced class weights, 3
     epochs) on the 1024-sample cohort's split: each trial alone (a
     population of one) equal to its ``engine.fit`` run bit for bit on the
     card, the 4-trial population's first step within the tri-modal step's
     gradient tolerances of each trial's (atol 1e-3 + rtol 1e-4, 2e-3 for
     the three encoder fc biases feeding BatchNorm), its epochs, best epoch,
     βs and rates equal to the single runs' and its losses' distance from
     them printed (batched products round otherwise, and those biases'
     zero true gradients become ±lr Adam steps, so the trajectories part
     with lr; PERF.md §6); two rungs continued from the carries
     equal to the uninterrupted population bit for bit (all four, and one
     trial alone against its single run), two survivors' distance printed;
     a ``--pad-shapes`` bucket of latents 10, 37 and 100 trained at 100:
     masked mu, logvar, KL and the gradients of every masked weight slice
     exactly 0, each trial alone equal to ``engine.fit`` from its padded
     init bit for bit; ``hpo.main`` (8 trials x 3 epochs, ``--prune-rungs
     2``, then ``--pad-shapes``) with its wall seconds, a finite best value,
     ``best_hyperparameters.json`` and the retrained checkpoint read back,
     no kernel launched (the tri-modal plain path); ``run_training``
     RNA→DNA with ``--replicates 3`` and USE_PALLAS (routed to the plain
     population path), the loss pair exactly once a member a step and a
     validation; one 8-trial population epoch at 8000 samples beside one
     trial's plain epoch (host clock and CUDA events) and, at 1024
     samples, the device busy share and kernels a step of each; last, after
     the wide regime, the shell entry points with no arrays passed
     (`phase_cli`, in ``cli`` under the work directory, USE_PALLAS=1; the
     other phases run with WALL_DETAIL=0, so their runs are counted alone):
     ``main_rna2dna(["--synthetic", "--epochs", "3", "--seed", "0"])``
     writes the port's pandas-free synthetic artifacts and trains from them
     (the RNA→DNA epoch graph dropped first, so its first call captures it
     again): the epoch kernel 6 times (3 epochs, and 3 more in the
     steady-state probe), the loss forward at least once, a stderr wall
     split whose steady-state run is above 0 and at most the compile+run;
     ``python -m vae_los_angeles_torch.train --synthetic --epochs 2
     --profile`` in a subprocess on those artifacts (the tri-modal epoch
     kernel), exit 0 and CUDA kernel events in its Chrome trace; the RNA→DNA
     run's best checkpoint through ``export_main`` (a ``.pt`` that
     ``RNA2DNAVAE`` loads with strict=True) and ``import_main
     --write-run-id`` back, every leaf bit-equal, then served through the
     loader (B0a at least once) within atol = rtol = 1e-4 of the module's
     forward; and the data preparation's native pivot, built with g++, equal
     to a numpy version of it on 100 x 450,000 cells, its host time printed;
  5. serve (USE_PALLAS, so the loaders serve through the kernels):
     ``compare_directional_imputation.main`` on the same cohort's
     validation split, with the RNA2DNAVAE and the DNA2RNAVAE trained in
     phase 4 (through their run-id files), the served posteriors held
     against the unfused modules, each model's MSE beside the mean
     baseline's; then the unmatched cohorts (`phase_clustering`, on the
     same two models): ``reconstruct_unmatched.main`` with USE_PALLAS on
     `unmatched_cohorts` (1024 matched, 128 RNA-only and 128 DNA-only rows;
     exactly one launch of each serving kernel, B0b without a site, each
     cohort within atol = rtol = 1e-4 of the plain eval forward given the
     kernel's Philox draws), ``cluster_reconstructed.main`` on its output
     and ``cluster_imputation_methods.main`` (3 methods x 2 cohorts, each
     cohort one population), every score printed and in range, the summary
     report written; the card's silhouette within 1e-7 of float64 numpy at
     128 x 2388 and its hit equal (a row at a tie within 1e-5 of the k-th
     float64 distance may take either neighbour), the compensated path at
     205 x 450,000 within 1e-7 (its documented contract 5e-4; the plain
     identity's drift printed), each member of a 3-space
     ``cluster_scores_members`` within 1e-6 of its single scores; and at
     1600 x 2388 (CUDA events) the fused scores of one space, the 3-member
     population t-SNE beside 3 single runs and
     ``analyze_cohort_population``, with each main's wall;
     evaluate: ``evaluation.evaluate.main`` on the
     MultiModalVAE trained in phase 4 writes ``evaluation_results.json``
     with two records of finite metrics, each printed beside the mean
     baseline's MSE; the comparison gives six records, the k-NN baseline
     (k = 5) printed beside the mean baseline's and the VAE's MSE. Then the
     downstream site classification (`phase_downstream`): a deep and a
     shallow classifier step at 32 x 2388 (24 classes, a last batch of 26
     rows, injected dropout masks with the near-kink cells dropped, from
     zero moments and from a non-zero Adam state) on the card against the
     CPU, the loss within
     rtol 1e-6, the gradients and a zero-moment first step's m within
     1e-5, its v within 2e-5 and the updated parameters within 1e-6 of
     each tensor's largest entry; ``fit_classifier`` (a population of one)
     equal to the plain 2-D loop `plain_classifier_fit` bit for bit (deep,
     100 epochs with early stopping; shallow, 20 epochs); 5 uneven folds of
     the cohort's 1024 rows: the population's first-step gradients within
     1e-5 of each member's alone, each member's distance from its single
     fit after the full run printed; ``downstream.main`` (no kernel launched: the
     tri-modal loader's plain forward) and ``downstream_directional.main``
     (exactly one launch of each serving kernel, its imputations within
     atol = rtol = 1e-4 of the plain eval forward given the kernel's Philox
     draws, conditioned on the original site codes) with USE_PALLAS, each
     scenario's accuracy and weighted F1 and each main's seconds printed;
     one 20-member deep population epoch on the 8000-sample cohort's 1600
     validation rows beside one member's (host clock, CUDA events) and the
     busy share and kernels a step of each. After
     serving, the kNN baselines and the t-SNE, which have no kernel of
     their own (`compare_knn`, `compare_tsne`): on the same cohort's split
     (819 training rows, the 205 validation rows and 8 copies of training
     rows), both directions, both metrics, both weight modes, the card's
     neighbour sets equal to a float64 numpy brute force (and so to the
     CPU's), except at a tie within 1e-5 of the k-th float64 distance, where
     either set is right (such queries are counted and left out of the
     comparisons below); the card's predictions (k = 20, every k of the grid
     through ``predict_multi_k``, the site-conditioned ones) within atol =
     rtol = 1e-4 of the same code on the CPU, the masked conditioned kNN
     equal to the per-site loop (``models.conditioned_knn``) on the card,
     the 16 grid MSEs (base and conditioned) within rel 1e-5, the copied
     rows predicted as their own targets exactly (distance weights); the
     t-SNE of the 205 RNA validation rows: P within rtol 1e-5 (atol 5e-5 of
     its largest entry), the PCA init within 1e-4 of its largest entry
     after the signs are aligned, the two embeddings' trustworthiness within
     0.02; then ``knn_comparison.main`` with its t-SNE on the directional
     VAEs (USE_PALLAS: "VAE (Cond)" served by the kernels, whose launches
     are checked), three finite per-sample MSE arrays a direction and the
     best grid parameters printed;
  6. time with CUDA events, alternating plain, kernel, kernel, plain (the
     serving calls right after phase 3, before any other profiler session:
     at B in {205, 1600, 4096} beside their bounds, DNA→RNA's at a DNA input
     of 65,536, one call at B = 205 and at B = 1 profiled, device time by
     kernel and kernels a call, and the host cost of a call, its CUDA-event
     time at B = 1 less its device time): the train steps at B = 32, each
     split into host and device (`step_split`: the wrapper's CUDA-event ms
     a call and host µs, its C entry alone back to back and its host µs,
     device µs by kernel, launches a call), one 200-step epoch of each
     model on the 8000-sample cohort, the loss pair
     (the forward at 205 x 1211, 103 x 450,000 and 32 x 450,000, the
     backward at 32 x 1211 and 32 x 450,000, beside their bounds and a
     library composite the port never calls: the forward
     ``F.binary_cross_entropy_with_logits(reduction="sum")`` plus the KLD
     expression, the backward ``sigmoid(l).sub_(t).mul_(g)`` plus the two
     latent terms), and ``torch.optim.AdamW`` (fused) over
     the same 19, 21 or 39 tensors as the yardstick of each epoch's AdamW;
     one profiled epoch of each model
     (``torch.profiler``): device time by kernel, the device's busy and
     idle shares; and ``engine.fit``'s epoch time and samples/s through
     each epoch kernel at the 1024- and 8000-sample cohorts, validation
     included; the wide head at batch 32 and 256 against its plain version
     and the library composite (cuBLAS products, ``torch.sigmoid`` and
     ``torch.optim.AdamW(fused=True)``), profiled once; the kNN grid pass of
     each metric, a predict of 1600 queries, the Gram PCA and a t-SNE of
     1600 rows (1000 steps) on the 8000-sample cohort (`time_knn`); last,
     the kNN grids at the whole-methylome width (`phase_knn_wide`: 1024
     samples at DNA 450,000, both directions, both metrics, base and
     conditioned, each call timed; finite MSEs, 16 queries' neighbour sets
     against a float64 recomputation on the card, the peak device memory).

Each path (serve, reconstruct, evaluate, the two downstream flows, the kNN comparison,
train, train-step, train-plain, the three training paths of dna2rna and of the tri-modal
model, the two autoencoders' runs, the cross-modality CV, the two HPO
searches and the replicates, train-wide and wide, and the shell CLI's run and
the imported checkpoint's serving) is driven with every
launch count set to 0 just before it and read just after. The line before
the last is the kernels' JSON record (times beside bounds computed from
this run's shapes), the last line ``{"ok": true, "device": {...}}``. Work
files go to a temporary directory.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vae_los_angeles_torch import device as device_policy
from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data.splits import (cv_inner_split, kfold_indices, standard_scale,
                                               stratified_kfold_indices, train_val_indices)
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays, unmatched_cohorts
from vae_los_angeles_torch.evaluation import (compare_directional_imputation,
                                              cross_modality_cv, downstream,
                                              downstream_directional, evaluate, hpo,
                                              knn_comparison, loading, reconstruct_unmatched)
from vae_los_angeles_torch.evaluation.clustering import (cluster_imputation_methods,
                                                         cluster_reconstructed)
from vae_los_angeles_torch.evaluation.clustering import common as clustering_common
from vae_los_angeles_torch.evaluation import mlp_classifier as mc
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.models import DNA2RNAAE, DNA2RNAVAE, RNA2DNAAE, RNA2DNAVAE
from vae_los_angeles_torch.models.conditioned_knn import ConditionedKNeighborsRegressor
from vae_los_angeles_torch.models.directional_ae import dna2rna_ae_init, rna2dna_ae_init
from vae_los_angeles_torch.models.directional_vae import (dna2rna_vae_apply, dna2rna_vae_init,
                                                         rna2dna_vae_apply, rna2dna_vae_init)
from vae_los_angeles_torch.models.vae import multimodal_vae_apply, multimodal_vae_init
from vae_los_angeles_torch.ops.kernels import _build
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_loss as fl
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.ops.kernels import fused_vae as fv
from vae_los_angeles_torch.ops.kernels import fused_wide as fw
from vae_los_angeles_torch.ops import cluster_metrics, knn, losses, optim, pca, tsne
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.parallel import vmap_meta
from vae_los_angeles_torch.training import checkpoint, engine
from vae_los_angeles_torch.training.cli import compute_class_weights, main_rna2dna, run_training
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils import native, torch_import
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map
from vae_los_angeles_torch.utils.weights import (jax_from_state_dict, state_dict_from_jax,
                                                 tree_from_numpy)

CFG = Config()  # the live widths: RNA 1177, DNA 1211, latent 20, site embedding 32
N_SITES = 24
TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 on both sides, different summation order
GRAD = dict(atol=5e-4, rtol=1e-4)
BATCHES = (1, 37, 205, 1600, 4096)
WIDE_SERVING = (("dna2rna_fused_forward", 6_623), ("dna2rna_fused_forward", 65_536),
                ("rna2dna_fused_forward", 65_536))  # (kernel, DNA width) held at B = 37, 205
SERVE_TIMED = (205, 1600, 4096)
STEP_BATCHES = (32, 7, 256)
LOSS_BATCHES = (32, 205)
LOSS_SHORT = (2, 7, 17, 31)  # the valid prefixes of a masked population's short batches
EPOCH_STEPS = 25
LR, WD, BETA = 5e-4, 1e-5, 1e-3
PEAK_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCES = ("fused_vae", "fused_train", "fused_loss", "fused_wide")
KERNELS = {
    # name: (wrapper, model, checkpoint name, input width, TPU kernel it replaces)
    "rna2dna_fused_forward": (
        fv.FusedRNA2DNA, RNA2DNAVAE, "rna2dna", CFG.input_dim_a,
        "vae_los_angeles_tpu/ops/pallas/fused_vae.py:156",
    ),
    "dna2rna_fused_forward": (
        fv.FusedDNA2RNA, DNA2RNAVAE, "dna2rna", CFG.input_dim_b,
        "vae_los_angeles_tpu/ops/pallas/fused_vae.py:231",
    ),
}
TRAIN_KERNELS = {
    # name: (source, TPU kernel it replaces, launch counter)
    "rna2dna_train_step": ("vae_los_angeles_torch/csrc/fused_train.cu",
                           "vae_los_angeles_tpu/ops/pallas/fused_train.py:233", ft.launches),
    "rna2dna_train_epoch": ("vae_los_angeles_torch/csrc/fused_train.cu",
                            "vae_los_angeles_tpu/ops/pallas/fused_epoch.py:278", fe.launches),
    "rna2dna_loss_forward": ("vae_los_angeles_torch/csrc/fused_loss.cu",
                             "vae_los_angeles_tpu/ops/pallas/fused_loss.py:77", fl.launches),
    "rna2dna_loss_backward": ("vae_los_angeles_torch/csrc/fused_loss.cu",
                              "vae_los_angeles_tpu/ops/pallas/fused_loss.py:95", fl.launches),
    "dna2rna_train_step": ("vae_los_angeles_torch/csrc/fused_train.cu",
                           "vae_los_angeles_tpu/ops/pallas/fused_train.py:451", ft.launches),
    "dna2rna_train_epoch": ("vae_los_angeles_torch/csrc/fused_train.cu",
                            "vae_los_angeles_tpu/ops/pallas/fused_epoch.py:574", fe.launches),
    "multimodal_train_step": ("vae_los_angeles_torch/csrc/fused_train.cu",
                              "vae_los_angeles_tpu/ops/pallas/fused_train_multimodal.py:317",
                              ft.launches),
    "multimodal_train_epoch": ("vae_los_angeles_torch/csrc/fused_train.cu",
                               "vae_los_angeles_tpu/ops/pallas/fused_epoch_multimodal.py:376",
                               fe.launches),
    "fused_wide_output_step": ("vae_los_angeles_torch/csrc/fused_wide.cu",
                               "vae_los_angeles_tpu/ops/pallas/fused_wide.py:194", fw.launches),
}
GRAD_D2R = dict(atol=1e-3, rtol=1e-4)  # the JAX DNA→RNA step test's (test_pallas_train.py)
D2R = ft.PARAM_ORDER_D2R
MM = ft.PARAM_ORDER_MM
GAMMA = 1.7  # the JAX tri-modal tests' γ (test_pallas_multimodal.py)
H1, H2 = 512, 256  # EncoderB's hidden widths (fixed in both packages)
WIDE_D, WIDE_K = 450_000, 512  # Illumina 450k probes; DecoderB's last hidden width
WIDE_BATCHES = (32, 256)
WIDE_LR, WIDE_WD = 5e-4, 1e-5
WIDE_SAMPLES = 512


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def zero_counts():
    for cls, *_ in KERNELS.values():
        cls.launches = 0
    for counter in (ft.launches, fe.launches, fl.launches, fw.launches):
        for k in counter:
            counter[k] = 0


def read_counts():
    out = {name: spec[0].launches for name, spec in KERNELS.items()}
    out.update({name: spec[2][name] for name, spec in TRAIN_KERNELS.items()})
    return out


def port_model(model_cls, seed, perturb_bn, dna=CFG.input_dim_b):
    """A seeded port-initialised model (CPU, eval) at DNA width ``dna``;
    ``perturb_bn`` moves the BN running stats off their defaults so the
    folding is exercised."""
    g = torch.Generator().manual_seed(seed)
    model = reset_parameters(
        model_cls(CFG.input_dim_a, dna, N_SITES, CFG.latent_dim, CFG.embed_dim), g
    ).eval()
    if perturb_bn:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.uniform_(-0.5, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.uniform_(-0.2, 0.2, generator=g)
    return model


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work, from its
# shapes (fp32 FMA = 2 operations, every other elementwise operation 1; each
# input read once, each output written once)

def serving_work(name, batch, dna=CFG.input_dim_b):
    """The serving call's work at the model's widths, DNA ``dna`` wide (the
    RNA→DNA output, the DNA→RNA input)."""
    l, e, s = CFG.latent_dim, CFG.embed_dim, N_SITES
    if name == "rna2dna_fused_forward":
        din, dout = CFG.input_dim_a, dna
        macs = din * 128 + 2 * 128 * l + 2 * e * l + l * 256 + 256 * 512 + 512 * dout
    else:
        din, dout = dna, CFG.input_dim_a
        macs = din * 512 + 512 * 256 + 2 * 256 * l + 2 * e * l + l * 128 + 128 * dout
    weights = macs + s * e  # every weight read once, biases are rounding
    return 2 * macs * batch, 4 * (weights + batch * (din + dout + 2 * l + 1))


def step_macs():
    """Multiply-adds of the forward products of one RNA2DNAVAE row."""
    l, e = CFG.latent_dim, CFG.embed_dim
    first = CFG.input_dim_a * 128
    return first, first + 2 * 128 * l + 2 * e * l + l * 256 + 256 * 512 + 512 * CFG.input_dim_b


def n_params():
    return sum(v.numel() for v in ft.flatten_params(
        rna2dna_vae_init(torch.Generator().manual_seed(0), CFG.input_dim_a, CFG.input_dim_b,
                         N_SITES, CFG.latent_dim, CFG.embed_dim, "meta")[0]).values())


def step_work(batch):
    first, macs = step_macs()
    # forward, dW of every layer, dX of every layer but the first
    flops = 2 * batch * (macs + macs + (macs - first))
    flops += 30 * batch * (128 + CFG.input_dim_b + 2 * CFG.latent_dim)  # BN, loss, masks
    p = n_params()
    rows = batch * (CFG.input_dim_a + CFG.input_dim_b + 1 + CFG.latent_dim + 128)
    return flops, 4 * (2 * p + rows + 4 * 128 + 1)  # params in, grads out, rows, BN, loss


def epoch_work(n_steps, batch):
    flops, _ = step_work(batch)
    p = n_params()
    rows = n_steps * batch * (CFG.input_dim_a + CFG.input_dim_b + 1)
    return n_steps * (flops + 14 * p), 4 * (6 * p + rows + 4 * 128 + n_steps)


def d2r_macs():
    """Multiply-adds of the forward products of one DNA2RNAVAE row."""
    l, e = CFG.latent_dim, CFG.embed_dim
    first = CFG.input_dim_b * H1
    return first, first + H1 * H2 + 2 * H2 * l + 2 * e * l + l * 128 + 128 * CFG.input_dim_a


def n_params_d2r():
    return sum(v.numel() for v in ft.flatten_params(
        dna2rna_vae_init(torch.Generator().manual_seed(0), CFG.input_dim_a, CFG.input_dim_b,
                         N_SITES, CFG.latent_dim, CFG.embed_dim, "meta")[0], D2R).values())


def step_work_d2r(batch):
    first, macs = d2r_macs()
    flops = 2 * batch * (macs + macs + (macs - first))
    flops += 30 * batch * (H1 + H2 + CFG.input_dim_a + 2 * CFG.latent_dim)  # BN, loss, masks
    p = n_params_d2r()
    rows = batch * (CFG.input_dim_b + CFG.input_dim_a + 1 + CFG.latent_dim + H1 + H2)
    return flops, 4 * (2 * p + rows + 4 * (H1 + H2) + 1)


def epoch_work_d2r(n_steps, batch):
    flops, _ = step_work_d2r(batch)
    p = n_params_d2r()
    rows = n_steps * batch * (CFG.input_dim_b + CFG.input_dim_a + 1)
    return n_steps * (flops + 14 * p), 4 * (6 * p + rows + 4 * (H1 + H2) + n_steps)


def mm_macs():
    """Multiply-adds of the forward products of one MultiModalVAE row, and
    of its two first layers (which have no dX product)."""
    l, e, s = CFG.latent_dim, CFG.embed_dim, N_SITES
    a, b = CFG.input_dim_a, CFG.input_dim_b
    first = a * 128 + b * H1
    return first, (first + 2 * 128 * l + H1 * H2 + 2 * H2 * l + 2 * e * l + l * 128 + 128 * a
                   + l * 256 + 256 * 512 + 512 * b + l * 64 + 64 * s)


def n_params_mm():
    return sum(v.numel() for v in ft.flatten_params(mm_params("meta", 0)[0], MM).values())


def step_work_mm(batch):
    first, macs = mm_macs()
    flops = 2 * batch * (macs + macs + (macs - first))
    units = 128 + H1 + H2 + CFG.input_dim_a + CFG.input_dim_b + N_SITES + 2 * CFG.latent_dim
    flops += 30 * batch * units  # BN, heads, losses, masks
    p = n_params_mm()
    rows = batch * (CFG.input_dim_a + CFG.input_dim_b + 1 + CFG.latent_dim + 128 + H1 + H2)
    return flops, 4 * (2 * p + rows + N_SITES + 4 * (128 + H1 + H2) + 1)


def epoch_work_mm(n_steps, batch):
    flops, _ = step_work_mm(batch)
    p = n_params_mm()
    rows = n_steps * batch * (CFG.input_dim_a + CFG.input_dim_b + 1)
    return (n_steps * (flops + 14 * p),
            4 * (6 * p + rows + N_SITES + 4 * (128 + H1 + H2) + n_steps))


def loss_work(batch, backward, width=CFG.input_dim_b):
    n, nl = batch * width, batch * CFG.latent_dim
    if backward:
        return 5 * n + 6 * nl, 4 * (3 * n + 4 * nl + 2)
    return 6 * n + 6 * nl, 4 * (2 * n + 2 * nl + 3)


def wide_work(batch):
    """The wide head's step: three batch x d_in x D products, the BCE and
    dy per (row, column), 14 operations of AdamW per parameter; W, m and v
    read and written once, the target and h read once, dh written once."""
    kd, nd = WIDE_K * WIDE_D, batch * WIDE_D
    flops = 6 * batch * kd + 12 * nd + 14 * (kd + WIDE_D)
    return flops, 4 * (6 * kd + nd + 2 * batch * WIDE_K + 6 * WIDE_D + 1)


def bound(work):
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 3: compare

def hold_serving(name, fused, batches, g, dev, float64=False):
    """The kernel against its plain version at each batch, with and without
    a site, z = mu and injected eps, at TOL, and a second call's bits equal
    the first's; with ``float64``, each side's largest distance from a
    float64 run of the plain version. Returns the largest |kernel - plain|."""
    cls, worst, far = type(fused), 0.0, [0.0, 0.0]
    f64 = {k: v.double() for k, v in fused.folded.items()} if float64 else None
    for batch in batches:
        x = torch.rand((batch, fused.in_dim), generator=g, device=dev) * 4.0
        site = torch.randint(0, N_SITES, (batch,), generator=g, device=dev)
        eps = torch.randn((batch, CFG.latent_dim), generator=g, device=dev)
        for s in (None, site):
            for noise, e in ((fv.NOISE_NONE, None), (fv.NOISE_EPS, eps)):
                got = fused(x, s, use_noise=e is not None, eps=e)
                again = fused(x, s, use_noise=e is not None, eps=e)
                want = cls._reference(fused.folded, x, s, noise, e, 0)
                torch.cuda.synchronize()
                for out_name, a, b, a2 in zip(("recon", "mu", "logvar"), got, want, again):
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        raise AssertionError(f"{name} B={batch}: bad {out_name}")
                    err = (a - b).abs().max().item()
                    worst = max(worst, err)
                    if not torch.allclose(a, b, **TOL):
                        raise AssertionError(
                            f"{name} in={fused.in_dim} B={batch} site={s is not None} "
                            f"noise={noise}: {out_name} differs from the plain version by "
                            f"{err:.3g}")
                    if not torch.equal(a, a2):
                        raise AssertionError(f"{name} B={batch}: two calls gave other bits")
                if f64 is not None:
                    w64 = cls._reference(f64, x.double(), s, noise,
                                         None if e is None else e.double(), 0)
                    for i, side in enumerate((got, want)):
                        far[i] = max(far[i], max((u.double() - v).abs().max().item()
                                                 for u, v in zip(side, w64)))
    if float64:
        say(f"[compare] {name} in={fused.in_dim} out={fused._dims()[-1]}: largest distance "
            f"from float64, kernel {far[0]:.3e}, plain {far[1]:.3e}")
    return worst


def compare_serving(dev):
    """Serving kernels vs plain versions; returns {name: max_abs_err}."""
    errs = {}
    for k, (name, (cls, model_cls, ckpt, din, _)) in enumerate(KERNELS.items()):
        params, state = jax_from_state_dict(port_model(model_cls, 100 + k, True).state_dict(), ckpt)
        fused = cls(params, state, dev)
        g = torch.Generator(device=dev).manual_seed(200 + k)
        worst = hold_serving(name, fused, BATCHES, g, dev)
        # Philox: reproducible per seed, distinct across seeds, centred on z = mu
        x = torch.rand((256, din), generator=g, device=dev) * 4.0
        site = torch.randint(0, N_SITES, (256,), generator=g, device=dev)
        det = fused(x, site, use_noise=False)[0]
        draws = torch.stack([fused(x, site, seed=s)[0] for s in range(8)])
        again = fused(x, site, seed=0)[0]
        torch.cuda.synchronize()
        if not torch.equal(draws[0], again):
            raise AssertionError(f"{name}: the same seed gave different outputs")
        if torch.equal(draws[0], draws[1]):
            raise AssertionError(f"{name}: different seeds gave the same output")
        err_mean = (draws.mean(0) - det).abs().mean().item()
        err_one = (draws[0] - det).abs().mean().item()
        if not err_mean < err_one:
            raise AssertionError(f"{name}: mean over seeds is not nearer z = mu ({err_mean} >= {err_one})")
        if cls is fv.FusedRNA2DNA and not bool(((draws >= 0) & (draws <= 1)).all()):
            raise AssertionError(f"{name}: recon outside [0, 1]")
        # ... and the very draws of the plain emulation of its Philox4x32-10
        for seed in (0, 7, 2**40 + 3):
            drawn = fused(x, site, seed=seed)
            injected = fused(x, site, eps=fv.philox_normal_reference(seed, 256, CFG.latent_dim,
                                                                     dev))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(drawn, injected)):
                raise AssertionError(f"{name} seed {seed}: the Philox call differs from the "
                                     "injected call given philox_normal_reference's draws")
        errs[name] = worst
        say(f"[compare] {name}: max |kernel - plain| = {worst:.3e} over B={BATCHES}, "
            f"site on/off, noise none/eps (atol=rtol=1e-4), same bits twice; Philox: "
            f"reproducible, seed-dependent, mean-over-8-seeds error {err_mean:.4f} < one draw "
            f"{err_one:.4f}, bit-equal to the injected call given the plain emulation's draws")
    for k, (name, dna) in enumerate(WIDE_SERVING):
        cls, model_cls, ckpt = KERNELS[name][:3]
        params, state = jax_from_state_dict(
            port_model(model_cls, 110 + k, True, dna=dna).state_dict(), ckpt)
        fused = cls(params, state, dev)
        g = torch.Generator(device=dev).manual_seed(210 + k)
        worst = hold_serving(name, fused, (37, 205), g, dev, float64=dna == 65_536)
        errs[name] = max(errs[name], worst)
        plan = fused.plan(205).plan
        say(f"[compare] {name} at DNA {dna}: max |kernel - plain| = {worst:.3e} over B=(37, "
            f"205), site on/off, noise none/eps (atol=rtol=1e-4); {plan.kernels} kernels a call "
            f"(input sweep {plan.in_sweep}, output sweep {plan.out_sweep})")
        del fused
        torch.cuda.empty_cache()
    return errs


def check_close(what, got, want, atol, rtol):
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: differs from the plain version by {err:.3g} "
                             f"(atol {atol}, rtol {rtol})")
    return err


def train_params(dev, seed, dna=CFG.input_dim_b):
    return rna2dna_vae_init(torch.Generator().manual_seed(seed), CFG.input_dim_a, dna, N_SITES,
                            CFG.latent_dim, CFG.embed_dim, dev)


def train_rows(dev, n, seed, dna=CFG.input_dim_b):
    """Rows shaped like the cohort: log-expression in, ``dna`` β-values out."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        x=torch.log1p(torch.rand((n, CFG.input_dim_a), generator=g, device=dev) * 50.0),
        t=torch.rand((n, dna), generator=g, device=dev) * 0.98 + 0.01,
        site=torch.randint(0, N_SITES, (n,), generator=g, device=dev),
        eps=torch.randn((n, CFG.latent_dim), generator=g, device=dev),
        drop=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float(),
    )


def relu_margins(flat, x, site, eps, drop):
    """Smallest |pre-activation| of each of the forward's three ReLUs
    (encoder BN output, decoder layers 1 and 2), relative to that layer's
    largest, computed in float64 from {name: tensor} params.

    Where one is tiny, two fp32 implementations of the step can land on
    different sides of the kink, and their gradients then differ by a whole
    term, not by rounding. A comparison of the kernel with its plain version
    draws its inputs away from that."""
    p = {k: v.double() for k, v in flat.items()}
    a1 = x.double() @ p["w1"] + p["b1"]
    h = (a1 - a1.mean(0)) * torch.rsqrt(torch.square(a1 - a1.mean(0)).mean(0) + 1e-5)
    h = h * p["gamma"] + p["bnbeta"]
    d = torch.relu(h) * drop.double() / ft.KEEP
    e = ft.site_rows(p["emb"], site)
    mu = 0.5 * ((d @ p["wmu"] + p["bmu"]) + (e @ p["smu_w"] + p["smu_b"]))
    lv = 0.5 * ((d @ p["wlv"] + p["blv"]) + (e @ p["slv_w"] + p["slv_b"]))
    u1 = (mu + eps.double() * torch.exp(0.5 * lv)) @ p["d1w"] + p["d1b"]
    u2 = torch.relu(u1) @ p["d2w"] + p["d2b"]
    return tuple((u.abs().min() / u.abs().max()).item() for u in (h, u1, u2))


MARGINS = (5e-6, 5e-7, 5e-7)  # encoder BN/ReLU, decoder layer 1, decoder layer 2


def away_from_kinks(dev, n, seed, margins_of, dna=CFG.input_dim_b):
    """Rows (``train_rows``, ``dna`` wide) from the first seed at or after
    ``seed`` whose ReLU margins (``margins_of(rows)``) all reach MARGINS;
    (rows, seed)."""
    for s in range(seed, seed + 400):
        r = train_rows(dev, n, s, dna)
        if all(m >= t for m, t in zip(margins_of(r), MARGINS)):
            return r, s
    raise AssertionError(f"no rows with ReLU margins of {MARGINS} in 400 seeds from {seed}")


def compare_train_step(dev):
    params, state = train_params(dev, 1)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    worst = 0.0
    for batch in STEP_BATCHES:
        r, seed = away_from_kinks(dev, batch, 1000 * batch, lambda r: relu_margins(
            flat, r["x"], r["site"], r["eps"], r["drop"]))
        loss, grads, new = ft.rna2dna_fused_train_step(
            params, state, r["x"], r["t"], r["site"], N_SITES, beta=BETA, eps=r["eps"],
            drop_mask=r["drop"])
        want = ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                               r["site"], r["eps"], r["drop"], BETA)
        torch.cuda.synchronize()
        check_close(f"train step B={batch} loss", loss, want[0], 0.0, 1e-5)
        got = ft.flatten_params(grads)
        for name, _ in ft.PARAM_ORDER:
            worst = max(worst, check_close(f"train step B={batch} grad {name}", got[name],
                                           want[1][name], **GRAD))
        for k, w in (("mean", want[2]), ("var", want[3])):
            worst = max(worst, check_close(f"train step B={batch} BN {k}",
                                           new["encoder_rna"]["bn"][k], w, 1e-5, 0.0))
        say(f"[compare] rna2dna_train_step B={batch}: rows of seed {seed}")
    say(f"[compare] rna2dna_train_step: max |kernel - plain| = {worst:.3e} over B={STEP_BATCHES} "
        "(loss rtol 1e-5, grads atol 5e-4 + rtol 1e-4, BN atol 1e-5)")
    return worst


def graph_line(task):
    """The capture time and launches a step of ``task``'s cached epoch graph."""
    graph = fe.graphs[task][1]
    return (f"graph captured and instantiated in {graph.capture_seconds * 1e3:.1f} ms, "
            f"{graph.launches_per_step:g} launches a step")


def float64_report(task, dna, got, want, want64, order):
    """Print, for each tensor of an epoch's params and m, its largest
    |plain|, |kernel - plain|, |plain - float64| and |kernel - float64|; then
    the largest of each relative to its tensor's largest (the fc biases
    feeding train-mode BN left out: their true gradient is zero)."""
    worst = {}
    for i, tree in ((1, "params"), (2, "m")):
        flat_got = ft.flatten_params(got[i], order)
        for name, _ in order:
            a, w, z = flat_got[name].double(), want[i][name].double(), want64[i][name]
            top = w.abs().max().item()
            errs = [(a - w).abs().max().item(), (w - z).abs().max().item(),
                    (a - z).abs().max().item()]
            say(f"[epoch64] {task} {dna} {tree} {name}: largest {top:.4g}, kernel-plain "
                f"{errs[0]:.3g}, plain-float64 {errs[1]:.3g}, kernel-float64 {errs[2]:.3g}")
            if name not in ("b1", "b2"):
                for j, what in enumerate(("kernel-plain", "plain-float64", "kernel-float64")):
                    worst[(tree, what)] = max(worst.get((tree, what), 0.0),
                                              errs[j] / max(top, 1e-30))
    say(f"[epoch64] {task} {dna}: largest error relative to the tensor's largest, "
        + "; ".join(f"{t} {w} {v:.3g}" for (t, w), v in worst.items()))


def f64(tree):
    return {k: v.double() for k, v in tree.items()}


def compare_epoch(dev, dna=CFG.input_dim_b, steps=EPOCH_STEPS, seed0=6000, float64=False):
    """The RNA→DNA epoch (a captured graph) against its plain version over
    ``steps`` steps of 32 at DecoderB width ``dna``, from non-zero moments;
    returns the largest |kernel - plain|. With ``float64``, also prints both
    fp32 versions' distance from the plain version run in float64
    (`float64_report`)."""
    params, state = train_params(dev, 2, dna)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    g = torch.Generator(device=dev).manual_seed(5)
    m0 = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-3 for k, v in flat.items()}
    v0 = {k: torch.rand(v.shape, generator=g, device=dev) * 1e-6 for k, v in flat.items()}

    def epoch_margins(r):
        """The smallest ReLU margins over the epoch's steps, along the plain
        version's own trajectory."""
        p, opt, rm, rv = dict(flat), {"step": torch.tensor(7, device=dev), "m": m0, "v": v0}, \
            bn["mean"], bn["var"]
        worst = (1.0, 1.0, 1.0)
        for i in range(steps):
            rows = slice(32 * i, 32 * (i + 1))
            step = relu_margins(p, r["x"][rows], r["site"][rows], r["eps"][rows],
                                   r["drop"][rows])
            worst = tuple(map(min, worst, step))
            if any(m < t for m, t in zip(worst, MARGINS)):
                return worst
            _, grads, rm, rv = ft.rna2dna_train_step_reference(
                p, rm, rv, r["x"][rows], r["t"][rows], r["site"][rows], r["eps"][rows],
                r["drop"][rows], BETA)
            p, opt = optim.adamw_update(p, grads, opt, LR, WD)
        return worst

    r, seed = away_from_kinks(dev, steps * 32, seed0, epoch_margins, dna)
    say(f"[compare] rna2dna_train_epoch, DecoderB {dna} wide: rows of seed {seed}")
    got = fe.rna2dna_fused_epoch(params, ft.unflatten(m0), ft.unflatten(v0), state, r["x"], r["t"],
                                 r["site"], N_SITES, beta=BETA, lr=LR, weight_decay=WD, step0=7,
                                 n_batches=steps, eps_ep=r["eps"], drop_ep=r["drop"])
    kw = dict(seed=0, beta=BETA, lr=LR, weight_decay=WD, step0=7, n_batches=steps)
    want = fe.rna2dna_epoch_reference(flat, m0, v0, bn["mean"], bn["var"], r["x"], r["t"],
                                      r["site"], r["eps"], r["drop"], **kw)
    if float64:
        want64 = fe.rna2dna_epoch_reference(
            f64(flat), f64(m0), f64(v0), *(t.double() for t in (bn["mean"], bn["var"], r["x"],
                                                                r["t"])),
            r["site"], r["eps"].double(), r["drop"].double(), **kw)
        float64_report("rna2dna", dna, got, want, want64, ft.PARAM_ORDER)
        del want64
    torch.cuda.synchronize()
    loose = 2 * LR * steps
    check_close(f"epoch ({dna} wide) losses", got[0], want[0], 0.0, 1e-5)
    worst, worst_loose = 0.0, 0.0
    m_relative = dna != CFG.input_dim_b  # at a wider DecoderB (module docstring)
    for i, tree in ((1, "params"), (2, "m")):
        flat_got = ft.flatten_params(got[i])
        for name, _ in ft.PARAM_ORDER:
            w = want[i][name]
            scale = max(1.0, w.abs().max().item()) if tree == "m" and m_relative else 1.0
            err = check_close(f"epoch ({dna} wide) {tree} {name}", flat_got[name], w,
                              loose if name == "b1" else 2e-5 * scale, 0.0)
            if name == "b1":
                worst_loose = max(worst_loose, err)
            else:
                worst = max(worst, err / scale)
    new_bn = got[4]["encoder_rna"]["bn"]
    worst_loose = max(worst_loose, check_close(f"epoch ({dna} wide) BN mean", new_bn["mean"],
                                               want[4], loose, 0))
    worst = max(worst, check_close(f"epoch ({dna} wide) BN var", new_bn["var"], want[5], 2e-4,
                                   0.0))
    say(f"[compare] rna2dna_train_epoch, DecoderB {dna} wide: {steps} steps; max |kernel - plain| "
        f"= {worst:.3e} over params, m and BN var (atol 2e-5/2e-4; m "
        f"{'of each tensor`s largest |m| (or 1)' if m_relative else 'absolute'}), "
        f"{worst_loose:.3e} over the fc bias and BN mean (atol {loose}); losses rtol 1e-5; "
        f"{graph_line('rna2dna')}")
    return max(worst, worst_loose)


def wide_loss_shapes():
    """The loss pair's shapes on the wide paths: a training batch and the
    whole validation split, at the whole-methylome width."""
    _, va = train_val_indices(WIDE_SAMPLES, CFG.train_test_split, CFG.random_seed)
    return [(CFG.batch_size, WIDE_D), (len(va), WIDE_D)]


LOSS_ODD = (41, 120_011, 1)  # batch, width, offset from a 16-byte boundary (floats)
LOSS_REPEATS = 3


def loss_inputs(dev, batch, width, offset=0, scale=3.0):
    """(logits, target, mu, logvar), seeded by the batch; logits and target
    start ``offset`` floats past a 16-byte boundary (views ``buf[offset:]``)."""
    g = torch.Generator(device=dev).manual_seed(batch)
    n = batch * width
    logits = (torch.randn(n + offset, generator=g, device=dev) * scale)[offset:]
    t = torch.rand(n + offset, generator=g, device=dev)[offset:]
    mu = torch.randn((batch, CFG.latent_dim), generator=g, device=dev)
    lv = torch.randn((batch, CFG.latent_dim), generator=g, device=dev) * 0.5
    return logits.view(batch, width), t.view(batch, width), mu, lv


def compare_loss(dev):
    """The loss pair through its autograd Function against the plain
    versions at every shape (module docstring), and LOSS_REPEATS more
    forwards giving the autograd call's bits."""
    worst = {"rna2dna_loss_forward": 0.0, "rna2dna_loss_backward": 0.0}
    shapes = ([(batch, CFG.input_dim_b, 0) for batch in LOSS_BATCHES + LOSS_SHORT]
              + [(batch, width, 0) for batch, width in wide_loss_shapes()] + [LOSS_ODD])
    for batch, width, offset in shapes:
        logits, t, mu, lv = loss_inputs(dev, batch, width, offset)
        leaves = [a.clone().requires_grad_(True) for a in (logits, mu, lv)]
        if offset:
            leaves[0] = logits.requires_grad_(True)  # the view itself, off the boundary
        beta = torch.tensor(2e-3, device=dev, requires_grad=True)
        val = fl.rna2dna_loss_fused(leaves[0], t, leaves[1], leaves[2], beta)
        grads = torch.autograd.grad(val * 1.3, (*leaves, beta))
        ref, kld = fl.loss_forward_reference(logits.detach(), t, mu, lv, beta.detach())
        g13 = torch.tensor(1.3, device=dev)
        ref_grads = (*fl.loss_backward_reference(logits.detach(), t, mu, lv, beta.detach(), g13),
                     kld * g13)
        again = [torch.stack(fl._forward(logits.detach(), t, mu, lv, beta.detach()))
                 for _ in range(LOSS_REPEATS)]
        torch.cuda.synchronize()
        if not all(torch.equal(a[0], val.detach()) and torch.equal(a, again[0]) for a in again):
            raise AssertionError(f"loss {batch}x{width}: {LOSS_REPEATS} forwards differ from "
                                 f"the first call's bits: {val.item()!r}, "
                                 f"{[a.tolist() for a in again]}")
        worst["rna2dna_loss_forward"] = max(worst["rna2dna_loss_forward"], check_close(
            f"loss {batch}x{width}", val, ref, 0.0, 1e-5))
        for i, (a, b) in enumerate(zip(grads, ref_grads)):
            worst["rna2dna_loss_backward"] = max(worst["rna2dna_loss_backward"], check_close(
                f"loss {batch}x{width} grad {i}", a, b, 1e-7, 1e-5))
        del logits, t, leaves, grads, ref_grads, again
    torch.cuda.empty_cache()
    where = [f"{b}x{w}" + (f" ({4 * o} bytes past a 16-byte boundary)" if o else "")
             for b, w, o in shapes]
    say(f"[compare] loss pair: max |kernel - plain| = {worst['rna2dna_loss_forward']:.3e} "
        f"(forward), {worst['rna2dna_loss_backward']:.3e} (backward) over {', '.join(where)}; "
        f"{1 + LOSS_REPEATS} forwards of each shape bit-equal")
    return worst


def loss_kernels_a_call(dev, card):
    """One forward and one backward at 32 x 450,000 under torch.profiler:
    one device kernel each."""
    logits, t, mu, lv = loss_inputs(dev, CFG.batch_size, WIDE_D)
    b, one = torch.tensor(BETA, device=dev), torch.tensor(1.0, device=dev)
    for name, fn in (("rna2dna_loss_forward", lambda: fl._forward(logits, t, mu, lv, b)),
                     ("rna2dna_loss_backward",
                      lambda: fl._backward(logits, t, mu, lv, b, one))):
        _, rows = profile_call(fn)
        if not rows:
            say(f"[profile] {name}: the profiler caught no device event (kernels a call not "
                f"measured)")
            continue
        kernels = sum(r[1] for r in rows)
        say(f"[profile] {name} {CFG.batch_size}x{WIDE_D}: {kernels} device kernel(s) a call, "
            + ", ".join(f"{short_name(k)} {ms * 1e3:.2f} us" for ms, _, k in rows) + f"; {card}")
        if kernels != 1:
            raise AssertionError(f"{name} ran {kernels} device kernels in one call")


def check_philox(dev):
    eps, keep = ft.philox_noise(7, 3, 2048, 128, CFG.latent_dim, dev)
    again, _ = ft.philox_noise(7, 3, 2048, 128, CFG.latent_dim, dev)
    other, other_keep = ft.philox_noise(8, 3, 2048, 128, CFG.latent_dim, dev)
    rate, mean, var = keep.mean().item(), eps.mean().item(), eps.var().item()
    if not torch.equal(eps, again):
        raise AssertionError("train Philox: the same seed gave different draws")
    if torch.equal(eps, other) or torch.equal(keep, other_keep):
        raise AssertionError("train Philox: different seeds gave the same draws")
    if abs(rate - 0.9) > 0.005 or abs(mean) > 0.01 or abs(var - 1.0) > 0.02:
        raise AssertionError(f"train Philox: keep rate {rate}, eps mean {mean}, var {var}")
    params, state = train_params(dev, 3)
    r = train_rows(dev, 32, 9)
    args = (params, state, r["x"], r["t"], r["site"], N_SITES)
    # the same phases both ways (each mode a graph of its own key): exact
    a = step_values("rna2dna", ft.rna2dna_fused_train_step(*args, seed=5, step=4))
    e, k = ft.philox_noise(5, 4, 32, 128, CFG.latent_dim, dev)
    b = step_values("rna2dna", ft.rna2dna_fused_train_step(*args, eps=e, drop_mask=k))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("train Philox: the Philox step differs from the injected step")
    say(f"[compare] train Philox: keep rate {rate:.5f} over {keep.numel()} draws, eps mean "
        f"{mean:.5f} var {var:.5f} over {eps.numel()}; reproducible, seed-dependent, and the "
        "Philox step graph equals the injected one given its draws (loss, gradients, BN "
        "statistics bit for bit)")


# ---- DNA→RNA ---------------------------------------------------------------

def d2r_params(dev, seed, dna=CFG.input_dim_b):
    return dna2rna_vae_init(torch.Generator().manual_seed(seed), CFG.input_dim_a, dna, N_SITES,
                            CFG.latent_dim, CFG.embed_dim, dev)


def d2r_rows(dev, n, seed, dna=CFG.input_dim_b):
    """Rows shaped like the cohort: ``dna`` β-values in (x), log-expression
    out (t)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        x=torch.rand((n, dna), generator=g, device=dev) * 0.98 + 0.01,
        t=torch.log1p(torch.rand((n, CFG.input_dim_a), generator=g, device=dev) * 50.0),
        site=torch.randint(0, N_SITES, (n,), generator=g, device=dev),
        eps=torch.randn((n, CFG.latent_dim), generator=g, device=dev),
        drop1=(torch.rand((n, H1), generator=g, device=dev) < 0.9).float(),
        drop2=(torch.rand((n, H2), generator=g, device=dev) < 0.9).float(),
    )


D2R_MARGINS = (3e-5, 3e-6)  # BN'd encoder units (masked), decoder layer 1 (seed search)


def clear_block(x, w, b, gamma, beta, mask):
    """One Linear -> train-mode BatchNorm -> ReLU -> dropout block in
    float64 that drops out (in ``mask``, in place) the cells whose BN output
    lies within D2R_MARGINS[0] of the ReLU kink, relative to the layer's
    largest; returns (the block's output, cells dropped)."""
    c = x @ w + b
    c = c - c.mean(0)
    h = c * torch.rsqrt(torch.square(c).mean(0) + 1e-5) * gamma + beta
    near = (h.abs() < D2R_MARGINS[0] * h.abs().max()) & (mask > 0)
    mask[near] = 0.0
    return torch.relu(h) * mask.double() / ft.KEEP, int(near.sum())


def d2r_clear_kinks(flat, r):
    """Drop out (in r's injected masks, in place) the near-kink cells of the
    two BN blocks (`clear_block`); returns (cells dropped, the decoder
    layer's smallest relative margin)."""
    p = {k: v.double() for k, v in flat.items()}
    d1, n1 = clear_block(r["x"].double(), p["w1"], p["b1"], p["gamma1"], p["beta1"], r["drop1"])
    d2, n2 = clear_block(d1, p["w2"], p["b2"], p["gamma2"], p["beta2"], r["drop2"])
    e = ft.site_rows(p["emb"], r["site"])
    mu = 0.5 * ((d2 @ p["wmu"] + p["bmu"]) + (e @ p["smu_w"] + p["smu_b"]))
    lv = 0.5 * ((d2 @ p["wlv"] + p["blv"]) + (e @ p["slv_w"] + p["slv_b"]))
    u1 = (mu + r["eps"].double() * torch.exp(0.5 * lv)) @ p["d1w"] + p["d1b"]
    return n1 + n2, (u1.abs().min() / u1.abs().max()).item()


def away_from_kinks_masked(what, make_rows, clear, plain_step, dev, n, seed, flat, bn, steps=1,
                           m0=None, v0=None, lr=LR, step0=7):
    """Rows (``make_rows(dev, n, seed)``, n = steps * batch for an epoch)
    from the first seed at or after ``seed`` whose decoder margin reaches
    D2R_MARGINS[1] at every step of the plain version's trajectory
    (``plain_step(p, bn, step_rows) -> (grads, bn)``) from (flat, bn, m0,
    v0) with AdamW at ``lr`` from ``step0``, their near-kink BN cells dropped
    (``clear(p, step_rows) -> (cells dropped, decoder margin)``); returns
    (rows, seed, cells dropped). A "cw" entry is shared by every step."""
    batch = n // steps
    for s in range(seed, seed + 400):
        r = make_rows(dev, n, s)
        p, b, dropped, ok = dict(flat), bn, 0, True
        opt = {"step": torch.tensor(step0, device=dev), "m": m0, "v": v0}
        for i in range(steps):
            rows = slice(batch * i, batch * (i + 1))
            step_rows = {k: (v if k == "cw" else v[rows]) for k, v in r.items()}
            more, margin = clear(p, step_rows)
            dropped += more
            if margin < D2R_MARGINS[1]:
                ok = False
                break
            if steps > 1:
                grads, b = plain_step(p, b, step_rows)
                p, opt = optim.adamw_update(p, grads, opt, lr, WD)
        if ok:
            return r, s, dropped
    raise AssertionError(f"no {what} rows with a decoder margin of {D2R_MARGINS[1]} in 400 "
                         f"seeds from {seed}")


def d2r_away_from_kinks(dev, n, seed, flat, bn, steps=1, m0=None, v0=None,
                        dna=CFG.input_dim_b):
    """`away_from_kinks_masked` for DNA→RNA (``d2r_rows``, `d2r_clear_kinks`)."""
    def plain_step(p, b, r):
        _, grads, b = ft.dna2rna_train_step_reference(p, b, r["x"], r["t"], r["site"], r["eps"],
                                                      r["drop1"], r["drop2"], BETA)
        return grads, b

    def make_rows(dev, n, s):
        return d2r_rows(dev, n, s, dna)

    return away_from_kinks_masked("DNA→RNA", make_rows, d2r_clear_kinks, plain_step, dev, n, seed,
                                  flat, bn, steps, m0, v0)


def compare_d2r_step(dev):
    params, state = d2r_params(dev, 11)
    flat, bn = ft.flatten_params(params, D2R), ft.bn_d2r(state)
    worst = 0.0
    for batch in STEP_BATCHES:
        r, seed, dropped = d2r_away_from_kinks(dev, batch, 1000 * batch + 17, flat, bn)
        loss, grads, new = ft.dna2rna_fused_train_step(
            params, state, r["t"], r["x"], r["site"], N_SITES, beta=BETA, eps=r["eps"],
            drop_mask1=r["drop1"], drop_mask2=r["drop2"])
        want = ft.dna2rna_train_step_reference(flat, bn, r["x"], r["t"], r["site"], r["eps"],
                                               r["drop1"], r["drop2"], BETA)
        torch.cuda.synchronize()
        check_close(f"d2r train step B={batch} loss", loss, want[0], 0.0, 1e-5)
        got = ft.flatten_params(grads, D2R)
        for name, _ in D2R:
            worst = max(worst, check_close(f"d2r train step B={batch} grad {name}", got[name],
                                           want[1][name], **GRAD_D2R))
        for k, a, w in zip(("rm1", "rv1", "rm2", "rv2"), ft.bn_d2r(new), want[2]):
            worst = max(worst, check_close(f"d2r train step B={batch} BN {k}", a, w, 1e-5, 0.0))
        say(f"[compare] dna2rna_train_step B={batch}: rows of seed {seed}, {dropped} near-kink "
            "BN cells dropped")
    say(f"[compare] dna2rna_train_step: max |kernel - plain| = {worst:.3e} over B={STEP_BATCHES} "
        "(loss rtol 1e-5, grads atol 1e-3 + rtol 1e-4, BN atol 1e-5)")
    return worst


def compare_d2r_epoch(dev, dna=CFG.input_dim_b, steps=EPOCH_STEPS, seed0=6100, float64=False):
    """The DNA→RNA epoch (a captured graph) against its plain version over
    ``steps`` steps of 32 with a DNA input ``dna`` wide, from non-zero
    moments; returns the largest |kernel - plain| (m relative to each
    tensor's largest). ``float64`` as in `compare_epoch`."""
    params, state = d2r_params(dev, 12, dna)
    flat, bn = ft.flatten_params(params, D2R), ft.bn_d2r(state)
    g = torch.Generator(device=dev).manual_seed(15)
    m0 = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-3 for k, v in flat.items()}
    v0 = {k: torch.rand(v.shape, generator=g, device=dev) * 1e-6 for k, v in flat.items()}
    r, seed, dropped = d2r_away_from_kinks(dev, steps * 32, seed0, flat, bn, steps, m0, v0, dna)
    say(f"[compare] dna2rna_train_epoch, DNA input {dna} wide: rows of seed {seed}, {dropped} "
        "near-kink BN cells dropped")
    got = fe.dna2rna_fused_epoch(params, ft.unflatten(m0, D2R), ft.unflatten(v0, D2R), state,
                                 r["x"], r["t"], r["site"], N_SITES, beta=BETA, lr=LR,
                                 weight_decay=WD, step0=7, n_batches=steps, eps_ep=r["eps"],
                                 drop1_ep=r["drop1"], drop2_ep=r["drop2"])
    kw = dict(seed=0, beta=BETA, lr=LR, weight_decay=WD, step0=7, n_batches=steps)
    want = fe.dna2rna_epoch_reference(flat, m0, v0, bn, r["x"], r["t"], r["site"], r["eps"],
                                      r["drop1"], r["drop2"], **kw)
    if float64:
        want64 = fe.dna2rna_epoch_reference(
            f64(flat), f64(m0), f64(v0), tuple(b.double() for b in bn), r["x"].double(),
            r["t"].double(), r["site"], *(r[k].double() for k in ("eps", "drop1", "drop2")), **kw)
        float64_report("dna2rna", dna, got, want, want64, D2R)
        del want64
    torch.cuda.synchronize()
    loose = 2 * LR * steps
    check_close(f"d2r epoch ({dna} wide) losses", got[0], want[0], 0.0, 1e-5)
    checks = []  # (what, kernel, plain, atol or None for `loose`, scale of the tensor)
    for i, tree in ((1, "params"), (2, "m")):
        flat_got = ft.flatten_params(got[i], D2R)
        for name, _ in D2R:
            w = want[i][name]
            scale = w.abs().max().item() if tree == "m" else 1.0
            checks.append((f"{tree} {name}", flat_got[name], w,
                           None if name in ("b1", "b2") else 5e-5 * scale, scale))
    for k, a, w in zip(("rm1", "rv1", "rm2", "rv2"), ft.bn_d2r(got[4]), want[4]):
        checks.append((f"BN {k}", a, w, None if k.startswith("rm") else 2e-4, 1.0))
    failed, worst, worst_loose = [], 0.0, 0.0
    for what, a, w, atol, scale in checks:
        err = (a - w).abs().max().item()
        if not (torch.isfinite(a).all() and err <= (loose if atol is None else atol)):
            failed.append(f"{what} by {err:.3g} (atol {loose if atol is None else atol:.3g})")
        if atol is None:
            worst_loose = max(worst_loose, err)
        else:
            worst = max(worst, err / scale)
    if failed:
        raise AssertionError(f"d2r epoch ({dna} wide) differs from the plain version: "
                             + "; ".join(failed))
    say(f"[compare] dna2rna_train_epoch, DNA input {dna} wide: {steps} steps; max |kernel - plain| "
        f"= {worst:.3e} over params and BN var (atol 5e-5/2e-4) and m relative to each tensor's "
        f"largest (5e-5), {worst_loose:.3e} over both fc biases and BN means (atol {loose}); "
        f"losses rtol 1e-5; {graph_line('dna2rna')}")
    return max(worst, worst_loose)


WIDE_HOLDS = (65_536, 262_144, 393_216)  # DecoderB widths below engine.WIDE_HEAD_MIN_DIM_B
WIDE_HOLD_STEPS = 4


def compare_wide_epochs(dev, float64=False):
    """The directional epoch graphs at the widths the CLI trains them on the
    kernel path, beyond the cohort's: B2 (RNA→DNA) at DecoderB widths of
    65,536, 262,144 and 393,216 (``run_training`` with USE_PALLAS takes B2
    below ``engine.WIDE_HEAD_MIN_DIM_B``, 450,000), B5 (DNA→RNA, any DNA width)
    at a DNA input of 65,536, each over 4 steps of 32 with injected noise,
    rows away from the ReLU kinks, at `compare_epoch`'s and
    `compare_d2r_epoch`'s tolerances.

    Memory at 262,144: DecoderB's output layer is 512 x 262,144 = 134.2 M
    floats (537 MB), so p, m and v and the gradients are ~2.15 GB on each
    side; the kernel adds its graph's copies of p, m and v (1.6 GB) and the
    results cloned out of them (1.6 GB), the plain version a float64 copy of
    p for the margins (1.07 GB) and each step's new p, m and v; ~10 GB in
    all; at 393,216 half as much again. Both sides and the graph are freed
    before the next width. ``float64`` as in `compare_epoch` (~1.5x the
    memory)."""
    for dna in WIDE_HOLDS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        compare_epoch(dev, dna, WIDE_HOLD_STEPS, seed0=6500, float64=float64)
        fe.graphs.pop("rna2dna", None)
        say(f"[compare] rna2dna_train_epoch, DecoderB {dna} wide: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (kernel and plain version)")
    torch.cuda.empty_cache()
    compare_d2r_epoch(dev, WIDE_HOLDS[0], WIDE_HOLD_STEPS, seed0=6600, float64=float64)
    fe.graphs.pop("dna2rna", None)
    torch.cuda.empty_cache()


def check_philox_d2r(dev):
    eps, keep1, keep2 = ft.philox_noise_d2r(7, 3, 512, H1, H2, CFG.latent_dim, dev)
    again = ft.philox_noise_d2r(7, 3, 512, H1, H2, CFG.latent_dim, dev)
    other = ft.philox_noise_d2r(8, 3, 512, H1, H2, CFG.latent_dim, dev)
    if not all(torch.equal(a, b) for a, b in zip((eps, keep1, keep2), again)):
        raise AssertionError("d2r Philox: the same seed gave different draws")
    if any(torch.equal(a, b) for a, b in zip((eps, keep1, keep2), other)):
        raise AssertionError("d2r Philox: different seeds gave the same draws")
    if torch.equal(keep1[:, :H2], keep2):
        raise AssertionError("d2r Philox: the two dropout layers drew the same masks")
    rates = [k.mean().item() for k in (keep1, keep2)]
    mean, var = eps.mean().item(), eps.var().item()
    if any(abs(x - 0.9) > 0.005 for x in rates) or abs(mean) > 0.05 or abs(var - 1.0) > 0.05:
        raise AssertionError(f"d2r Philox: keep rates {rates}, eps mean {mean}, var {var}")
    params, state = d2r_params(dev, 13)
    r = d2r_rows(dev, 32, 19)
    inp = (params, state, r)
    for seed, step in PHILOX_STEPS:  # through one Philox graph: the step index from its args
        a = step_values("dna2rna", step_call(ft, "dna2rna", inp, seed, step)())
        e, k1, k2 = ft.philox_noise_d2r(seed, step, 32, H1, H2, CFG.latent_dim, dev)
        b = step_values("dna2rna", step_call(ft, "dna2rna", (params, state, dict(
            r, eps=e, drop1=k1, drop2=k2)), injected=True)())
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"d2r Philox: the Philox step at (seed, step) = ({seed}, "
                                 f"{step}) differs from the injected step given the noise "
                                 "kernels' draws")
    say(f"[compare] d2r Philox: keep rates {rates[0]:.5f} ({keep1.numel()} draws) and "
        f"{rates[1]:.5f} ({keep2.numel()}), eps mean {mean:.5f} var {var:.5f} over {eps.numel()}; "
        "reproducible, seed-dependent, a stream for each dropout layer, and the step graph's "
        f"Philox draws at (seed, step) in {PHILOX_STEPS} are the noise kernels' bit for bit "
        "(loss, gradients and BN statistics equal the injected step's)")


# ---- MultiModalVAE -----------------------------------------------------------

def mm_params(dev, seed):
    return multimodal_vae_init(torch.Generator().manual_seed(seed), CFG.input_dim_a,
                               CFG.input_dim_b, N_SITES, CFG.latent_dim, CFG.embed_dim, dev)


def mm_rows(dev, n, seed):
    """Rows shaped like the cohort (log-expression a, β-values b), sites,
    injected noise, and class weights in [0.5, 2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        a=torch.log1p(torch.rand((n, CFG.input_dim_a), generator=g, device=dev) * 50.0),
        b=torch.rand((n, CFG.input_dim_b), generator=g, device=dev) * 0.98 + 0.01,
        site=torch.randint(0, N_SITES, (n,), generator=g, device=dev),
        eps=torch.randn((n, CFG.latent_dim), generator=g, device=dev),
        drop_a=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float(),
        drop_b1=(torch.rand((n, H1), generator=g, device=dev) < 0.9).float(),
        drop_b2=(torch.rand((n, H2), generator=g, device=dev) < 0.9).float(),
        cw=torch.rand(N_SITES, generator=g, device=dev) * 1.5 + 0.5,
    )


MM_NOISE = ("eps", "drop_a", "drop_b1", "drop_b2")
MM_ZERO_GRAD = ("a_b1", "b_b1", "b_b2")  # encoder fc biases feeding train-mode BatchNorm


def mm_clear_kinks(flat, r):
    """`d2r_clear_kinks` for the tri-modal step: the near-kink cells of its
    three BN blocks dropped; returns (cells dropped, the smallest relative
    margin of its four decoder ReLU layers)."""
    p = {k: v.double() for k, v in flat.items()}
    ad, n1 = clear_block(r["a"].double(), p["a_w1"], p["a_b1"], p["a_gamma"], p["a_beta"],
                         r["drop_a"])
    bd1, n2 = clear_block(r["b"].double(), p["b_w1"], p["b_b1"], p["b_gamma1"], p["b_beta1"],
                          r["drop_b1"])
    bd2, n3 = clear_block(bd1, p["b_w2"], p["b_b2"], p["b_gamma2"], p["b_beta2"], r["drop_b2"])
    e = p["emb"][r["site"]]
    mu = ((ad @ p["a_wmu"] + p["a_bmu"]) + (bd2 @ p["b_wmu"] + p["b_bmu"])
          + (e @ p["c_wmu"] + p["c_bmu"])) / 3.0
    lv = ((ad @ p["a_wlv"] + p["a_blv"]) + (bd2 @ p["b_wlv"] + p["b_blv"])
          + (e @ p["c_wlv"] + p["c_blv"])) / 3.0
    z = mu + r["eps"].double() * torch.exp(0.5 * lv)
    ub1 = z @ p["db_w1"] + p["db_b1"]
    us = (z @ p["da_w1"] + p["da_b1"], ub1, torch.relu(ub1) @ p["db_w2"] + p["db_b2"],
          z @ p["dc_w1"] + p["dc_b1"])
    return n1 + n2 + n3, min((u.abs().min() / u.abs().max()).item() for u in us)


def mm_away_from_kinks(dev, n, seed, flat, bn, steps=1, m0=None, v0=None, beta=BETA,
                       gamma=GAMMA, lr=LR, step0=7):
    """`away_from_kinks_masked` for the tri-modal step (``mm_rows``,
    `mm_clear_kinks`)."""
    def plain_step(p, b, r):
        _, grads, b = ft.multimodal_train_step_reference(
            p, b, r["a"], r["b"], r["site"], r["cw"], *(r[k] for k in MM_NOISE), beta, gamma)
        return grads, b

    return away_from_kinks_masked("tri-modal", mm_rows, mm_clear_kinks, plain_step, dev, n, seed,
                                  flat, bn, steps, m0, v0, lr, step0)


def check_all(what, checks):
    """Check every (name, kernel, plain, atol, rtol) before raising the
    first failure; returns the largest |kernel - plain| over the checks
    other than the losses (whose scale is the loss's)."""
    failed, worst = [], 0.0
    for name, a, w, atol, rtol in checks:
        err = (a - w).abs().max().item()
        if not (torch.isfinite(a).all() and torch.allclose(a, w, atol=atol, rtol=rtol)):
            failed.append(f"{name} by {err:.3g} (atol {atol:.3g}, rtol {rtol:.3g})")
        if not name.startswith("loss"):
            worst = max(worst, err)
    if failed:
        raise AssertionError(f"{what} differs from the plain version: " + "; ".join(failed))
    return worst


def compare_mm_step(dev):
    params, state = mm_params(dev, 21)
    flat, bn = ft.flatten_params(params, MM), ft.bn_mm(state)
    worst = 0.0
    for batch in STEP_BATCHES:
        r, seed, dropped = mm_away_from_kinks(dev, batch, 1000 * batch + 31, flat, bn)
        loss, grads, new = ft.multimodal_fused_train_step(
            params, state, r["a"], r["b"], r["site"], N_SITES, beta=BETA, gamma=GAMMA,
            class_weights=r["cw"], **{k: r[k] for k in MM_NOISE})
        want = ft.multimodal_train_step_reference(flat, bn, r["a"], r["b"], r["site"], r["cw"],
                                                  *(r[k] for k in MM_NOISE), BETA, GAMMA)
        torch.cuda.synchronize()
        got = ft.flatten_params(grads, MM)
        checks = [("loss", loss, want[0], 0.0, 1e-5)]
        checks += [(f"grad {name}", got[name], want[1][name],
                    2e-3 if name in MM_ZERO_GRAD else 1e-3, 1e-4) for name, _ in MM]
        checks += [(f"BN {k}", a, w, 1e-5, 0.0) for k, a, w in zip(
            ("a_rm", "a_rv", "b_rm1", "b_rv1", "b_rm2", "b_rv2"), ft.bn_mm(new), want[2])]
        worst = max(worst, check_all(f"multimodal train step B={batch}", checks))
        say(f"[compare] multimodal_train_step B={batch}: rows of seed {seed}, {dropped} near-kink "
            "BN cells dropped")
    say(f"[compare] multimodal_train_step: max |kernel - plain| = {worst:.3e} over "
        f"B={STEP_BATCHES} (loss rtol 1e-5, grads atol 1e-3 (2e-3 for the 3 fc biases feeding "
        "BN) + rtol 1e-4, BN atol 1e-5)")
    return worst


def mm_epoch_checks(got, want, steps):
    """(name, kernel, other, atol, rtol) of an epoch's params, m (relative to
    each tensor's largest |m|), BN stats: the fc biases feeding BN and the
    BN running means at 2·lr·steps."""
    loose = 2 * LR * steps
    checks = []
    for i, tree in ((1, "params"), (2, "m")):
        flat_got = ft.flatten_params(got[i], MM)
        for name, _ in MM:
            w = want[i][name]
            scale = max(w.abs().max().item(), 1.0) if tree == "m" else 1.0
            checks.append((f"{tree} {name}", flat_got[name], w,
                           loose if name in MM_ZERO_GRAD else 5e-5 * scale, 0.0))
    for k, a, w in zip(("a_rm", "a_rv", "b_rm1", "b_rv1", "b_rm2", "b_rv2"), ft.bn_mm(got[4]),
                       want[4]):
        checks.append((f"BN {k}", a, w, loose if "_rm" in k else 2e-4, 0.0))
    return checks


MM_SHORT_STEPS = 4


def compare_mm_epoch(dev):
    """The epoch kernel (a captured CUDA graph) against its plain version
    over a short epoch (the decoder seed search cannot clear 25 steps), then
    a second epoch through the same cached graph from the first one's
    result, with another β, γ, lr, step0, seed and rows, against the plain
    version from the same state (so nothing of the first epoch was baked
    in), then over 25 steps against a chain of the step kernel and AdamW,
    which runs the same phase kernels."""
    params, state = mm_params(dev, 22)
    flat, bn = ft.flatten_params(params, MM), ft.bn_mm(state)
    g = torch.Generator(device=dev).manual_seed(25)
    m0 = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-3 for k, v in flat.items()}
    v0 = {k: torch.rand(v.shape, generator=g, device=dev) * 1e-6 for k, v in flat.items()}
    r, seed, dropped = mm_away_from_kinks(dev, MM_SHORT_STEPS * 32, 6200, flat, bn,
                                          MM_SHORT_STEPS, m0, v0)
    noise = {f"{k.replace('drop_', 'drop')}_ep": r[k] for k in MM_NOISE}
    args = dict(beta=BETA, gamma=GAMMA, lr=LR, weight_decay=WD, step0=7)
    got = fe.multimodal_fused_epoch(params, ft.unflatten(m0, MM), ft.unflatten(v0, MM), state,
                                    r["a"], r["b"], r["site"], N_SITES, class_weights=r["cw"],
                                    n_batches=MM_SHORT_STEPS, **noise, **args)
    want = fe.multimodal_epoch_reference(flat, m0, v0, bn, r["a"], r["b"], r["site"], r["cw"],
                                         tuple(r[k] for k in MM_NOISE), seed=0,
                                         n_batches=MM_SHORT_STEPS, **args)
    torch.cuda.synchronize()
    worst = check_all(f"multimodal epoch ({MM_SHORT_STEPS} steps, plain)",
                      [("losses", got[0], want[0], 0.0, 1e-5)]
                      + mm_epoch_checks(got, want, MM_SHORT_STEPS))
    graph = fe.graphs["multimodal"][1]
    say(f"[compare] multimodal_train_epoch vs plain: {MM_SHORT_STEPS} steps x 32, rows of seed "
        f"{seed}, {dropped} near-kink BN cells dropped; max |kernel - plain| = {worst:.3e}; "
        f"{graph_line('multimodal')}")

    # a second epoch through the same graph: other scalars and rows
    args2 = dict(beta=BETA / 2, gamma=GAMMA / 2, lr=LR / 2, weight_decay=WD, step0=11)
    flat1, m1, v1 = (ft.flatten_params(t, MM) for t in got[1:4])
    bn1 = ft.bn_mm(got[4])
    r, seed2, dropped = mm_away_from_kinks(dev, MM_SHORT_STEPS * 32, 6400, flat1, bn1,
                                           MM_SHORT_STEPS, m1, v1, beta=args2["beta"],
                                           gamma=args2["gamma"], lr=args2["lr"], step0=11)
    noise = {f"{k.replace('drop_', 'drop')}_ep": r[k] for k in MM_NOISE}
    got2 = fe.multimodal_fused_epoch(*got[1:], r["a"], r["b"], r["site"], N_SITES, seed=99,
                                     class_weights=r["cw"], n_batches=MM_SHORT_STEPS, **noise,
                                     **args2)
    if fe.graphs["multimodal"][1] is not graph:
        raise AssertionError("the second epoch of one key captured a new graph")
    want2 = fe.multimodal_epoch_reference(flat1, m1, v1, bn1, r["a"], r["b"], r["site"], r["cw"],
                                          tuple(r[k] for k in MM_NOISE), seed=99,
                                          n_batches=MM_SHORT_STEPS, **args2)
    torch.cuda.synchronize()
    worst = max(worst, check_all(f"multimodal epoch 2 ({MM_SHORT_STEPS} steps, plain)",
                                 [("losses", got2[0], want2[0], 0.0, 1e-5)]
                                 + mm_epoch_checks(got2, want2, MM_SHORT_STEPS)))
    say(f"[compare] multimodal_train_epoch, a second epoch through the same graph (β, γ, lr "
        f"halved, step0 11, seed 99, rows of seed {seed2}, {dropped} near-kink BN cells "
        f"dropped) vs plain from the first epoch's result: max |kernel - plain| = {worst:.3e}")

    # 25 steps: the epoch kernel against the step kernel + AdamW, step by step
    r = mm_rows(dev, EPOCH_STEPS * 32, 6300)
    noise = {f"{k.replace('drop_', 'drop')}_ep": r[k] for k in MM_NOISE}
    got = fe.multimodal_fused_epoch(params, ft.unflatten(m0, MM), ft.unflatten(v0, MM), state,
                                    r["a"], r["b"], r["site"], N_SITES, class_weights=r["cw"],
                                    n_batches=EPOCH_STEPS, **noise, **args)
    p, s = params, state
    opt = {"step": torch.tensor(7, dtype=torch.int32, device=dev), "m": ft.unflatten(m0, MM),
           "v": ft.unflatten(v0, MM)}
    losses = []
    for i in range(EPOCH_STEPS):
        rows = slice(32 * i, 32 * (i + 1))
        loss, grads, s = ft.multimodal_fused_train_step(
            p, s, r["a"][rows], r["b"][rows], r["site"][rows], N_SITES, beta=BETA, gamma=GAMMA,
            class_weights=r["cw"], **{k: r[k][rows] for k in MM_NOISE})
        losses.append(loss)
        p, opt = optim.adamw_update(p, grads, opt, LR, WD)
    chain = (torch.stack(losses), ft.flatten_params(p, MM), ft.flatten_params(opt["m"], MM), None,
             ft.bn_mm(s))
    torch.cuda.synchronize()
    worst_chain = check_all(f"multimodal epoch ({EPOCH_STEPS} steps, step-kernel chain)",
                            [("losses", got[0], chain[0], 0.0, 1e-5)]
                            + mm_epoch_checks(got, chain, EPOCH_STEPS))
    say(f"[compare] multimodal_train_epoch vs the step kernel + AdamW: {EPOCH_STEPS} steps x 32; "
        f"max |epoch - chain| = {worst_chain:.3e} (params atol 5e-5, m 5e-5 of each tensor's "
        f"largest |m|, BN var 2e-4, the 3 fc biases and BN means {2 * LR * EPOCH_STEPS}); losses "
        "rtol 1e-5")
    return max(worst, worst_chain)


def check_philox_mm(dev):
    draws = ft.philox_noise_mm(7, 3, 512, 128, H1, H2, CFG.latent_dim, dev)
    again = ft.philox_noise_mm(7, 3, 512, 128, H1, H2, CFG.latent_dim, dev)
    other = ft.philox_noise_mm(8, 3, 512, 128, H1, H2, CFG.latent_dim, dev)
    if not all(torch.equal(a, b) for a, b in zip(draws, again)):
        raise AssertionError("mm Philox: the same seed gave different draws")
    if any(torch.equal(a, b) for a, b in zip(draws, other)):
        raise AssertionError("mm Philox: different seeds gave the same draws")
    eps, ka, kb1, kb2 = draws
    if (torch.equal(ka, kb1[:, :128]) or torch.equal(kb1[:, :H2], kb2)
            or torch.equal(ka, kb2[:, :128])):
        raise AssertionError("mm Philox: two dropout layers drew the same masks")
    rates = [k.mean().item() for k in (ka, kb1, kb2)]
    big = ft.philox_noise_mm(11, 0, 8192, 128, 8, 8, CFG.latent_dim, dev)[0]
    mean, var = big.mean().item(), big.var().item()
    if any(abs(x - 0.9) > 0.005 for x in rates) or abs(mean) > 0.01 or abs(var - 1.0) > 0.02:
        raise AssertionError(f"mm Philox: keep rates {rates}, eps mean {mean}, var {var}")
    params, state = mm_params(dev, 23)
    r = mm_rows(dev, 32, 29)
    inp = (params, state, r)
    for seed, step in PHILOX_STEPS:  # through one Philox graph: the step index from its args
        a = step_values("multimodal", step_call(ft, "multimodal", inp, seed, step)())
        noise = ft.philox_noise_mm(seed, step, 32, 128, H1, H2, CFG.latent_dim, dev)
        b = step_values("multimodal", step_call(ft, "multimodal", (params, state, dict(
            r, **dict(zip(MM_NOISE, noise)))), injected=True)())
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"mm Philox: the Philox step at (seed, step) = ({seed}, {step}) "
                                 "differs from the injected step given the noise kernels' draws")
    say(f"[compare] mm Philox: keep rates {rates[0]:.5f}, {rates[1]:.5f}, {rates[2]:.5f} "
        f"({ka.numel()}, {kb1.numel()}, {kb2.numel()} draws), eps mean {mean:.5f} var {var:.5f} "
        f"over {big.numel()}; reproducible, seed-dependent, a stream for each dropout layer, "
        f"and the step graph's Philox draws at (seed, step) in {PHILOX_STEPS} are the noise "
        "kernels' bit for bit")


# ---- the step graphs (B4, B6) ------------------------------------------------

PHILOX_STEPS = ((5, 4), (2**40 + 5, 9))  # (seed, step) pairs through one Philox graph
STEP_REPLAYS = 3


def step_values(task, out):
    """[loss, the gradients in order, the BN statistics] of a step wrapper's
    result."""
    if task == "multimodal":
        return [out[0], *ft.flatten_params(out[1], MM).values(), *ft.bn_mm(out[2])]
    if task == "dna2rna":
        return [out[0], *ft.flatten_params(out[1], D2R).values(), *ft.bn_d2r(out[2])]
    bn = out[2]["encoder_rna"]["bn"]
    return [out[0], *ft.flatten_params(out[1]).values(), bn["mean"], bn["var"]]


def replay_case(dev, task, k):
    """Call k of `compare_step_graphs`: new weights, rows away from the kinks
    with their injected noise, β and γ; (inputs, kwargs, [(name, plain,
    atol, rtol)] of every output)."""
    beta, gamma = BETA * (k + 1), GAMMA / (k + 1)
    if task == "rna2dna":
        params, state = train_params(dev, 41 + k)
        flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
        r, _ = away_from_kinks(dev, 32, 6900 + 100 * k, lambda r: relu_margins(
            flat, r["x"], r["site"], r["eps"], r["drop"]))
        loss, grads_want, rm, rv = ft.rna2dna_train_step_reference(
            flat, bn["mean"], bn["var"], r["x"], r["t"], r["site"], r["eps"], r["drop"], beta)
        want = (loss, grads_want, (rm, rv))
        grads = [(f"grad {name}", want[1][name], *GRAD.values()) for name, _ in ft.PARAM_ORDER]
    elif task == "dna2rna":
        params, state = d2r_params(dev, 15 + k)
        flat, bn = ft.flatten_params(params, D2R), ft.bn_d2r(state)
        r, _, _ = d2r_away_from_kinks(dev, 32, 7000 + 100 * k, flat, bn)
        want = ft.dna2rna_train_step_reference(flat, bn, r["x"], r["t"], r["site"], r["eps"],
                                               r["drop1"], r["drop2"], beta)
        grads = [(f"grad {name}", want[1][name], *GRAD_D2R.values()) for name, _ in D2R]
    else:
        params, state = mm_params(dev, 25 + k)
        flat, bn = ft.flatten_params(params, MM), ft.bn_mm(state)
        r, _, _ = mm_away_from_kinks(dev, 32, 7300 + 100 * k, flat, bn)
        want = ft.multimodal_train_step_reference(flat, bn, r["a"], r["b"], r["site"], r["cw"],
                                                  *(r[n] for n in MM_NOISE), beta, gamma)
        grads = [(f"grad {name}", want[1][name], 2e-3 if name in MM_ZERO_GRAD else 1e-3, 1e-4)
                 for name, _ in MM]
    plain = ([("loss", want[0], 0.0, 1e-5)] + grads
             + [(f"BN {i}", w, 1e-5, 0.0) for i, w in enumerate(want[2])])
    return (params, state, r), dict(seed=2**40 + k, step=3 * k, beta=beta, gamma=gamma), plain


@contextlib.contextmanager
def launch_mode(pdl, mod_ft=ft, mod_fe=fe):
    """Graphs captured in this block launch their phases programmatically
    (``pdl``) or as plain stream launches (the private ``pdl`` of
    ``_StepGraph`` and ``_EpochGraph``, whichever a wrapper would choose),
    cached apart from the wrappers' own graphs, which come back after (and
    the block's are freed)."""
    saved = mod_ft._StepGraph, mod_fe._EpochGraph, mod_ft.step_graphs, mod_fe.graphs
    mod_ft._StepGraph = functools.partial(saved[0], pdl=pdl)
    mod_fe._EpochGraph = functools.partial(saved[1], pdl=pdl)
    mod_ft.step_graphs, mod_fe.graphs = {}, {}
    try:
        yield
    finally:
        mod_ft._StepGraph, mod_fe._EpochGraph, mod_ft.step_graphs, mod_fe.graphs = saved


def compare_step_graphs(dev):
    """The RNA→DNA, DNA→RNA and tri-modal steps at B = 32 as their graphs run
    them: STEP_REPLAYS calls of each through one graph (no capture after the
    first), each with new weights, rows, seed, step, β and γ against a fresh
    plain version (the tolerances of `compare_train_step`, `compare_d2r_step`,
    `compare_mm_step`); call k's results unchanged after call k + 1 and
    outside the graph's buffers; the three tasks' graphs alternating without
    a capture; each
    graph's programmatic launches giving the bits of plain stream launches
    (`launch_mode`, the host loop's order); and each epoch graph's over 4
    steps of 32 (the tri-modal wrapper's PDL, the directional ones' plain).
    Returns {kernel: largest |kernel - plain|}."""
    worst = {}
    for task in ft.STEP_GRAPH_TASKS:
        graph, last = None, None
        for k in range(STEP_REPLAYS):
            inp, kw, plain = replay_case(dev, task, k)
            got = step_values(task, step_call(ft, task, inp, kw["seed"], kw["step"],
                                              injected=True, beta=kw["beta"],
                                              gamma=kw["gamma"])())
            g = ft.step_graphs[task][1]
            if graph is not None and g is not graph:
                raise AssertionError(f"{task}: call {k} of one key captured a new graph")
            graph = g
            worst[task] = max(worst.get(task, 0.0), check_all(
                f"{task} step graph, call {k}",
                [(name, a, w, atol, rtol) for a, (name, w, atol, rtol) in zip(got, plain)]))
            lo, hi = g.out.data_ptr(), g.out.data_ptr() + 4 * g.out.numel()
            if any(lo <= t.data_ptr() < hi for t in got):
                raise AssertionError(f"{task}: a result aliases the graph's output buffer")
            if last is not None and not all(torch.equal(a, b) for a, b in zip(*last)):
                raise AssertionError(f"{task}: call {k} changed call {k - 1}'s results")
            last = (got, [t.clone() for t in got])
        say(f"[compare] {task}_train_step graph: {STEP_REPLAYS} calls through one graph "
            f"({graph.nodes} kernels a launch, captured in {graph.capture_seconds * 1e3:.1f} ms) "
            "with new weights, rows, seed, step, β and γ: max |kernel - plain| = "
            f"{worst[task]:.3e}; each call's results unchanged by the next, none in the graph's "
            "buffers")
    calls = {task: step_call(ft, task, replay_case(dev, task, 0)[0], 3, 2)
             for task in ft.STEP_GRAPH_TASKS}
    first = {}
    for _ in range(3):
        for task, call in calls.items():
            out = step_values(task, call())
            graph = ft.step_graphs[task][1]
            if task not in first:
                first[task] = (graph, out)
            elif graph is not first[task][0] or not all(
                    torch.equal(a, b) for a, b in zip(out, first[task][1])):
                raise AssertionError(f"{task}: alternating with the other task's step captured "
                                     "anew or changed its bits")
    say("[compare] the RNA→DNA, DNA→RNA and tri-modal step graphs alternate three times "
        "without a capture, each call giving its task's bits")
    for task, call in calls.items():
        bits = {}
        for pdl in (True, False):
            with launch_mode(pdl):
                bits[pdl] = step_values(task, call())
        if not all(torch.equal(a, b) for a, b in zip(bits[True], bits[False])):
            raise AssertionError(f"{task}: the programmatic step graph differs from plain "
                                 "launches")
    for task, params_of, rows_of in (
            ("rna2dna", lambda: train_params(dev, 31),
             lambda: (lambda r: (r["x"], r["t"], r["site"]))(train_rows(dev, 128, 32))),
            ("dna2rna", lambda: d2r_params(dev, 33),
             lambda: (lambda r: (r["x"], r["t"], r["site"]))(d2r_rows(dev, 128, 34))),
            ("multimodal", lambda: mm_params(dev, 35),
             lambda: (lambda r: (r["a"], r["b"], r["site"]))(mm_rows(dev, 128, 36)))):
        params, state = params_of()
        rows = rows_of()
        order = ft.ORDERS[task]
        zt = ft.unflatten({k: torch.full_like(v, 1e-4) for k, v in
                           ft.flatten_params(params, order).items()}, order)
        fn = getattr(fe, f"{task}_fused_epoch")
        kw = dict(class_weights=torch.linspace(0.5, 2.0, N_SITES, device=dev),
                  gamma=GAMMA) if task == "multimodal" else {}
        bits = {}
        for pdl in (True, False):
            with launch_mode(pdl):
                out = fn(params, zt, zt, state, *rows, N_SITES, seed=3, step0=2, n_batches=4,
                         **kw)
            bits[pdl] = [out[0]] + [t for tree in out[1:] for t in tree_leaves(tree)]
        if not all(torch.equal(a, b) for a, b in zip(bits[True], bits[False])):
            raise AssertionError(f"{task}: the programmatic epoch graph differs from plain "
                                 "launches")
    say("[compare] programmatic launches (PDL) give the bits of plain stream launches: the three "
        "step graphs (weight tiles fetched before each phase waits) and the three epoch graphs "
        "(4 steps of 32)")
    return worst


# ---------------------------------------------------------------------------
# phases 4-5: train, then serve

WIDE_NAMES = ("w", "b", "m_w", "v_w", "m_b", "v_b", "step", "dh", "loss")


def wide_inputs(dev, batch, seed):
    """h, target and the head's state at the full width, drawn as the JAX
    test's ``_inputs`` (non-zero moments), with step 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((batch, WIDE_K), generator=g, device=dev),
            torch.rand((batch, WIDE_D), generator=g, device=dev),
            torch.randn((WIDE_K, WIDE_D), generator=g, device=dev) * 0.05,
            torch.randn((WIDE_D,), generator=g, device=dev) * 0.05,
            torch.randn((WIDE_K, WIDE_D), generator=g, device=dev) * 0.01,
            torch.rand((WIDE_K, WIDE_D), generator=g, device=dev) * 1e-4,
            torch.randn((WIDE_D,), generator=g, device=dev) * 0.01,
            torch.rand((WIDE_D,), generator=g, device=dev) * 1e-4,
            torch.zeros((), dtype=torch.int32, device=dev))


def compare_wide(dev):
    """The wide head against its plain version over 3 chained steps at batch
    32 and 256 (tolerances in the module docstring); returns the largest
    absolute error over W, b, the moments and dh (the loss, ~1e7, is held
    relative)."""
    worst = 0.0
    for batch in WIDE_BATCHES:
        h, t, *state = wide_inputs(dev, batch, batch)
        kern = plain = tuple(state)
        for i in range(3):
            got = fw.fused_wide_output_step(h, t, *kern, WIDE_LR, WIDE_WD)
            want = fw.fused_wide_output_step_reference(h, t, *plain, WIDE_LR, WIDE_WD)
            torch.cuda.synchronize()
            errs = {}
            for name, a, e in zip(WIDE_NAMES, got, want):
                err = float((a.double() - e.double()).abs().max())
                scale = float(e.double().abs().max())
                errs[name] = err
                limit = {"w": 0.02 * WIDE_LR, "b": 0.02 * WIDE_LR, "step": 0.0,
                         "loss": 1e-5 * scale}.get(name, 2e-5 * scale)
                if not err <= limit:
                    raise AssertionError(f"wide head B={batch} step {i}: {name} max |kernel - "
                                         f"plain| {err:.3e} > {limit:.3e}")
                if name not in ("step", "loss"):
                    worst = max(worst, err)
            say(f"[compare] fused_wide_output_step {WIDE_K}x{WIDE_D} B={batch} step {i}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (max |kernel - plain|)")
            kern, plain = got[:7], want[:7]
        del h, t, state, kern, plain, got, want
        torch.cuda.empty_cache()
    return worst



MODEL_OF = {"rna2dna": "rna2dna", "dna2rna": "dna2rna", "multimodal": "multivae"}
SUFFIX = {"rna2dna": "", "dna2rna": "_d2r", "multimodal": "_mm"}


def phase_train(dev, workdir, tpm, beta, site, task="rna2dna"):
    """run_training(task, its model name) through the task's epoch kernel
    (the tri-modal one with balanced class weights, as ``main_multimodal``),
    then the train-step and plain paths of engine.fit; returns the launch
    counts of each path (train, train_step, train_plain; with "_d2r" for
    dna2rna and "_mm" for multimodal) and the run id."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    suffix, model = SUFFIX[task], MODEL_OF[task]
    tri = task == "multimodal"
    zero_counts()
    result, run_id, wall = run_training(task, model, cfg=cfg,
                                        argv=["--epochs", "3", "--seed", "0"],
                                        data=(tpm, beta, site), n_sites=N_SITES, device=dev,
                                        root=workdir, use_class_weights=tri)
    counts = {"train" + suffix: read_counts()}
    launched = counts["train" + suffix][f"{task}_train_epoch"]
    if launched != result.epochs_ran or result.epochs_ran != 3:
        raise AssertionError(f"{task} epoch kernel launched {launched} times in "
                             f"{result.epochs_ran} epochs")
    losses = result.train_losses[: result.epochs_ran]
    if not (np.isfinite(losses).all() and np.isfinite(result.val_losses[:3]).all()):
        raise AssertionError(f"{task}: non-finite losses {losses} {result.val_losses}")
    if not losses[2] < losses[0]:
        raise AssertionError(f"{task}: epoch 3's train loss {losses[2]} is not below epoch 1's "
                             f"{losses[0]}")
    for path in (os.path.join(cfg.checkpoint_dir, f"best_{model}_{run_id}.npz"),
                 os.path.join(cfg.checkpoint_dir, f"resume_{model}_{run_id}.npz"),
                 os.path.join(workdir, f"latest_{model}_run_id.txt"),
                 os.path.join(cfg.plots_dir, f"metrics_{model}_{run_id}.jsonl")):
        if not os.path.exists(path):
            raise AssertionError(f"run_training did not write {path}")
    n_train = len(train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)[0])
    say(f"[train] run_training {task}: 3 epochs of {n_train // cfg.batch_size} steps in "
        f"{wall:.3f} s ({engine.samples_trained(n_train, cfg.batch_size, 3) / wall:,.0f} "
        f"samples/s, first epoch included); train loss {losses.tolist()}, val loss "
        f"{result.val_losses[:3].tolist()}; artifacts written; launches "
        f"{counts['train' + suffix]}")

    tr, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
    cw = compute_class_weights(site[tr], N_SITES) if tri else None
    for path, kw in (("train_step" + suffix, {"fused_step": True}),
                     ("train_plain" + suffix, {})):
        zero_counts()
        res = engine.fit(task, cfg, arrays(tr), arrays(va), 1, N_SITES, num_epochs=1,
                         device=dev, class_weights=cw, **kw)
        counts[path] = read_counts()
        if not np.isfinite(res.val_losses).all():
            raise AssertionError(f"{path}: non-finite validation loss")
        steps = len(tr) // cfg.batch_size
        if kw and counts[path][f"{task}_train_step"] != steps:
            raise AssertionError(f"{path}: {counts[path][f'{task}_train_step']} launches of "
                                 f"{task}_train_step in an epoch of {steps} steps")
        say(f"[train] engine.fit {task} {path}: 1 epoch, val loss "
            f"{float(res.val_losses[0]):.2f}; launches {counts[path]}")
    return counts, run_id


def phase_evaluate(dev, workdir, tpm, beta, site, run_id):
    """``evaluate.main`` on the MultiModalVAE trained in phase 4 (through its
    run-id file): two records of finite metrics in evaluation_results.json,
    each printed beside the mean baseline's MSE; returns the launch counts of
    that run (the tri-modal loader serves through the plain forward)."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"))
    if evaluate.get_run_id(root=workdir) != run_id:
        raise AssertionError("latest_multivae_run_id.txt does not name the trained run")
    zero_counts()
    records = evaluate.main(cfg=cfg, data=(tpm, beta, site), device=dev, root=workdir)
    launches = read_counts()
    path = os.path.join(cfg.plots_dir, "evaluation_results.json")
    with open(path) as f:
        saved = json.load(f)
    if saved["run_id"] != run_id or len(saved["results"]) != 2:
        raise AssertionError(f"{path}: {saved}")
    for rec in saved["results"]:
        for key in ("MSE", "MAE", "CosineSimilarity", "PearsonMean"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"non-finite {key} in {rec['Modality']}")
    _, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    rna_mean, dna_mean = compare_directional_imputation.get_mean_imputation_predictions(
        tpm[va], beta[va])
    for rec, truth, mean in zip(records, (beta[va], tpm[va]), (dna_mean, rna_mean)):
        say(f"[evaluate] MultiModalVAE {rec['Modality']}: MSE {rec['MSE']:.5f} vs mean "
            f"imputation {float(np.mean((truth - mean) ** 2)):.5f}; " + json.dumps(rec))
    say(f"[evaluate] evaluation_results.json written; launches {launches}")
    return launches


# ---- the directional autoencoders (plain path: they have no kernel) ----------

AE_TASKS = ("rna2dna_ae", "dna2rna_ae")
AE_INIT = {"rna2dna_ae": rna2dna_ae_init, "dna2rna_ae": dna2rna_ae_init}
AE_GRAD = dict(atol=1e-4, rtol=1e-4)


def ae_rows(task, dev, n, seed):
    """Rows shaped like the cohort (`train_rows` for RNA→DNA, `d2r_rows` for
    DNA→RNA: ``x`` the input, ``t`` the target) with their dropout masks."""
    return train_rows(dev, n, seed) if task == "rna2dna_ae" else d2r_rows(dev, n, seed)


def ae_batch(task, r):
    """The rows as the task's (tpm, beta, site) batch."""
    tpm, beta = (r["x"], r["t"]) if task == "rna2dna_ae" else (r["t"], r["x"])
    return Batch(tpm, beta, r["site"])


def ae_masks(task, r):
    if task == "rna2dna_ae":
        return {"drop_mask": r["drop"]}
    return {"drop_mask1": r["drop1"], "drop_mask2": r["drop2"]}


def ae_clear_kinks(task, params, r):
    """Drop out (in r's injected masks, in place) the near-kink cells of the
    encoder's BN blocks (`clear_block`), in float64; returns (cells dropped,
    the decoder's smallest relative ReLU margin)."""
    p = tree_map(lambda t: t.double(), params)

    def block(name, bn, h, mask):
        return clear_block(h, p[name]["w"], p[name]["b"], p[bn]["gamma"], p[bn]["beta"], mask)

    if task == "rna2dna_ae":
        d, dropped = block("enc_fc1", "enc_bn", r["x"].double(), r["drop"])
        enc, dec, layers = d @ p["enc_fc2"]["w"] + p["enc_fc2"]["b"], p["decoder_dna"], 2
    else:
        d1, n1 = block("enc_fc1", "enc_bn1", r["x"].double(), r["drop1"])
        d2, n2 = block("enc_fc2", "enc_bn2", d1, r["drop2"])
        dropped = n1 + n2
        enc, dec, layers = d2 @ p["enc_fc3"]["w"] + p["enc_fc3"]["b"], p["decoder_rna"], 1
    site = p["site_embedding"]["table"][r["site"]] @ p["site_projection"]["w"]
    h = 0.5 * (enc + site + p["site_projection"]["b"])
    margin = 1.0
    for i in range(1, layers + 1):
        u = h @ dec[f"fc{i}"]["w"] + dec[f"fc{i}"]["b"]
        margin = min(margin, (u.abs().min() / u.abs().max()).item())
        h = torch.relu(u)
    return dropped, margin


def ae_step(task, params, state, r):
    """One plain train step of an autoencoder task (autograd over its loss,
    β = 0): (loss, [(name, gradient)], new BN state)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, new = get_task(task).loss(leaves, state, ae_batch(task, r), 0.0, True,
                                    **ae_masks(task, r))
    names = [name for name, _ in engine._named_leaves(leaves)]
    return loss.detach(), list(zip(names, torch.autograd.grad(loss, tree_leaves(leaves)))), new


def compare_ae_step(dev):
    """One plain train step of each autoencoder at the live widths (B = 32)
    on the card against the same step on the CPU: the same weights from a
    seed, the same rows and injected dropout masks, fp32 with TF32 off on
    both. The encoder's near-kink BN cells are dropped through the masks
    (3e-5 of each layer's largest, as `d2r_clear_kinks`) and the rows are the
    first seed whose decoder ReLU margins reach 3e-6 (`ae_clear_kinks`): a
    unit on the other side of a kink changes a gradient by a whole term, not
    by rounding. The loss within rtol 1e-5, each gradient within atol 1e-4 +
    rtol 1e-4, the BN running statistics within atol 1e-5. Returns the
    largest gradient difference."""
    worst = 0.0
    for k, task in enumerate(AE_TASKS):
        params, state = AE_INIT[task](torch.Generator().manual_seed(40 + k), CFG.input_dim_a,
                                      CFG.input_dim_b, N_SITES, CFG.latent_dim, CFG.embed_dim,
                                      "cpu")
        for seed in range(7500 + 100 * k, 7900 + 100 * k):
            r = ae_rows(task, "cpu", 32, seed)
            dropped, margin = ae_clear_kinks(task, params, r)
            if margin >= D2R_MARGINS[1]:
                break
        else:
            raise AssertionError(f"{task}: no rows with a decoder margin of {D2R_MARGINS[1]}")
        to = functools.partial(tree_map, lambda t: t.to(dev))
        want = ae_step(task, params, state, r)
        got = ae_step(task, to(params), to(state), {k_: v.to(dev) for k_, v in r.items()})
        torch.cuda.synchronize()
        check_close(f"{task} step loss", got[0].cpu(), want[0], 0.0, 1e-5)
        err = max(check_close(f"{task} step grad {name}", a.cpu(), w, **AE_GRAD)
                  for (name, a), (_, w) in zip(got[1], want[1]))
        worst = max(worst, err)
        for (name, a), (_, w) in zip(engine._named_leaves(got[2]),
                                     engine._named_leaves(want[2])):
            check_close(f"{task} step BN {name}", a.cpu(), w, 1e-5, 0.0)
        say(f"[autoencoders] {task} plain step B=32 on the card against the CPU: rows of seed "
            f"{seed}, {dropped} near-kink BN cells dropped; loss {got[0].item():.4f}; max "
            f"|card - CPU| over {len(got[1])} gradients {err:.3e} (loss rtol 1e-5, grads atol "
            "1e-4 + rtol 1e-4, BN atol 1e-5)")
    return worst


def phase_autoencoders(dev, workdir, tpm, beta, site, card):
    """Both directional autoencoders: `compare_ae_step`, then
    ``run_training(task, task)`` with USE_PALLAS on the 1024-sample cohort, 3
    epochs on the card (routed to the plain path: no kernel launches, the
    CLI's line saying so), a falling validation loss, the checkpoint read
    back by ``checkpoint.load_best`` into the module (strict), and the
    validation split's prediction MSE beside the mean baseline's; then a
    timed ``engine.fit`` of 3 epochs (after that warm run). Returns the
    launch counts of each run ({"train_<task>": counts})."""
    compare_ae_step(dev)
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    tr, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    out = {}
    for task in AE_TASKS:
        zero_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            result, run_id, wall = run_training(task, task, cfg=cfg,
                                                argv=["--epochs", "3", "--seed", "0"],
                                                data=(tpm, beta, site), n_sites=N_SITES,
                                                device=dev, root=workdir)
        out[f"train_{task}"] = counts = read_counts()
        route = f"USE_PALLAS: {task} has no CUDA kernels; using the plain path"
        if route not in log.getvalue() or "path: plain" not in log.getvalue():
            raise AssertionError(f"{task}: run_training did not take the plain path:\n"
                                 + log.getvalue())
        if any(counts.values()):
            raise AssertionError(f"{task}: the plain path launched kernels {counts}")
        val = result.val_losses[: result.epochs_ran]
        if result.epochs_ran != 3 or not np.isfinite(result.train_losses[:3]).all() \
                or not np.isfinite(val).all() or not val[-1] < val[0]:
            raise AssertionError(f"{task}: {result.epochs_ran} epochs, train loss "
                                 f"{result.train_losses}, val loss {result.val_losses}")
        params, state, rid = checkpoint.load_best(task, checkpoint_dir=cfg.checkpoint_dir,
                                                  root=workdir)
        if rid != run_id:
            raise AssertionError(f"{task}: load_best read run {rid}, not {run_id}")
        module = {"rna2dna_ae": RNA2DNAAE, "dna2rna_ae": DNA2RNAAE}[task](
            CFG.input_dim_a, CFG.input_dim_b, N_SITES, CFG.latent_dim, CFG.embed_dim)
        module.load_state_dict(state_dict_from_jax(params, state, task), strict=True)
        for (name, a), (_, b) in zip(engine._named_leaves(tree_from_numpy(params)),
                                     engine._named_leaves(result.params)):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"{task}: the checkpoint's {name} differs")
        t = get_task(task)
        val_rows = Batch(torch.as_tensor(tpm[va]).to(dev), torch.as_tensor(beta[va]).to(dev),
                         torch.as_tensor(site[va]).long().to(dev))
        with torch.no_grad():
            pred = t.predict(tree_from_numpy(params, dev), tree_from_numpy(state, dev),
                             val_rows)
        truth = t.target(val_rows)
        mse = torch.mean(torch.square(pred - truth)).item()
        mean = torch.as_tensor((tpm if task == "dna2rna_ae" else beta)[tr].mean(0)).to(dev)
        base = torch.mean(torch.square(mean - truth)).item()
        if not math.isfinite(mse):
            raise AssertionError(f"{task}: non-finite prediction MSE")

        def fit():
            arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
            return engine.fit(task, cfg, arrays(tr), arrays(va), 0, N_SITES, num_epochs=3,
                              device=dev)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / res.epochs_ran
        rate = engine.samples_trained(len(tr), cfg.batch_size, 1) / ms * 1e3
        say(f"[autoencoders] run_training {task} (USE_PALLAS, routed to the plain path, no kernel "
            f"launched): 3 epochs of {len(tr) // cfg.batch_size} steps in {wall:.3f} s, first "
            f"epoch included; val loss {val[0]:.2f} -> {val[-1]:.2f}, train loss "
            f"{result.train_losses[:3].tolist()}; checkpoint read back by load_best; validation "
            f"MSE {mse:.5f} vs mean imputation {base:.5f}")
        say(f"[autoencoders] engine.fit {task}, plain path, 1024-sample cohort: {ms:.3f} ms per "
            f"epoch over 3 epochs (validation included), {rate:,.0f} samples/s; {card}")
    return out


def _wide_fit_line(what, wall, epochs, n_train, result, card):
    losses = result.train_losses[: result.epochs_ran]
    if result.epochs_ran != epochs or not (np.isfinite(losses).all()
                                           and np.isfinite(result.val_losses[:epochs]).all()):
        raise AssertionError(f"wide {what}: {result.epochs_ran} epochs, losses {losses} "
                             f"{result.val_losses}")
    if epochs > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"wide {what}: train loss {losses.tolist()} does not fall")
    ms = wall * 1e3 / epochs
    rate = engine.samples_trained(n_train, CFG.batch_size, epochs) / wall
    say(f"[train-wide] {what}: {ms:.3f} ms an epoch over {epochs} epochs ({rate:,.0f} samples/s),"
        f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; train loss "
        f"{losses.tolist()}, val loss {result.val_losses[:epochs].tolist()}; {card}")


# ---- the shell entry points, from the port's own artifacts ---------------------

WALL_SPLIT = re.compile(r"compile\+run: ([0-9.]+)s \| steady-state run: ([0-9.]+)s")
PIVOT = (100, 450_000)  # patients x probes of the native pivot's check


@contextlib.contextmanager
def env_set(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pivot_numpy(pat, probe, beta, n_pat, n_probe, n_first):
    """The native pivot's transform in numpy, for rows whose first ``n_first``
    hold each observed cell once (the later rows repeat cells, which the first
    occurrence shadows): each patient's mean summed in probe order (a
    cumulative sum is sequential), then divided by its count."""
    out = np.full(n_pat * n_probe, np.nan)
    out[pat[:n_first].astype(np.int64) * n_probe + probe[:n_first]] = beta[:n_first]
    out = out.reshape(n_pat, n_probe)
    seen = ~np.isnan(out)
    total = np.cumsum(np.where(seen, out, 0.0), axis=1)[:, -1]
    count = seen.sum(axis=1)
    for p in np.flatnonzero(count):
        out[p, ~seen[p]] = total[p] / count[p]
    return out


def check_native_pivot():
    """The data preparation's C++ pivot, built here with g++, against
    `pivot_numpy` on 100 x 450,000 cells: 90% of the cells observed, 5% of
    the betas NaN, 2% of the cells repeated later with other values, one
    patient without a finite value; exactly equal."""
    n_pat, n_probe = PIVOT
    rng = np.random.default_rng(18)
    t0 = time.perf_counter()
    native.load_pivot_impute()
    build_s = time.perf_counter() - t0
    cells = np.flatnonzero(rng.random(n_pat * n_probe) < 0.9)
    cells = cells[rng.permutation(len(cells))]
    repeats = cells[rng.random(len(cells)) < 0.02]
    idx = np.concatenate([cells, repeats])
    beta = rng.random(len(idx))
    beta[rng.random(len(idx)) < 0.05] = np.nan
    pat, probe = (idx // n_probe).astype(np.int32), (idx % n_probe).astype(np.int32)
    beta[pat == 7] = np.nan
    t0 = time.perf_counter()
    got = native.pivot_impute(pat, probe, beta, n_pat, n_probe)
    host_s = time.perf_counter() - t0
    want = pivot_numpy(pat, probe, beta, n_pat, n_probe, len(cells))
    if not np.array_equal(got, want, equal_nan=True):
        bad = ~((got == want) | (np.isnan(got) & np.isnan(want)))
        raise AssertionError(f"native pivot: {int(bad.sum())} of {got.size} cells differ from "
                             "the numpy version")
    if not np.isnan(got[7]).all() or np.isnan(np.delete(got, 7, axis=0)).any():
        raise AssertionError("native pivot: NaN cells outside the patient without values")
    say(f"[cli] native pivot: {n_pat} x {n_probe:,} cells from {len(idx):,} rows equal the numpy "
        f"version exactly; g++ build and load {build_s:.3f} s, pivot {host_s:.3f} s of host time")
    return host_s


def phase_cli(dev, workdir, card):
    """The port's shell entry points with no arrays passed, in ``cli`` under
    the work directory, with USE_PALLAS=1: (a) ``main_rna2dna(["--synthetic",
    "--epochs", "3", "--seed", "0"])`` writes the port's synthetic artifacts
    and trains from them through the RNA→DNA epoch kernel (its cached graph
    dropped first, so the first call captures it), with the stderr wall
    split's steady-state probe (WALL_DETAIL=1: `main` turns it off for the
    other phases, whose launch counts it would double); (b) ``python -m vae_los_angeles_torch.train
    --synthetic --epochs 2 --profile`` in a subprocess, on (a)'s artifacts,
    whose trace holds the card's kernels; (c) (a)'s best checkpoint exported
    to a reference ``.pt`` (loaded strictly into ``RNA2DNAVAE``), imported
    back under the run-id protocol bit for bit, and served through the
    loader (B0a) within TOL of the plain forward; (d) the native pivot.
    Returns the launch counts of (a) and (c)."""
    clidir = os.path.join(workdir, "cli")
    os.makedirs(clidir)
    cwd = os.getcwd()
    os.chdir(clidir)  # the CLI's data/, checkpoints/ and run-id files
    counts = {}
    try:
        t_phase = time.perf_counter()
        # (a) the CLI from the shell's point of view
        torch.cuda.synchronize(dev)
        fe.graphs.pop("rna2dna", None)  # the first call captures its graph again
        err = io.StringIO()
        zero_counts()
        with env_set(USE_PALLAS="1", WALL_DETAIL="1"), contextlib.redirect_stderr(err):
            result, run_id, wall = main_rna2dna(["--synthetic", "--epochs", "3", "--seed", "0"])
        counts["cli"] = read_counts()
        sys.stderr.write(err.getvalue())
        split = WALL_SPLIT.search(err.getvalue())
        if split is None:
            raise AssertionError(
                f"no steady-state figure in the CLI's wall line: {err.getvalue()!r}")
        first, steady = float(split.group(1)), float(split.group(2))
        if not 0 < steady <= first:
            raise AssertionError(f"steady-state run {steady} s against compile+run {first} s")
        # 3 epochs, and 3 more in the steady-state probe
        if counts["cli"]["rna2dna_train_epoch"] != 6 or result.epochs_ran != 3:
            raise AssertionError(f"the CLI launched the epoch kernel "
                                 f"{counts['cli']['rna2dna_train_epoch']} times for 3 epochs "
                                 "and the probe's 3")
        if counts["cli"]["rna2dna_loss_forward"] < 1:
            raise AssertionError("the CLI's validation never launched rna2dna_loss_forward")
        for name in artifacts.ARTIFACTS:
            if not os.path.exists(os.path.join("data", name)):
                raise AssertionError(f"--synthetic did not write data/{name}")
        losses = result.train_losses[:3]
        if not (np.isfinite(losses).all() and losses[2] < losses[0]):
            raise AssertionError(f"CLI train losses {losses}")
        say(f"[cli] main_rna2dna --synthetic --epochs 3: {err.getvalue().strip().splitlines()[-1]}"
            f"; train loss {losses.tolist()}; launches {counts['cli']}; {card}")

        # (b) the tri-modal CLI as a subprocess, profiled
        trace_dir = os.path.join(clidir, "trace")
        root = os.path.dirname(os.path.dirname(os.path.abspath(device_policy.__file__)))
        env = dict(os.environ, USE_PALLAS="1", PYTHONPATH=os.pathsep.join(
            filter(None, (root, os.environ.get("PYTHONPATH")))))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vae_los_angeles_torch.train", "--synthetic", "--epochs", "2",
             "--data_path", os.path.join(clidir, "data", "processed_data.pkl"), "--profile",
             trace_dir], cwd=clidir, env=env, capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m vae_los_angeles_torch.train exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}")
        with open(os.path.join(trace_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels or "path: epoch kernel" not in proc.stdout:
            raise AssertionError(f"the tri-modal CLI's trace holds {len(kernels)} CUDA kernel "
                                 f"events:\n{proc.stdout[-2000:]}")
        say(f"[cli] python -m vae_los_angeles_torch.train --synthetic --epochs 2 --profile: exit 0 "
            f"in {sub_s:.2f} s; {len(kernels)} CUDA kernel events in {traces[0]}; "
            + " ".join(line for line in proc.stderr.splitlines() if line.startswith("backend")))

        # (c) export, import, serve
        cfg = CFG.replace(checkpoint_dir=os.path.join(clidir, "checkpoints"), use_pallas=True)
        best = checkpoint.checkpoint_path("rna2dna", run_id, cfg.checkpoint_dir)
        exported = os.path.join(clidir, "reference", "best_rna2dna_20000101_000000.pt")
        torch_import.export_main([best, "--out", exported])
        sd = torch.load(exported, weights_only=True)
        module = RNA2DNAVAE(CFG.input_dim_a, CFG.input_dim_b, N_SITES, CFG.latent_dim,
                            CFG.embed_dim).eval()
        module.load_state_dict(sd, strict=True)
        torch_import.import_main([exported, "--write-run-id"])
        if checkpoint.get_run_id("rna2dna") != "20000101_000000":
            raise AssertionError("import_main --write-run-id did not register the run")
        (p0, s0), (p1, s1) = (checkpoint.load(best), checkpoint.load(checkpoint.checkpoint_path(
            "rna2dna", "20000101_000000", cfg.checkpoint_dir)))
        a, b = tree_leaves({"p": p0, "s": s0}), tree_leaves({"p": p1, "s": s1})
        if len(a) != len(b) or not all(x.dtype == y.dtype and np.array_equal(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError("the imported checkpoint differs from the trained one")
        table = artifacts.read_table(os.path.join("data", "processed_data.pkl"))
        _, va = train_val_indices(len(table["primary_site_encoded"]), cfg.train_test_split,
                                  cfg.random_seed)
        x, s = table["tpm_unstranded"][va], table["primary_site_encoded"][va]
        zero_counts()
        served = load_rna2dna(cfg=cfg, root=clidir, device=dev)
        _, mu, logvar = served(rna=x, site=s)
        counts["cli_serve"] = read_counts()
        if counts["cli_serve"]["rna2dna_fused_forward"] < 1:
            raise AssertionError("serving the imported checkpoint never launched "
                                 "rna2dna_fused_forward")
        with torch.no_grad():
            ref = module.to(dev)(torch.as_tensor(x).to(dev), torch.as_tensor(s).to(dev),
                                 eps=torch.zeros(len(va), CFG.latent_dim, device=dev))
        for got, want, what in ((mu, ref[2], "mu"), (logvar, ref[3], "logvar")):
            if not np.allclose(got, want.cpu().numpy(), **TOL):
                raise AssertionError(f"imported rna2dna: served {what} differs from the module by "
                                     f"{np.abs(got - want.cpu().numpy()).max():.3g}")
        say(f"[cli] export_main -> {os.path.basename(exported)} ({len(sd)} tensors, strict load), "
            f"import_main --write-run-id: {len(a)} leaves bit-equal; served {len(va)} rows through "
            f"the loader: mu/logvar within TOL of the module; launches {counts['cli_serve']}")

        # (d) the native pivot
        check_native_pivot()
        say(f"[cli] phase wall {time.perf_counter() - t_phase:.2f} s; {card}")
    finally:
        os.chdir(cwd)
    return counts


def phase_train_wide(dev, workdir, card):
    """RNA→DNA at the whole-methylome width (module docstring, phase 4);
    returns the launch counts of the ``run_training`` runs (train_wide) and
    of the wide head's fit (wide)."""
    t0 = time.perf_counter()
    tpm, beta, site = generate_synthetic_arrays(n_samples=WIDE_SAMPLES, dim_b=WIDE_D, seed=5)
    say(f"[train-wide] synthetic cohort {tpm.shape} + {beta.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = CFG.replace(input_dim_b=WIDE_D, checkpoint_dir=os.path.join(workdir, "wide_ckpt"),
                      plots_dir=os.path.join(workdir, "wide_plots"), use_pallas=True)
    tr, va = train_val_indices(WIDE_SAMPLES, cfg.train_test_split, cfg.random_seed)
    counts = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    result, run_id, wall = run_training(
        "rna2dna", "rna2dna", cfg=cfg,
        argv=["--epochs", "2", "--seed", "0", "--moments_dtype", "bfloat16"],
        data=(tpm, beta, site), n_sites=N_SITES, device=dev, root=workdir)
    if result.carry["opt"]["m"]["decoder_dna"]["fc3"]["w"].dtype != torch.bfloat16:
        raise AssertionError("--moments_dtype bfloat16 did not reach the carry")
    for path in (os.path.join(cfg.checkpoint_dir, f"best_rna2dna_{run_id}.npz"),
                 os.path.join(cfg.checkpoint_dir, f"resume_rna2dna_{run_id}.npz"),
                 os.path.join(workdir, "latest_rna2dna_run_id.txt")):
        if not os.path.exists(path):
            raise AssertionError(f"run_training did not write {path}")
    _wide_fit_line("run_training, bf16 moments (USE_PALLAS routed to the plain path; the "
                   "host-side initialisation included)", wall, 2, len(tr), result, card)
    resumed, rid, wall = run_training(
        "rna2dna", "rna2dna", cfg=cfg,
        argv=["--resume", "--epochs", "1", "--moments_dtype", "bfloat16"],
        data=(tpm, beta, site), n_sites=N_SITES, device=dev, root=workdir)
    steps = len(tr) // cfg.batch_size
    if rid != run_id or int(resumed.carry["opt"]["step"]) != 3 * steps:
        raise AssertionError(f"the resumed run {rid} is at step "
                             f"{int(resumed.carry['opt']['step'])}, not {3 * steps}")
    _wide_fit_line("run_training --resume (bf16 moments from the carry; its copy to the card "
                   "included)", wall, 1, len(tr), resumed, card)
    counts["train_wide"] = read_counts()
    if counts["train_wide"]["rna2dna_train_epoch"]:
        raise AssertionError("bf16 moments reached the epoch kernel")
    del result, resumed
    shutil.rmtree(cfg.checkpoint_dir)

    # fp32 AdamW with USE_PALLAS: at this width the kernel path is the wide head
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    result, run_id, wall = run_training(
        "rna2dna", "rna2dna", cfg=cfg, argv=["--epochs", "2", "--seed", "0"],
        data=(tpm, beta, site), n_sites=N_SITES, device=dev, root=workdir)
    counts["wide"] = read_counts()
    if (counts["wide"]["fused_wide_output_step"] != 2 * steps
            or counts["wide"]["rna2dna_train_epoch"]):
        raise AssertionError(f"run_training at the wide width launched the wide head "
                             f"{counts['wide']['fused_wide_output_step']} times in {2 * steps} "
                             f"steps and the epoch kernel "
                             f"{counts['wide']['rna2dna_train_epoch']} times")
    _wide_fit_line("run_training, fp32 AdamW (USE_PALLAS: the wide head kernel once a step; "
                   "the host-side initialisation included)", wall, 2, len(tr), result, card)
    del result
    counts["serve_wide"] = serve_wide(dev, cfg, workdir, run_id, tpm[va], site[va], card)
    shutil.rmtree(cfg.checkpoint_dir)
    counts["wide_replicates"] = wide_replicates(dev, workdir, cfg, (tpm, beta, site), tr, va,
                                                card)

    # the rows and the initial weights go to the card once, outside the timing
    train_rows, val_rows = ([torch.as_tensor(a[idx]).to(dev) for a in (tpm, beta, site)]
                            for idx in (tr, va))
    plain = cfg.replace(use_pallas=False)
    t0 = time.perf_counter()
    init = rna2dna_vae_init(torch.Generator().manual_seed(0), plain.input_dim_a, WIDE_D, N_SITES,
                            plain.latent_dim, plain.embed_dim, dev)
    say(f"[train-wide] initial weights ({sum(t.numel() for t in tree_leaves(init[0])):,} "
        f"parameters) drawn in {time.perf_counter() - t0:.1f} s")
    for what, run_cfg, kw in (("engine.fit fp32 AdamW", plain, {}),
                              ("engine.fit compute_dtype=bfloat16",
                               plain.replace(compute_dtype="bfloat16"), {}),
                              ("engine.fit moments_dtype=bfloat16",
                               plain.replace(moments_dtype="bfloat16"), {}),
                              ("engine.fit optimizer=adafactor",
                               plain.replace(optimizer="adafactor"), {}),
                              ("engine.fit fp32 AdamW, kernel path (the wide head kernel)",
                               plain, {"fused_epoch": True})):
        fit = lambda n: engine.fit(  # noqa: E731
            "rna2dna", run_cfg, train_rows, val_rows, 0, N_SITES, num_epochs=n, device=dev,
            init_params=init[0], init_state=init[1], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(1)  # warm-up: the path's one-time costs stay out of the timed run
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = fit(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        say(f"[train-wide] {what}: warm-up epoch {warm * 1e3:.1f} ms")
        _wide_fit_line(what, wall, 2, len(tr), res, card)
        # the loss pair: each plain step's forward and backward, and every
        # path's validation forward
        want = (1, 0) if kw else (steps + 1, steps)
        got = (fl.launches["rna2dna_loss_forward"] / 2, fl.launches["rna2dna_loss_backward"] / 2)
        say(f"[train-wide] {what}: loss launches an epoch {got[0]:g} forward, {got[1]:g} "
            f"backward")
        if got != want:
            raise AssertionError(f"wide {what}: the loss pair launched {got} an epoch, not {want}")
        del res
        if kw:  # the wide path: how much of its epoch the card is busy
            profile_epoch(lambda: fit(1), f"{what}, one epoch", card)
    del train_rows, val_rows, init
    torch.cuda.empty_cache()
    say(f"[train-wide] launches: run_training bf16 moments {counts['train_wide']}; "
        f"run_training fp32 {counts['wide']}; serving it {counts['serve_wide']}")
    return counts


WIDE_REPLICATES = 3
ADAFACTOR_SHARE = 1e-5  # a population of one's first step, of each tensor's largest |value|


def wide_replicates(dev, workdir, cfg, data, tr, va, card):
    """``run_training`` RNA→DNA with ``--replicates`` `WIDE_REPLICATES`
    ``--optimizer adafactor`` at the whole-methylome width (the plain
    population path: the loss pair once a member a step at 32 x 450,000,
    and a validation), every launch count at 0 just before it: its ms an
    epoch and peak device memory. Then the first step of a population of
    one (``fit_trials``, one trial, 32 training rows: one step) against
    ``engine.fit``'s plain Adafactor step at the same seed: every updated
    tensor within `ADAFACTOR_SHARE` of its largest |value|. Returns the
    launch counts."""
    tpm, beta, site = data
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result, _, wall = run_training(
            "rna2dna", "rna2dna", cfg=cfg,
            argv=["--epochs", "2", "--seed", "0", "--replicates", str(WIDE_REPLICATES),
                  "--optimizer", "adafactor"],
            data=data, n_sites=N_SITES, device=dev, root=workdir)
    launches = read_counts()
    steps = len(tr) // cfg.batch_size
    want = {"rna2dna_loss_forward": WIDE_REPLICATES * 2 * (steps + 1),
            "rna2dna_loss_backward": WIDE_REPLICATES * 2 * steps}
    text = tee.copy.getvalue()
    if ({k: launches[k] for k in want} != want or "vr" not in result.carry["opt"]
            or any(f"r{r}=" not in text for r in range(WIDE_REPLICATES))
            or "samples/sec" not in text):
        raise AssertionError(f"--replicates {WIDE_REPLICATES} --optimizer adafactor: launches "
                             f"{launches} (want {want})")
    _wide_fit_line(f"run_training --replicates {WIDE_REPLICATES} --optimizer adafactor (the "
                   "population path; the host-side initialisation of the members included; "
                   "wall over the epochs)", wall, 2, len(tr), result, card)
    say(f"[train-wide] --replicates {WIDE_REPLICATES} --optimizer adafactor: loss pair forward "
        f"{launches['rna2dna_loss_forward']}, backward {launches['rna2dna_loss_backward']} "
        f"(32 x {WIDE_D} a member a step, and a validation)")
    del result
    shutil.rmtree(cfg.checkpoint_dir)

    plain = cfg.replace(use_pallas=False, optimizer="adafactor")
    one_step = (tuple(a[tr[:plain.batch_size]] for a in data),
                tuple(a[va[:plain.batch_size]] for a in data))
    seed = vmap_meta.member_seeds(0, 1)[0]
    pop = vmap_meta.fit_trials("rna2dna", plain, *one_step, 0, N_SITES,
                               {"lr": np.full(1, plain.learning_rate, np.float32)},
                               num_epochs=1, mask_sizes=False, device=dev)[0]
    single = engine.fit("rna2dna", plain, *one_step, seed, N_SITES, num_epochs=1, device=dev)
    if int(single.carry["opt"]["step"]) != 1 or int(pop.carry["opt"]["step"]) != 1:
        raise AssertionError("the Adafactor comparison is not one step")
    worst = 0.0
    for (name, a), (_, b) in zip(engine._named_leaves(pop.final_params),
                                 engine._named_leaves(single.final_params)):
        share = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not share <= ADAFACTOR_SHARE:
            raise AssertionError(f"Adafactor population of one, first step: {name} differs by "
                                 f"{share:.3g} of its largest |value|")
        worst = max(worst, share)
    say(f"[train-wide] Adafactor population of one against engine.fit, the first step at 32 x "
        f"{WIDE_D}: every updated tensor within {worst:.3g} of its largest |value| (held at "
        f"{ADAFACTOR_SHARE:g}); {card}")
    del pop, single
    torch.cuda.empty_cache()
    return launches


def serve_wide(dev, cfg, workdir, run_id, x, s, card):
    """Serve the fp32 RNA→DNA checkpoint of the whole-methylome width
    through its loader with USE_PALLAS (the serving kernel): the served
    posterior against the plain eval forward's, and the kernel's
    reconstruction at z = mu against the plain eval forward's at z = mu, at
    the serving tolerance; returns the launch counts of the loader's call."""
    zero_counts()
    served = load_rna2dna(cfg=cfg, root=workdir, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon, mu, logvar = served(rna=x, site=s)
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    if launches["rna2dna_fused_forward"] != 1:
        raise AssertionError(f"the wide loader's call launched the serving kernel "
                             f"{launches['rna2dna_fused_forward']} times")
    _, pmu, plv = load_rna2dna(cfg=cfg.replace(use_pallas=False), root=workdir, device=dev)(
        rna=x, site=s)
    params, state, _ = checkpoint.load_best("rna2dna", run_id, cfg.checkpoint_dir)
    fused = fv.FusedRNA2DNA(params, state, dev)
    x_t, s_t = torch.as_tensor(x).to(dev), torch.as_tensor(s).to(dev)
    got = fused(x_t, s_t, use_noise=False)
    with torch.no_grad():
        want = rna2dna_vae_apply(tree_from_numpy(params, dev), tree_from_numpy(state, dev),
                                 rna=x_t, site=s_t, train=False, eps=torch.zeros_like(got[1]))
    checks = [("served mu", mu, pmu), ("served logvar", logvar, plv),
              ("recon at z = mu", got[0].cpu().numpy(), want.recon.cpu().numpy()),
              ("mu", got[1].cpu().numpy(), want.mu.cpu().numpy())]
    for what, a, b in checks:
        if a.shape != b.shape or not np.allclose(a, b, **TOL):
            raise AssertionError(f"wide serving: {what} differs from the plain eval forward by "
                                 f"{np.abs(a - b).max():.3g}")
    say(f"[serve-wide] the fp32 {WIDE_D}-wide RNA2DNAVAE served through "
        f"rna2dna_fused_forward: {len(x)} rows in {call_ms:.1f} ms (the loader's call, host "
        f"clock), recon {recon.shape}; posterior and recon at z = mu within atol = rtol = 1e-4 "
        f"of the plain eval forward (max {max(np.abs(a - b).max() for _, a, b in checks):.3g}); "
        f"{card}")
    # the loader's call, split: its rows to the card, the kernels, the results to the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_t = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    s_t = torch.as_tensor(np.asarray(s)).to(dev)
    torch.cuda.synchronize()
    to_device_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = time_call(lambda: fused(x_t, s_t, seed=3), reps=10, warmup=2)
    out = fused(x_t, s_t, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    [t.cpu().numpy() for t in out]
    to_host_ms = (time.perf_counter() - t0) * 1e3
    _, rows = profile_call(lambda: fused(x_t, s_t, seed=3))
    bound_ms, bound_by = bound(serving_work("rna2dna_fused_forward", len(x), dna=WIDE_D))
    device = (", ".join(f"{short_name(key)} {t:.4f} ms" for t, _, key in rows)
              or "its split not measured: the profiler caught no kernel")
    say(f"[serve-wide] the loader's call split: rows to the card {to_device_ms:.3f} ms (host "
        f"clock), the kernel call {kernel_ms:.4f} ms (CUDA events, median of 10; bound "
        f"{bound_ms:.4f} ms, {bound_by}; device {device}), results to the host "
        f"{to_host_ms:.3f} ms (host clock); {card}")
    del served, fused, got, want, out, x_t
    torch.cuda.empty_cache()
    return launches


def phase_serve(dev, workdir, tpm, beta, site, trained):
    """Serve the validation split with the RNA2DNAVAE and DNA2RNAVAE trained
    in phase 4 ({model name: run id}, also in their run-id files), with
    USE_PALLAS (the loaders serve through the kernels only then, as the JAX
    loaders do); returns the launch counts of that run."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    modules = {}
    for ckpt, model_cls in (("rna2dna", RNA2DNAVAE), ("dna2rna", DNA2RNAVAE)):
        if checkpoint.get_run_id(ckpt, workdir) != trained[ckpt]:
            raise AssertionError(f"latest_{ckpt}_run_id.txt does not name the trained run")
        p, s, _ = checkpoint.load_best(ckpt, trained[ckpt], cfg.checkpoint_dir)
        modules[ckpt] = model_cls(CFG.input_dim_a, CFG.input_dim_b, N_SITES, CFG.latent_dim,
                                  CFG.embed_dim).eval()
        modules[ckpt].load_state_dict(state_dict_from_jax(p, s, ckpt))

    zero_counts()
    results = compare_directional_imputation.main(cfg=cfg, data=(tpm, beta, site), root=workdir,
                                                  device=dev)
    launches = read_counts()

    for name in KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the serving run never launched {name}")
    if results is None or len(results) != 6:
        raise AssertionError(f"expected 6 records, got {results}")
    for rec in results:
        for key in ("MAE", "MSE", "RMSE", "R2", "CosineSimilarity", "PearsonMean", "PearsonStd"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"non-finite {key} in {rec['Modality']}/{rec['Model']}")
    out_dirs = [d for d in os.listdir(cfg.plots_dir) if d.startswith("directional_comparison_")]
    if not any(os.path.exists(os.path.join(cfg.plots_dir, d, "comparison_results.json"))
               for d in out_dirs):
        raise AssertionError("comparison_results.json was not written")

    # the served posterior against the unfused modules on the same card
    _, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    s_val = torch.as_tensor(site[va]).to(dev)
    for ckpt, loader, x in (("rna2dna", load_rna2dna, tpm[va]), ("dna2rna", load_dna2rna, beta[va])):
        served = loader(cfg=cfg, root=workdir, device=dev)
        _, mu, logvar = served(**{ckpt[:3]: x}, site=site[va])
        with torch.no_grad():
            ref = modules[ckpt].to(dev)(torch.as_tensor(x).to(dev), s_val,
                                        eps=torch.zeros(len(va), CFG.latent_dim, device=dev))
        for got, want, what in ((mu, ref[2], "mu"), (logvar, ref[3], "logvar")):
            if got.shape != (len(va), CFG.latent_dim):
                raise AssertionError(f"{ckpt}: served {what} has shape {got.shape}")
            err = np.abs(got - want.cpu().numpy()).max()
            if not np.allclose(got, want.cpu().numpy(), **TOL):
                raise AssertionError(f"{ckpt}: served {what} differs from the module by {err:.3g}")
        say(f"[serve] {ckpt}: served mu/logvar match the unfused module on the card")
    for rec in results:
        say("[serve] " + json.dumps(rec | {"_pearson_all": len(rec["_pearson_all"])}))
    for model, modality in (("RNA2DNAVAE", "DNA methylation"), ("DNA2RNAVAE", "RNA expression")):
        mse = {r["Model"]: r["MSE"] for r in results if r["Modality"] == modality}
        say(f"[serve] trained {model} MSE {mse[model]:.5f} vs mean imputation "
            f"{mse['Mean Imputation']:.5f}, k-NN imputation (k = 5) {mse['k-NN Imputation']:.5f}")
    say(f"[serve] launches during the serving run: {launches}")
    return launches


# ---- the kNN baselines, the t-SNE and the kNN comparison ---------------------
KNN_KS = tuple(knn_comparison.KNN_GRID["n_neighbors"])
KNN_MODES = tuple(knn_comparison.KNN_GRID["weights"])
KNN_METRICS = tuple(knn_comparison.KNN_GRID["metric"])
KNN_K = 20  # the k of the single-k predictions held card against CPU
GRID_REL = 1e-5
TIE_REL = 1e-5  # a float64 gap this small at the k-th neighbour is a tie at fp32 resolution
N_COPIES = 8  # zero-distance queries: copies of the first training rows


def check_near(what, got, want, atol, rtol):
    """``check_close`` for numpy arrays: the card's result against the CPU's."""
    err = float(np.max(np.abs(got - want), initial=0.0))
    if not np.isfinite(got).all() or not np.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: the card differs from the CPU by {err:.3g} "
                             f"(atol {atol}, rtol {rtol})")
    return err


class Tee(io.TextIOBase):
    """Writes to the console and keeps a copy."""

    def __init__(self, console):
        self.console, self.copy = console, io.StringIO()

    def write(self, s):
        self.copy.write(s)
        return self.console.write(s)

    def flush(self):
        self.console.flush()


def knn_directions(tpm, beta, site):
    """{direction: (X train, y train, X val, y val, sites train, sites val)}
    on the canonical split."""
    tr, va = train_val_indices(len(tpm), CFG.train_test_split, CFG.random_seed)
    return {"rna2dna": (tpm[tr], beta[tr], tpm[va], beta[va], site[tr], site[va]),
            "dna2rna": (beta[tr], tpm[tr], beta[va], tpm[va], site[tr], site[va])}


def brute_force64(x, q, metric):
    """float64 numpy distances (m, n) of each query to each training row."""
    x, q = x.astype(np.float64), q.astype(np.float64)
    if metric == "euclidean":
        d2 = (q * q).sum(1)[:, None] - 2.0 * q @ x.T + (x * x).sum(1)[None, :]
        return np.sqrt(np.maximum(d2, 0.0))
    out = np.empty((len(q), len(x)))
    for s in range(0, len(q), 16):
        out[s:s + 16] = np.abs(q[s:s + 16, None, :] - x[None, :, :]).sum(-1)
    return out


def neighbour_ties(what, idx, d64, ks=KNN_KS):
    """Hold each row's k nearest (the first k of ``idx``, sorted) against the
    k smallest float64 distances ``d64`` for every k: the same set, or sets
    that differ only by rows within TIE_REL of the k-th float64 distance
    (a tie at fp32 resolution, where either set is right). Returns the mask
    of the rows with such a tie."""
    order = np.argsort(d64, axis=1, kind="stable")
    ties = np.zeros(len(idx), bool)
    for k in ks:
        kth = np.maximum(d64[np.arange(len(d64)), order[:, k - 1]], 1e-30)
        for r in range(len(idx)):
            diff = sorted(set(idx[r, :k].tolist()) ^ set(order[r, :k].tolist()))
            if not diff:
                continue
            gap = float(np.max(np.abs(d64[r, diff] - kth[r]) / kth[r]))
            if not math.isfinite(gap) or gap > TIE_REL:
                raise AssertionError(f"{what}: query {r}'s {k} neighbours differ from the float64 "
                                     f"brute force by rows {diff} (relative gap {gap:.3g})")
            ties[r] = True
    return ties


def compare_knn(dev, tpm, beta, site):
    """The port's kNN on the card against the same code on the CPU, on the
    1024-sample cohort's split (819 training rows, 205 validation rows plus
    N_COPIES copies of training rows), both directions, both metrics, both
    weight modes: neighbour sets equal to a float64 numpy brute force (card
    and CPU), predictions (k = 20, every k of the grid through
    ``predict_multi_k``, the site-conditioned ones) within atol 1e-4 + rtol
    1e-4, the masked conditioned kNN on the card equal to the per-site loop
    on the card, every grid MSE within rel 1e-5, and the copied queries
    predicted as their own rows' targets exactly under distance weights."""
    cpu = torch.device("cpu")
    worst = 0.0
    for direction, (x, y, q, yq, s_tr, s_va) in knn_directions(tpm, beta, site).items():
        q = np.concatenate([x[:N_COPIES], q])
        yq = np.concatenate([y[:N_COPIES], yq])
        s_q = np.concatenate([s_tr[:N_COPIES], s_va])
        X = np.column_stack([x, s_tr]).astype(np.float32)
        Q = np.column_stack([q, s_q]).astype(np.float32)
        for metric in KNN_METRICS:
            what = f"knn {direction} {metric}"
            d64 = brute_force64(x, q, metric)
            d64_cond = np.where(s_q[:, None] == s_tr[None, :], d64, np.inf)
            ties = np.zeros(len(q), bool)
            for on in (dev, cpu):
                xs, qs = torch.as_tensor(x, device=on), torch.as_tensor(q, device=on)
                _, _, idx = knn._neighbours(xs, qs, max(KNN_KS), metric)
                ties |= neighbour_ties(f"{what} ({on.type})", idx.cpu().numpy(), d64)
                _, valid, idx = knn._neighbours(
                    xs, qs, max(KNN_KS), metric, torch.as_tensor(s_tr, device=on),
                    torch.as_tensor(s_q, device=on))
                for r in range(len(q)):  # the same-site neighbours: only the valid slots
                    n_valid = int(valid[r].sum())
                    ks = [k for k in KNN_KS if k <= n_valid]
                    if ks:
                        ties[r] |= neighbour_ties(f"{what} conditioned ({on.type})",
                                                  idx[r:r + 1].cpu().numpy(),
                                                  d64_cond[r:r + 1], ks)[0]
            keep = ~ties
            for weights in KNN_MODES:
                card = knn.KNNRegressor(KNN_K, weights, metric=metric, device=dev).fit(x, y)
                host = knn.KNNRegressor(KNN_K, weights, metric=metric, device="cpu").fit(x, y)
                got = card.predict(q)
                worst = max(worst, check_near(f"{what} {weights} predict", got[keep],
                                               host.predict(q)[keep], **TOL))
                if weights == "distance" and not np.array_equal(got[:N_COPIES], y[:N_COPIES]):
                    raise AssertionError(f"{what}: a query equal to a training row does not get "
                                         "that row's target (the zero-distance rule)")
                multi, multi_cpu = card.predict_multi_k(q, KNN_KS), host.predict_multi_k(q, KNN_KS)
                for k in KNN_KS:
                    worst = max(worst, check_near(f"{what} {weights} predict_multi_k k={k}",
                                                   multi[k][keep], multi_cpu[k][keep], **TOL))
                cond = knn.ConditionedKNNRegressor(KNN_K, weights, metric, device=dev).fit(X, y)
                got = cond.predict(Q)
                cond_cpu = knn.ConditionedKNNRegressor(KNN_K, weights, metric, device="cpu")
                worst = max(worst, check_near(f"{what} {weights} conditioned", got[keep],
                                               cond_cpu.fit(X, y).predict(Q)[keep], **TOL))
                loop = ConditionedKNeighborsRegressor(KNN_K, weights, metric, device=dev)
                check_near(f"{what} {weights} conditioned against the per-site loop",
                            got[keep], loop.fit(X, y).predict(Q)[keep], **TOL)
            for conditioned, (xx, qq) in ((False, (x, q)), (True, (X, Q))):
                card = knn.knn_grid_mse(xx, y, qq[keep], yq[keep], KNN_KS, KNN_MODES,
                                        conditioned=conditioned, metric=metric, device=dev)
                host = knn.knn_grid_mse(xx, y, qq[keep], yq[keep], KNN_KS, KNN_MODES,
                                        conditioned=conditioned, metric=metric, device="cpu")
                for combo, mse in host.items():
                    if not abs(card[combo] - mse) <= GRID_REL * abs(mse):
                        raise AssertionError(f"{what} grid {combo} (conditioned {conditioned}): "
                                             f"card {card[combo]!r}, CPU {mse!r}")
            say(f"[knn] {what}: neighbour sets equal to float64 ({int(ties.sum())} of {len(q)} "
                f"queries with a tie at fp32 resolution, left out of the comparisons); "
                f"predictions (base, multi-k, conditioned, the per-site loop) and the 16 grid "
                f"MSEs (base and conditioned) match the CPU")
    say(f"[knn] card against CPU: largest prediction difference {worst:.3g}")
    return worst


def trustworthiness(x, emb, n_neighbors=5):
    """sklearn.manifold.trustworthiness (euclidean), in numpy."""
    n = len(x)
    dx = brute_force64(x, x, "euclidean")
    np.fill_diagonal(dx, np.inf)
    ind_x = np.argsort(dx, axis=1, kind="stable")
    de = brute_force64(emb, emb, "euclidean")
    np.fill_diagonal(de, np.inf)
    ind_e = np.argsort(de, axis=1, kind="stable")[:, :n_neighbors]
    inverted = np.zeros((n, n), int)
    inverted[np.arange(n)[:, None], ind_x] = np.arange(1, n + 1)
    ranks = inverted[np.arange(n)[:, None], ind_e] - n_neighbors
    t = np.sum(ranks[ranks > 0])
    return 1.0 - t * (2.0 / (n * n_neighbors * (2.0 * n - 3.0 * n_neighbors - 1.0)))


def compare_tsne(dev, x):
    """The port's t-SNE on the card against the CPU at the rows of ``x``:
    the joint P within rtol 1e-5 (atol 5e-5 of its largest entry: a row's
    perplexity search can stop one halving apart in two fp32 orders,
    tests/test_torch_tsne.py), the PCA init within 1e-4 of its largest entry
    after the signs are aligned, and the two embeddings' trustworthiness
    within 0.02."""
    devices = (dev, torch.device("cpu"))
    xs = [torch.as_tensor(x, device=d) for d in devices]
    p_card, p_cpu = (tsne._joint_probabilities(tsne._sq_distances(v), 30.0).cpu().numpy()
                     for v in xs)
    p_err = check_near("tsne P", p_card, p_cpu, atol=5e-5 * p_cpu.max(), rtol=1e-5)
    init = [tsne._pca_init(v, 2).cpu().numpy() for v in xs]
    signs = np.sign(np.sum(init[0] * init[1], axis=0))
    err = np.abs(init[0] * signs - init[1]).max()
    if not err <= 1e-4 * np.abs(init[1]).max():
        raise AssertionError(f"tsne PCA init: card and CPU differ by {err:.3g}")
    emb, kl = [], []
    for d in devices:
        model = tsne.TSNE(n_components=2, random_state=42, perplexity=min(30, len(x) - 1),
                          device=d)
        emb.append(model.fit_transform(x))
        kl.append(model.kl_divergence_)
    trust = [trustworthiness(x, e) for e in emb]
    if not (np.isfinite(emb[0]).all() and abs(trust[0] - trust[1]) <= 0.02):
        raise AssertionError(f"tsne: trustworthiness card {trust[0]}, CPU {trust[1]}")
    say(f"[tsne] {len(x)} rows x {x.shape[1]}: P and the PCA init match the CPU (P by "
        f"{p_err / p_cpu.max():.3g} of its largest entry, the init by "
        f"{err / np.abs(init[1]).max():.3g} of its); "
        f"trustworthiness card {trust[0]:.4f}, CPU {trust[1]:.4f}; KL card {kl[0]:.4f}, "
        f"CPU {kl[1]:.4f}")


def phase_knn_comparison(dev, workdir, tpm, beta, site):
    """``knn_comparison.main`` with the t-SNE, USE_PALLAS on, on the
    directional VAEs trained in phase 4: three finite per-sample MSE arrays
    a direction, the best grid parameters printed, the serving kernels
    launched for "VAE (Cond)"; returns the launch counts of that run."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    _, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    tee = Tee(sys.stdout)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        results = knn_comparison.main(cfg=cfg, make_tsne=True, data=(tpm, beta, site),
                                      root=workdir, device=dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    for name in KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the kNN comparison never launched {name}")
    names = ["KNN (Base)", "KNN (Cond)", "VAE (Cond)"]
    for direction, res in zip(("RNA_to_DNA", "DNA_to_RNA"), results):
        if list(res) != names:
            raise AssertionError(f"{direction}: results {list(res)}")
        for name, mse in res.items():
            if mse.shape != (len(va),) or not np.isfinite(mse).all():
                raise AssertionError(f"{direction} {name}: per-sample MSE of shape {mse.shape}")
        say(f"[knn_comparison] {direction}: mean per-sample MSE "
            + ", ".join(f"{name} {float(np.mean(mse)):.5f}" for name, mse in res.items()))
    printed = tee.copy.getvalue()
    for name in ("KNN (Base)", "KNN (Conditioned)"):
        if printed.count(f"Best {name} params: {{'n_neighbors'") != 2:
            raise AssertionError(f"the best {name} parameters were not printed for both "
                                 "directions")
    say(f"[knn_comparison] main with 6 t-SNE runs of {len(va)} rows: {wall:.2f} s; "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the unmatched cohorts: reconstruction and the clustering evaluation

UNMATCHED = dict(n_samples=1024, n_unmatched=128, seed=0)
CLUSTER_K = 5  # the neighbourhood hit's k
# The silhouette against float64, from an H100's readings with room: 5.5e-09 at
# 128 x 2388 and 2.9e-09 on the compensated path at 205 x 450,000, where the
# plain identity drifts 7.2e-07 (so this limit tells the two apart). The
# compensated path's documented contract is the looser 5e-4 at dim >= 100k.
SIL_ABS = 1e-7  # at 128 x 2388
WIDE_SIL_ABS = 1e-7  # the compensated path at WIDE_CLUSTER
WIDE_CLUSTER = (205, WIDE_D)  # rows x features of the compensated-path check
MEMBER_ABS = 1e-6  # a member of a population against its single score
CLUSTER_ROWS = 1600  # the 8000-sample cohort's validation rows


def silhouette64(d, labels):
    """sklearn's silhouette in float64 numpy from the (n, n) distances
    ``d``: a the mean distance to the own cluster (self excluded), b the
    smallest mean distance to another, singletons 0."""
    d = d.copy()
    np.fill_diagonal(d, 0.0)
    uniq, lab = np.unique(labels, return_inverse=True)
    onehot = (lab[:, None] == np.arange(len(uniq))[None, :]).astype(np.float64)
    sums, counts = d @ onehot, onehot.sum(0)
    rows = np.arange(len(d))
    own = counts[lab]
    a = sums[rows, lab] / np.maximum(own - 1.0, 1.0)
    means = sums / counts
    means[rows, lab] = np.inf
    b = means.min(1)
    return float(np.mean(np.where(own > 1, (b - a) / np.maximum(a, b), 0.0)))


def nh64(d, labels, k=CLUSTER_K):
    """(the neighbourhood hit in float64 numpy from the (n, n) distances
    ``d``, the rows whose k-th and (k+1)-th neighbours lie within TIE_REL of
    each other with different labels: a tie at fp32 resolution, where
    either neighbour is right)."""
    d = d.copy()
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")
    rows = np.arange(len(d))
    kth, nxt = d[rows, order[:, k - 1]], d[rows, order[:, k]]
    tie = (nxt - kth <= TIE_REL * kth) & (labels[order[:, k - 1]] != labels[order[:, k]])
    return float(np.mean(labels[order[:, :k]] == labels[:, None])), int(tie.sum())


def hold_scores(what, dev, x, labels, sil_abs):
    """The card's silhouette and hit of ``x`` (numpy) within ``sil_abs`` of
    float64 and equal to float64's up to the tie rows (1/(n·k) each);
    returns the float64 silhouette."""
    sil, nh = cluster_metrics.cluster_scores(x, labels, k=CLUSTER_K, device=dev)
    d64 = brute_force64(x, x, "euclidean")
    want_sil = silhouette64(d64, labels)
    want_nh, ties = nh64(d64, labels)
    drift = abs(sil - want_sil)
    if not drift <= sil_abs:
        raise AssertionError(f"{what}: silhouette {sil} against float64 {want_sil} "
                             f"(|drift| {drift:.3g} > {sil_abs})")
    if not abs(nh - want_nh) <= ties / (len(x) * CLUSTER_K) + 1e-7:
        raise AssertionError(f"{what}: neighbourhood hit {nh} against float64 {want_nh} "
                             f"({ties} tie rows)")
    say(f"[clustering] {what}: silhouette {sil:.6f} (float64 {want_sil:.6f}, |drift| "
        f"{drift:.3g}), hit {nh:.6f} (float64 {want_nh:.6f}, {ties} tie rows)")
    return want_sil


def check_reconstruction(dev, cfg, workdir, parts, rna_rec, dna_rec):
    """Each reconstructed cohort within `TOL` of the plain eval forward of
    its model given the kernel's own Philox draws (the loader's fixed
    seed), the DNA-only cohort without a site. A forward is continuous at
    the ReLU kinks, so no cell is left out."""
    seed = loading._seed_of(None)
    (_, _, _), (raw_tpm, rna_site), (beta_only, _) = parts
    for ckpt, apply, kw, x, sites, got in (
            ("rna2dna", rna2dna_vae_apply, "rna", np.log1p(raw_tpm), rna_site,
             rna_rec["reconstructed_beta_value"]),
            ("dna2rna", dna2rna_vae_apply, "dna", beta_only, None,
             dna_rec["reconstructed_tpm_unstranded"])):
        p, s, _ = checkpoint.load_best(ckpt, checkpoint.get_run_id(ckpt, workdir),
                                       cfg.checkpoint_dir)
        eps = fv.philox_normal_reference(seed, len(x), CFG.latent_dim, dev)
        site_t = None if sites is None else torch.as_tensor(sites).to(dev)
        with torch.no_grad():
            ref = apply(tree_from_numpy(p, dev), tree_from_numpy(s, dev), site=site_t, eps=eps,
                        **{kw: torch.as_tensor(np.asarray(x, np.float32)).to(dev)}).recon
        err = check_near(f"{ckpt} reconstruction of the unmatched cohort", got,
                         ref.cpu().numpy(), **TOL)
        say(f"[clustering] {ckpt}: {len(x)} reconstructed rows within {err:.3g} of the plain "
            f"eval forward given the kernel's Philox draws (atol = rtol = {TOL['atol']}; "
            f"site {'none' if sites is None else 'given'})")


def check_cluster_results(what, results, n_expected):
    if len(results) != n_expected:
        raise AssertionError(f"{what}: {len(results)} results, want {n_expected}")
    for rec in results:
        name = " ".join(str(rec[k]) for k in ("cohort", "method") if k in rec)
        for space in ("orig", "pca", "tsne"):
            sil, nh = rec[f"{space}_silhouette"], rec[f"{space}_nh"]
            if not (-1.0 <= sil <= 1.0 and 0.0 <= nh <= 1.0):
                raise AssertionError(f"{what} {name} {space}: silhouette {sil}, hit {nh}")
        say(f"[clustering] {what} {name}: " + ", ".join(
            f"{space} silhouette {rec[f'{space}_silhouette']:.4f} hit {rec[f'{space}_nh']:.4f}"
            for space in ("orig", "pca", "tsne")))


def time_clustering(dev, card):
    """At the 8000-sample cohort's 1600 validation rows (width 2388, three
    members), CUDA events: the fused scores of one space (the median of 3
    after a warm-up); the 3-member population t-SNE (1000 steps, on PCA-50
    inputs as the flow gives it) and `analyze_cohort_population`, the
    median of 3 with no warm-up (the clustering mains ran the same code at
    other shapes); 3 single `TSNE` runs, each timed once, summed."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=CLUSTER_ROWS, seed=1)
    rng = np.random.default_rng(1)
    base = np.concatenate([tpm, beta], axis=1)
    members = [base + np.float32(0.05 * m) * rng.standard_normal(base.shape, np.float32)
               for m in range(3)]
    stacked = pca.standardize_members(torch.stack([torch.as_tensor(f).to(dev) for f in members]))
    pre = pca.pca_scores_members(stacked, 50)[0]
    out = {}
    out["cluster_scores"] = time_call(
        lambda: cluster_metrics.cluster_scores(stacked[0], site, device=dev), reps=3, warmup=1)
    out["tsne_population"] = time_call(
        lambda: tsne.tsne_fit_transform_members(pre, perplexity=30.0, device=dev), reps=3,
        warmup=0)
    out["tsne_3_single"] = sum(time_call(
        lambda m=m: tsne.TSNE(perplexity=30.0, device=dev).fit_transform(pre[m]), reps=1,
        warmup=0)
        for m in range(3))
    with contextlib.redirect_stdout(io.StringIO()):
        out["analyze_cohort_population"] = time_call(
            lambda: clustering_common.analyze_cohort_population(members, site, device=dev),
            reps=3, warmup=0)
    say(f"[clustering] at {CLUSTER_ROWS} x {base.shape[1]} (3 members), CUDA events: "
        f"cluster_scores of one space {out['cluster_scores']:.2f} ms (median of 3); "
        f"population t-SNE (3 members, 1000 steps, PCA-50 inputs) {out['tsne_population']:.1f} "
        f"ms (median of 3) against 3 single TSNE runs {out['tsne_3_single']:.1f} ms (each "
        f"once); analyze_cohort_population {out['analyze_cohort_population']:.1f} ms (median "
        f"of 3); {card}")
    return out


def hold_wide_silhouette(dev, card):
    """The compensated path at 205 x 450,000 (β-like values around 24 site
    centres, 0.37 GB in fp32 on the card, 0.74 GB in float64 on the host):
    the silhouette within WIDE_SIL_ABS of float64 (the path's documented
    contract is 5e-4); the plain identity's drift printed beside it."""
    n, d = WIDE_CLUSTER
    rng = np.random.default_rng(7)
    labels = rng.integers(0, N_SITES, n)
    x = np.empty((n, d), np.float32)
    for s in range(0, d, 65_536):
        centres = rng.standard_normal((N_SITES, min(65_536, d - s)), np.float32)
        noise = rng.standard_normal((n, centres.shape[1]), np.float32)
        x[:, s:s + centres.shape[1]] = 1.0 / (1.0 + np.exp(-(centres[labels] + 2.0 * noise)))
    if not cluster_metrics._resolve_compensated(None, d):
        raise AssertionError(f"dim {d} did not select the compensated path")
    want = hold_scores(f"compensated path at {n} x {d}", dev, x, labels, WIDE_SIL_ABS)
    plain = cluster_metrics.silhouette_score(x, labels, compensated=False, device=dev)
    say(f"[clustering] at {n} x {d}: the plain identity's silhouette drift against float64 "
        f"{abs(plain - want):.3g} (TF32 off; printed, not held); {card}")
    torch.cuda.empty_cache()


def phase_clustering(dev, workdir, card):
    """The unmatched cohorts of `unmatched_cohorts` (1024 matched rows, 128
    RNA-only, 128 DNA-only, the full width) with the directional VAEs that
    phase 4 trained (their run-id files in ``workdir``), USE_PALLAS on:
    ``reconstruct_unmatched.main`` (exactly one launch of B0a and one of
    B0b, without a site, each cohort held against the plain forward), then
    ``cluster_reconstructed.main`` on its output and
    ``cluster_imputation_methods.main`` (3 methods x 2 cohorts, each cohort
    one population), every score printed and in range; the card's metrics
    against float64 (`hold_scores`, `hold_wide_silhouette`), a population's
    members against their single scores, and the timings
    (`time_clustering`). Returns {"reconstruct": launch counts}."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"),
                      data_dir=os.path.join(workdir, "unmatched"), use_pallas=True)
    t_phase = time.perf_counter()
    parts = unmatched_cohorts(**UNMATCHED)
    zero_counts()
    t0 = time.perf_counter()
    rna_rec, dna_rec = reconstruct_unmatched.main(cfg, data=parts, device=dev, root=workdir)
    torch.cuda.synchronize()
    walls = {"reconstruct_unmatched": time.perf_counter() - t0}
    launches = read_counts()
    want = {name: int(name in KERNELS) for name in launches}
    if launches != want:
        raise AssertionError(f"reconstruct_unmatched.main launched {launches}, want {want}")
    check_reconstruction(dev, cfg, workdir, parts, rna_rec, dna_rec)

    zero_counts()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        reconstructed = cluster_reconstructed.main(cfg, data=(rna_rec, dna_rec, parts[0][2]),
                                                   device=dev)
        torch.cuda.synchronize()
        walls["cluster_reconstructed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        methods = cluster_imputation_methods.main(cfg, data=parts, device=dev)
        torch.cuda.synchronize()
        walls["cluster_imputation_methods"] = time.perf_counter() - t0
    if any(read_counts().values()):
        raise AssertionError(f"the clustering mains launched kernels: {read_counts()}")
    check_cluster_results("cluster_reconstructed", reconstructed, 2)
    check_cluster_results("cluster_imputation_methods", methods, 6)
    if tee.copy.getvalue().count("3 methods as one population") != 2:
        raise AssertionError("the imputation methods did not run as one population a cohort")
    reports = os.listdir(os.path.join(cfg.plots_dir, "clustering"))
    if not any(r.startswith("clustering_summary_") and r.endswith(".txt") for r in reports):
        raise AssertionError("the clustering summary report was not written")

    # the metrics against float64 on the host, at the cohort's width
    x = np.concatenate([np.log1p(rna_rec["tpm_unstranded"]), rna_rec["reconstructed_beta_value"]],
                       axis=1).astype(np.float32)
    x = ((x - x.mean(0)) / np.where(x.std(0) == 0, 1.0, x.std(0))).astype(np.float32)
    labels = rna_rec["primary_site_encoded"]
    hold_scores(f"RNA-only cohort {x.shape[0]} x {x.shape[1]}", dev, x, labels, SIL_ABS)
    hold_wide_silhouette(dev, card)
    rng = np.random.default_rng(3)
    spaces = [x + np.float32(0.1 * m) * rng.standard_normal(x.shape, np.float32)
              for m in range(3)]
    pop = cluster_metrics.cluster_scores_members(spaces, labels, device=dev)
    alone = [cluster_metrics.cluster_scores(f, labels, device=dev) for f in spaces]
    worst = max(abs(a - b) for p, q in zip(pop, alone) for a, b in zip(p, q))
    if not worst <= MEMBER_ABS:
        raise AssertionError(f"population {pop} against the members alone {alone}")
    say(f"[clustering] cluster_scores_members of 3 spaces of {x.shape[0]} x {x.shape[1]}: each "
        f"within {worst:.3g} of its single scores (held at {MEMBER_ABS})")
    time_clustering(dev, card)
    say("[clustering] walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; the phase {time.perf_counter() - t_phase:.1f} s; launches during the "
        f"reconstruction {launches}; {card}")
    return {"reconstruct": launches}


# ---------------------------------------------------------------------------
# downstream site classification: the MLP classifiers and the two flows

# Of each tensor's own largest entry. Measured on an H100: gradients and first
# moments 5.2e-07 (steps) and 1.35e-06 (a population's first step against its
# members alone), first v 9.8e-07, parameters 1.05e-07, the loss 7.6e-08.
CLS_LOSS_RTOL = 1e-6
CLS_GRAD_REL = 1e-5  # fp32 sums of 2388 (or 256) terms; first v at twice this
CLS_UPDATE_REL = 1e-6  # the updated parameters
CLS_KINK_REL = 1e-5  # a ReLU input this near 0 (of its layer's largest) is dropped
CLS_WIDTH = CFG.input_dim_a + CFG.input_dim_b  # the side-by-side scenarios' width, 2388
DS_FOLDS = 5


def rel_err(got, want):
    """Largest |got - want| over the largest |want| (a tiny floor only
    against an all-zero ``want``), on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(want.abs().max().item(), torch.finfo(torch.float32).tiny)
    return (got - want).abs().max().item() / scale


def tree_rel(got, want):
    return max(rel_err(got[k][n], want[k][n]) for k in want for n in want[k])


def clear_classifier_kinks(params, x, valid, masks, arch):
    """``masks`` with every live cell whose ReLU input lies within
    `CLS_KINK_REL` of 0 (relative to its layer's largest, float64 on the
    host) dropped: a dropped cell gives two fp32 implementations the same
    forward and gradient whichever side they take. Returns (masks, cells
    dropped)."""
    p = tree_map(lambda t: t.detach().double().cpu(), params)
    h, out, dropped = x.detach().double().cpu(), [], 0
    live = valid.cpu()[..., None]
    for i, (rate, mask) in enumerate(zip(mc.DROPOUT[arch], masks), 1):
        h = h @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"].unsqueeze(-2)
        if arch == "deep":
            g = p[f"ln{i}"]
            mu = h.mean(-1, keepdim=True)
            var = torch.square(h - mu).mean(-1, keepdim=True)
            h = (h - mu) / torch.sqrt(var + 1e-5) * g["gamma"].unsqueeze(-2) + \
                g["beta"].unsqueeze(-2)
        mask = mask.cpu().clone()
        near = (h.abs() < CLS_KINK_REL * h.abs().amax(dim=(-2, -1), keepdim=True)) & live \
            & (mask > 0)
        dropped += int(near.sum())
        mask[near] = 0.0
        out.append(mask.to(masks[0].device))
        h = h.clamp(min=0.0) * mask.double() / (1.0 - rate)
    return tuple(out), dropped


def classifier_step(params, state, x, y, cw, valid, masks, arch, wd):
    """One training step of the fit: the masked weighted loss, its
    gradients, then Adam with coupled decay (lr 1e-3)."""
    loss, grads = mc._grads(params, x, y, cw, valid, masks, arch)
    lr = torch.tensor(1e-3, device=x.device)
    new_params, new_state = optim.adam_update(params, grads, state, lr, wd)
    return loss, grads, new_params, new_state


def compare_classifier_steps(dev, card):
    """A deep and a shallow classifier step at the side-by-side width (2388
    features, 24 classes, a last batch of 26 rows in 32 slots) on the card
    against the same step on the CPU, with injected rows and dropout masks,
    twice: from zero moments, whose updated m = (1 - β1)·g and v = (1 -
    β2)·g² hold the gradients' arithmetic in the moments (Adam's first step
    moves every parameter by ±lr, so its parameters are not held), and from
    a non-zero Adam state, whose updated parameters are held."""
    for arch, wd in (("deep", 1e-4), ("shallow", 0.0)):
        g = torch.Generator().manual_seed(17)
        params = mc.mlp_init(g, CLS_WIDTH, N_SITES, arch)
        x = torch.randn(CFG.batch_size, CLS_WIDTH, generator=g)
        y = torch.randint(0, N_SITES, (CFG.batch_size,), generator=g)
        cw = torch.rand(N_SITES, generator=g) * 1.5 + 0.5
        valid = torch.arange(CFG.batch_size) < 26
        masks = tuple((torch.rand(CFG.batch_size, w, generator=g) < 1.0 - r).to(torch.float32)
                      for w, r in zip(mc.HIDDEN[arch], mc.DROPOUT[arch]))
        masks, dropped = clear_classifier_kinks(params, x, valid, masks, arch)
        first = optim.adamw_init(params)
        state = {"step": torch.tensor(3, dtype=torch.int32),
                 "m": tree_map(lambda t: torch.randn(t.shape, generator=g) * 1e-2, params),
                 "v": tree_map(lambda t: torch.rand(t.shape, generator=g) * 1e-3 + 1e-5, params)}
        to = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
        inputs = (x, y, cw, valid, masks)
        cpu0, cpu = (classifier_step(params, st, *inputs, arch, wd) for st in (first, state))
        on_card = (x.to(dev), y.to(dev), cw.to(dev), valid.to(dev), tuple(m.to(dev) for m in masks))
        got0, got = (classifier_step(to(params), to(st), *on_card, arch, wd)
                     for st in (first, state))
        errs = {"loss": rel_err(got[0], cpu[0]), "gradients": tree_rel(got[1], cpu[1]),
                "first m": tree_rel(got0[3]["m"], cpu0[3]["m"]),
                "first v": tree_rel(got0[3]["v"], cpu0[3]["v"]),
                "parameters": tree_rel(got[2], cpu[2])}
        limits = {"loss": CLS_LOSS_RTOL, "gradients": CLS_GRAD_REL, "first m": CLS_GRAD_REL,
                  "first v": 2 * CLS_GRAD_REL, "parameters": CLS_UPDATE_REL}
        bad = {k: v for k, v in errs.items() if not v <= limits[k]}
        if bad or not torch.isfinite(got[0]):
            raise AssertionError(f"{arch} classifier step, card against CPU: {bad} (limits "
                                 f"{limits})")
        say(f"[downstream] {arch} classifier step at {CFG.batch_size} x {CLS_WIDTH}, card "
            f"against CPU: " + ", ".join(f"{k} {v:.3g} (limit {limits[k]:g})"
                                         for k, v in errs.items())
            + f" (relative to each tensor's largest entry; {dropped} near-kink cells dropped); "
            f"{card}")


def classifier_folds(rna, dna, labels):
    """The side-by-side scenario of these rows as the downstream flow splits
    it: (folds as `fit_classifier_folds` takes them, the number of
    classes)."""
    x = standard_scale(np.concatenate([rna, dna], axis=1))
    n_classes = int(labels.max()) + 1
    splits = stratified_kfold_indices(labels, DS_FOLDS, 42)
    cws = downstream.fold_class_weights(labels, splits, n_classes)
    return ([(x[tr], labels[tr], x[va], labels[va], cw) for (tr, va), cw in zip(splits, cws)],
            n_classes)


def same_fit(a, b):
    return (all(torch.equal(a.params[k][n], b.params[k][n]) for k in a.params
                for n in a.params[k])
            and np.array_equal(a.val_accs, b.val_accs, equal_nan=True)
            and np.array_equal(a.best_val_acc, b.best_val_acc))


def member_of(fit, i):
    return mc.ClassifierFit(tree_map(lambda t: t[i], fit.params), fit.best_val_acc[i],
                            fit.val_accs[i])


def plain_classifier_fit(fold, n_classes, seed, *, arch, num_epochs, batch_size, lr,
                         weight_decay, early_stop, device):
    """One member's fit written plainly: 2-D tables, no member axis and no
    masking, the loop of `mlp_classifier`'s module docstring on the draws
    of `mlp_classifier._draws`. `fit_classifier` (a population of one) must
    equal it bit for bit."""
    x_train, y_train, x_val, y_val, cw = (
        torch.as_tensor(np.asarray(a), dtype=dt).to(device)
        for a, dt in zip(fold, (torch.float32, torch.int64, torch.float32, torch.int64,
                                torch.float32)))
    params = mc.mlp_init(torch.Generator().manual_seed(seed), x_train.shape[1], n_classes, arch,
                         device)
    n = len(x_train)
    n_batches = -(-n // batch_size)
    slots = torch.arange(n_batches * batch_size, device=device)
    opt = optim.adamw_init(params)
    plateau = optim.plateau_init(lr, device)
    best, best_acc, patience = params, torch.zeros((), device=device), 0
    n_val = torch.tensor(float(len(y_val)), device=device)
    val_accs = np.full(num_epochs, np.nan, np.float32)
    for epoch in range(num_epochs):
        perm, masks = mc._draws(seed, epoch, n, n_batches, batch_size, arch, device)
        idx = perm[slots % n]
        for b in range(n_batches):
            rows = idx[b * batch_size:(b + 1) * batch_size]
            _, grads = mc._grads(params, x_train[rows], y_train[rows], cw,
                                 slots[b * batch_size:(b + 1) * batch_size] < n,
                                 tuple(m[b] for m in masks), arch)
            params, opt = optim.adam_update(params, grads, opt, plateau["lr"], weight_decay)
        logits = mc.mlp_apply(params, x_val, arch=arch)
        val_acc = 100.0 * (logits.argmax(-1) == y_val).sum().to(torch.float32) / n_val
        plateau = optim.plateau_step(plateau, mc.weighted_ce_mean(logits, y_val, cw),
                                     mc.PLATEAU_FACTOR, mc.PLATEAU_PATIENCE)
        val_accs[epoch] = val_acc.item()
        if val_acc.item() > best_acc.item():
            best, best_acc, patience = params, val_acc, 0
        else:
            patience += 1
        if early_stop and patience >= mc.STOP_PATIENCE:
            break
    return mc.ClassifierFit(best if early_stop else params, best_acc.cpu().numpy(), val_accs)


def first_step_gradients(dev, folds, n_classes, seeds):
    """The population's first-step gradients (stacked) and each member's
    alone, from the fit's own draws of epoch 0 (`mlp_classifier._draws`),
    batch 0, the near-kink cells dropped from the masks."""
    inits = [mc.mlp_init(torch.Generator().manual_seed(s), CLS_WIDTH, n_classes, "deep", dev)
             for s in seeds]
    xs, ys, valids, maskss = [], [], [], []
    for f, s, p in zip(folds, seeds, inits):
        n = len(f[0])
        perm, masks = mc._draws(s, 0, n, -(-n // CFG.batch_size), CFG.batch_size, "deep", dev)
        rows = perm[: CFG.batch_size]
        x = torch.as_tensor(f[0]).to(dev)[rows]
        y = torch.as_tensor(f[1]).to(dev)[rows]
        valid = torch.ones(CFG.batch_size, dtype=torch.bool, device=dev)
        masks, _ = clear_classifier_kinks(p, x, valid, tuple(m[0] for m in masks), "deep")
        xs.append(x), ys.append(y), valids.append(valid), maskss.append(masks)
    cws = [torch.as_tensor(f[4]).to(dev) for f in folds]
    stacked = tree_map(lambda *t: torch.stack(t), *inits)
    _, pop = mc._grads(stacked, torch.stack(xs), torch.stack(ys), torch.stack(cws),
                       torch.stack(valids), tuple(torch.stack(m) for m in zip(*maskss)), "deep")
    singles = [mc._grads(p, x, y, cw, v, m, "deep")[1]
               for p, x, y, cw, v, m in zip(inits, xs, ys, cws, valids, maskss)]
    return pop, singles


def compare_classifier_populations(dev, tpm, beta, site, card):
    """A population of one (``fit_classifier``) equal to
    `plain_classifier_fit` bit for bit (deep, 100 epochs with early
    stopping; shallow, 20 epochs); the
    5-fold uneven population's first-step gradients against each member's
    alone (fp32 order, `CLS_GRAD_REL`); after the full deep run each
    member's distance from its single fit, printed. On all the cohort's
    rows: its 205 validation rows give 5 even folds, 1024 uneven ones
    (819/820 training, 205/204 validation rows)."""
    folds, n_classes = classifier_folds(tpm, beta, site.astype(np.int64))
    for arch, recipe in (("deep", downstream.DEEP), ("shallow", downstream_directional.SHALLOW)):
        one = plain_classifier_fit(folds[1], n_classes, 1, device=dev, **recipe)
        pop = mc.fit_classifier(*folds[1][:4], n_classes, folds[1][4], 1, device=dev, **recipe)
        if not same_fit(one, pop):
            raise AssertionError(f"{arch}: a population of one is not its plain single fit")
        ran = int(np.sum(~np.isnan(one.val_accs)))
        say(f"[downstream] {arch}: a population of one (fit_classifier) is its plain single fit "
            f"bit for bit ({ran} epochs, best validation accuracy "
            f"{float(one.best_val_acc):.2f}%)")
    sizes = [(len(f[0]), len(f[2])) for f in folds]
    if len(set(sizes)) < 2:
        raise AssertionError(f"the folds are even ({sizes}): nothing masked to hold")
    pop_grads, singles = first_step_gradients(dev, folds, n_classes, range(DS_FOLDS))
    errs = [tree_rel(tree_map(lambda t: t[i], pop_grads), g) for i, g in enumerate(singles)]
    if not max(errs) <= CLS_GRAD_REL:
        raise AssertionError(f"first-step gradients of the population against each member "
                             f"alone: {errs} (limit {CLS_GRAD_REL})")
    say(f"[downstream] {DS_FOLDS} uneven folds (training, validation rows: {sizes}): the "
        f"population's first-step gradients within {max(errs):.3g} of each member's alone "
        f"(of each tensor's largest; by member {[f'{e:.3g}' for e in errs]}); {card}")
    pop = mc.fit_classifier_folds(folds, n_classes, device=dev, **downstream.DEEP)
    for i, f in enumerate(folds):
        one = mc.fit_classifier(*f[:4], n_classes, f[4], i, device=dev, **downstream.DEEP)
        ran, ran_one = ~np.isnan(pop.val_accs[i]), ~np.isnan(one.val_accs)
        both = ran & ran_one
        say(f"[downstream] fold {i} after the full deep run: {int(ran.sum())} epochs in the "
            f"population, {int(ran_one.sum())} alone; "
            f"{int(np.sum(one.val_accs[both] == pop.val_accs[i][both]))} of {int(both.sum())} "
            f"shared epochs' accuracies equal; parameters within "
            f"{tree_rel(member_of(pop, i).params, one.params):.3g} of its single fit's (of each "
            f"tensor's largest); best accuracy {float(pop.best_val_acc[i]):.2f}% against "
            f"{float(one.best_val_acc):.2f}%")


def run_downstream_mains(dev, workdir, tpm, beta, site, card):
    """``downstream.main`` and ``downstream_directional.main`` with
    USE_PALLAS on the three models trained in phase 4, each with every
    launch count at 0 just before it: the tri-modal flow launches no kernel
    (its loader's plain forward), the directional flow exactly one B0a and
    one B0b (the validation rows' two imputations), which are held within
    `TOL` of the plain eval forward given the kernels' own Philox draws and
    must be conditioned on the original site codes. Prints each scenario's
    accuracy and weighted F1 and each main's wall seconds; returns the
    launch counts of the two runs."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    data = (tpm, beta, site)
    counts = {}
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee(sys.stdout)):
        results = downstream.main(cfg, data=data, device=dev, root=workdir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["downstream"] = read_counts()
    if any(counts["downstream"].values()):
        raise AssertionError(f"downstream.main launched kernels: {counts['downstream']}")
    say(f"[downstream] downstream.main (8 scenarios x {DS_FOLDS} folds, deep MLP, 3 populations): "
        f"{wall:.2f} s; launches {counts['downstream']}; {card}")
    if len(results) != 8:
        raise AssertionError(f"downstream.main gave {list(results)}")
    for name, agg in results.items():
        if not (0.0 <= agg["accuracy"] <= 1.0 and math.isfinite(agg["weighted avg"]["f1-score"])):
            raise AssertionError(f"{name}: {agg['accuracy']}, {agg['weighted avg']}")
        say(f"[downstream]   {name:24s} accuracy {agg['accuracy']:.4f} ± "
            f"{agg['accuracy_std']:.4f}, weighted F1 {agg['weighted avg']['f1-score']:.4f}")

    seen = {}
    spied = {"generate_estimated_dna": "rna2dna", "generate_estimated_rna": "dna2rna"}
    real = {name: getattr(downstream_directional, name) for name in spied}

    def spy(name):
        def call(model, x, sites):
            est = real[name](model, x, sites)
            seen[spied[name]] = (model.run_id, x, np.asarray(sites), est)
            return est
        return call

    zero_counts()
    t0 = time.perf_counter()
    try:
        for name in spied:
            setattr(downstream_directional, name, spy(name))
        with contextlib.redirect_stdout(Tee(sys.stdout)):
            reports = downstream_directional.main(cfg, data=data, device=dev, root=workdir)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(downstream_directional, name, fn)
    wall = time.perf_counter() - t0
    launches = counts["downstream_directional"] = read_counts()
    want = {name: int(name in KERNELS) for name in launches}
    if launches != want:
        raise AssertionError(f"downstream_directional.main launched {launches}, want {want}")
    say(f"[downstream] downstream_directional.main (4 scenarios, shallow MLP, 2 populations): "
        f"{wall:.2f} s; launches {launches}; {card}")
    orig = downstream.prepare_filtered_val_data(cfg, True, data=data)[4]
    seed = loading._seed_of(None)
    for ckpt, apply, kw in (("rna2dna", rna2dna_vae_apply, "rna"),
                            ("dna2rna", dna2rna_vae_apply, "dna")):
        run_id, x, sites, est = seen[ckpt]
        if not np.array_equal(sites, orig):
            raise AssertionError(f"{ckpt} was conditioned on other than the original site codes")
        p, s, _ = checkpoint.load_best(ckpt, run_id, cfg.checkpoint_dir)
        eps = fv.philox_normal_reference(seed, len(x), CFG.latent_dim, dev)
        with torch.no_grad():
            ref = apply(tree_from_numpy(p, dev), tree_from_numpy(s, dev), site=torch.as_tensor(
                sites).to(dev), eps=eps, **{kw: torch.as_tensor(x).to(dev)}).recon
        check_near(f"{ckpt} imputation of the downstream rows", est, ref.cpu().numpy(), **TOL)
        say(f"[downstream] {ckpt}: the {len(x)} served imputations within "
            f"{np.abs(est - ref.cpu().numpy()).max():.3g} of the plain eval forward given the "
            f"kernel's Philox draws (atol = rtol = {TOL['atol']}); conditioned on the original "
            "site codes")
    for name, rep in reports.items():
        say(f"[downstream]   {name:24s} accuracy {rep['accuracy']:.4f}, weighted F1 "
            f"{rep['weighted avg']['f1-score']:.4f}")
    return counts


def time_classifier_population(dev, card, n_samples=8000):
    """One deep population epoch on the ``n_samples`` cohort's filtered
    validation rows (1600 at 8000 samples; 5 folds of ~1280 training rows,
    40 steps) with the side-by-side group's 4 scenarios x 5 folds = 20
    members, beside one member's epoch alone (`timed_epochs`: host clock
    and CUDA events, the init taken off); then the device busy share and
    kernels a step of one epoch of each (init included)."""
    rna, dna, labels, _ = downstream.prepare_filtered_val_data(
        CFG, data=generate_synthetic_arrays(n_samples=n_samples, seed=2))
    folds, n_classes = classifier_folds(rna, dna, labels)
    members = folds * 4
    seeds = [f for _ in range(4) for f in range(DS_FOLDS)]
    recipe = dict(downstream.DEEP)
    runs = {
        f"{len(members)}-member population": lambda n: mc.fit_classifier_folds(
            members, n_classes, seeds=seeds, device=dev, **(recipe | {"num_epochs": n})),
        "one member, fit_classifier": lambda n: mc.fit_classifier(
            *folds[0][:4], n_classes, folds[0][4], 0, device=dev, **(recipe | {"num_epochs": n})),
    }
    steps = -(-len(folds[0][0]) // CFG.batch_size)
    (pop_ms, pop_ev), (one_ms, one_ev) = (timed_epochs(run, 0, 1) for run in runs.values())
    say(f"[downstream] deep MLP, {n_samples}-sample cohort ({sum(len(f[2]) for f in folds)} "
        f"validation rows, {len(folds[0][0])} training rows a fold, {steps} steps, width "
        f"{CLS_WIDTH}): one {len(members)}-member population epoch {pop_ms:.3f} ms host clock "
        f"({pop_ev:.3f} ms CUDA events) against one member's epoch {one_ms:.3f} ms "
        f"({one_ev:.3f}); {len(members)} single fits would take {len(members) * one_ms:.3f} ms, "
        f"{len(members) * one_ms / pop_ms:.2f}x the population; {card}")
    for what, run in runs.items():
        wall_ms, rows = profile_call(lambda: run(1))
        busy_ms = sum(r[0] for r in rows)
        kernels = sum(r[1] for r in rows)
        say(f"[downstream-profile] {what}, one epoch of {steps} steps (init included): wall "
            f"{wall_ms:.3f} ms under the profiler, device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%), {kernels} kernels, {kernels / steps:.1f} a step; "
            f"{card}")
        for ms, count, key in sorted(rows, reverse=True)[:6]:
            say(f"[downstream-profile]   {short_name(key):48s} {ms:9.3f} ms  {count:6d} launches")


def phase_downstream(dev, workdir, tpm, beta, site, card):
    """The downstream slice: `compare_classifier_steps`,
    `compare_classifier_populations`, `run_downstream_mains` and
    `time_classifier_population`. Returns the launch counts of the two
    driven flows."""
    t0 = time.perf_counter()
    compare_classifier_steps(dev, card)
    compare_classifier_populations(dev, tpm, beta, site, card)
    counts = run_downstream_mains(dev, workdir, tpm, beta, site, card)
    time_classifier_population(dev, card)
    say(f"[downstream] phase: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# the cross-modality CV: fold populations against single runs, the CV entry

CV_TASKS = ("rna2dna", "dna2rna", "rna2dna_ae", "rna2dna_unified")  # unified at kl_on = 0
CV_FOLDS, CV_EPOCHS = 5, 3
# 5 folds of the whole 1024-sample cohort give 737-row inner training splits,
# whose last batch of 32 has one row: train-mode BatchNorm refuses it, in the
# reference too. The CV's --subset 0.99 (1014 rows) gives 729 and 730.
CV_SUBSET = 0.99
MEMBER_RTOL = 2e-4  # the JAX package's population-against-sequential tolerance


def hold_member(what, res, single, epochs, rtol=MEMBER_RTOL):
    """The largest relative distance of a population member's train and
    validation losses from its single run's; raises unless it is within
    ``rtol`` (None: printed, not held) and the epochs (``epochs`` each), best
    epoch, stop, βs and rates are equal."""
    same = (res.epochs_ran == single.epochs_ran == epochs and res.best_epoch == single.best_epoch
            and np.array_equal(res.lrs, single.lrs) and np.array_equal(res.betas, single.betas)
            and res.stopped == single.stopped)
    rel = max(float(np.max(np.abs(res.train_losses / single.train_losses - 1))),
              float(np.max(np.abs(res.val_losses / single.val_losses - 1))))
    if not same or not np.isfinite(rel) or (rtol is not None and not rel <= rtol):
        raise AssertionError(
            f"{what}: epochs {res.epochs_ran}/{single.epochs_ran}, best "
            f"{res.best_epoch}/{single.best_epoch}, lrs {res.lrs}/{single.lrs}, betas "
            f"{res.betas}/{single.betas}, train {res.train_losses}/{single.train_losses}, val "
            f"{res.val_losses}/{single.val_losses} (rel {rel:.3g})")
    return rel


def cv_fold_tables(tpm, beta, site, n_folds):
    """The CV's inner (train, validation) tables of each fold, as
    ``cross_modality_cv`` builds them."""
    tr, va = [], []
    for train_index, _ in kfold_indices(len(tpm), n_folds):
        a, b = cv_inner_split(train_index)
        tr.append((tpm[a], beta[a], site[a]))
        va.append((tpm[b], beta[b], site[b]))
    return tr, va


def compare_populations(dev, tpm, beta, site, card):
    """`vmap_meta.fit_folds` of 5 folds x 3 epochs for each of `CV_TASKS`
    on the rows of ``--subset 0.99`` of the 1024-sample cohort (two size
    groups), each member against ``engine.fit``'s plain
    path at its seed on the card: train and validation losses within rtol
    2e-4, the epoch count, the best epoch and the rates equal. Returns the
    RNA→DNA population's loss-pair launches."""
    rows = cross_modality_cv.subset_rows(len(tpm), CV_SUBSET)
    tr, va = cv_fold_tables(tpm[rows], beta[rows], site[rows], CV_FOLDS)
    seeds = vmap_meta.member_seeds(0, CV_FOLDS)
    launches = {}
    for name in CV_TASKS:
        overrides = ({"kl_on": np.zeros(CV_FOLDS, np.float32)} if name.endswith("_unified")
                     else None)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pop = vmap_meta.fit_folds(name, CFG, tr, va, 0, N_SITES, num_epochs=CV_EPOCHS,
                                  state_overrides=overrides, mask_sizes=False, device=dev)
        torch.cuda.synchronize()
        pop_s = time.perf_counter() - t0
        counts = {k: fl.launches[k] for k in ("rna2dna_loss_forward", "rna2dna_loss_backward")}
        if name.startswith("rna2dna") and not name.endswith("_ae"):
            launches[name] = counts
            steps = sum(CV_EPOCHS * -(-len(t[0]) // CFG.batch_size) for t in tr)
            if counts != {"rna2dna_loss_forward": steps + CV_EPOCHS * CV_FOLDS,
                          "rna2dna_loss_backward": steps}:
                raise AssertionError(f"{name} population: loss-pair launches {counts}, "
                                     f"{steps} member steps")
        elif any(counts.values()):
            raise AssertionError(f"{name} population launched the loss pair: {counts}")
        worst, single_s = 0.0, 0.0
        for i, res in enumerate(pop):
            params, state = get_task(name).init(torch.Generator().manual_seed(seeds[i]), CFG,
                                                N_SITES, dev)
            if overrides:
                state["kl_on"] = torch.zeros((), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = engine.fit(name, CFG, tr[i], va[i], seeds[i], N_SITES,
                                num_epochs=CV_EPOCHS, drop_last=False, init_params=params,
                                init_state=state, device=dev)
            torch.cuda.synchronize()
            single_s += time.perf_counter() - t0
            worst = max(worst, hold_member(f"{name} member {i}", res, single, CV_EPOCHS))
        say(f"[cv] fit_folds {name}{' (kl_on 0)' if overrides else ''}, {CV_FOLDS} folds x "
            f"{CV_EPOCHS} epochs, {len(rows)} samples: each member within {worst:.3g} (rtol) of "
            f"engine.fit at its seed, epochs, best epoch and rates equal; population "
            f"{pop_s:.3f} s, the {CV_FOLDS} single runs {single_s:.3f} s; {card}")
    return launches


def time_population_epoch(dev, card, task="rna2dna", n_samples=8000, n_folds=10):
    """One epoch of the ``n_folds`` population on the ``n_samples`` cohort
    beside one plain ``engine.fit`` epoch of its first member (host clock and
    CUDA events, the init alone, a 0-epoch call, taken off each) and, for a
    task with an epoch kernel, `time_fused_epoch` of that member."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=n_samples, seed=2)
    tr, va = cv_fold_tables(tpm, beta, site, n_folds)
    seed = vmap_meta.member_seeds(0, n_folds)[0]
    runs = {
        "population": lambda n: vmap_meta.fit_folds(task, CFG, tr, va, 0, N_SITES,
                                                    num_epochs=n, mask_sizes=False, device=dev),
        "single": lambda n: engine.fit(task, CFG, tr[0], va[0], seed, N_SITES, num_epochs=n,
                                       drop_last=False, device=dev),
    }
    out = {what: timed_epochs(run, 0, 1) for what, run in runs.items()}
    steps = -(-len(tr[0][0]) // CFG.batch_size)
    (pop_ms, pop_ev), (one_ms, one_ev) = out["population"], out["single"]
    say(f"[cv] {task}, {n_samples}-sample cohort, {n_folds} folds ({len(tr[0][0])} training, "
        f"{len(va[0][0])} validation rows a fold, {steps} steps): one population epoch "
        f"{pop_ms:.3f} ms host clock ({pop_ev:.3f} ms CUDA events) against one plain "
        f"engine.fit epoch of one member {one_ms:.3f} ms ({one_ev:.3f}); {n_folds} single "
        f"runs would take {n_folds * one_ms:.3f} ms, {n_folds * one_ms / pop_ms:.2f}x the "
        f"population; {card}")
    if task in engine.FUSED:
        out["single_fused"] = time_fused_epoch(dev, card, task, tr[0], va[0], seed, n_folds,
                                               pop_ms)
    return out


def timed_epochs(run, n0, n1):
    """(host ms, CUDA-event ms) of ``run(n1)`` less ``run(n0)``, each one
    call between two synchronisations, over ``n1 - n0``."""
    times = []
    for n in (n0, n1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run(n)
        end.record()
        end.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end)))
    return tuple((b - a) / (n1 - n0) for a, b in zip(*times))


def time_fused_epoch(dev, card, task, train, val, seed, n_folds, pop_ms, extra=10):
    """One ``engine.fit(fused_epoch=True)`` epoch of one member: the kernel
    path needs full batches (``drop_last=True``, one step fewer than the
    CV's); from one init given to every call, after a warm-up call that
    captures the epoch graph, ``1 + extra`` epochs less 1 over ``extra``
    (an epoch of ~20 ms is within the init's host-time noise, so the 0-epoch
    difference of the other runs cannot time it)."""
    params, state = get_task(task).init(torch.Generator().manual_seed(seed), CFG, N_SITES, dev)
    ran = {}

    def run(n):
        ran[n] = engine.fit(task, CFG, train, val, seed, N_SITES, num_epochs=n, drop_last=True,
                            fused_epoch=True, init_params=params, init_state=state,
                            device=dev).epochs_ran

    run(1)
    ms, ev = timed_epochs(run, 1, 1 + extra)
    if ran[1 + extra] != 1 + extra:
        raise AssertionError(f"the fused run stopped after {ran[1 + extra]} epochs: "
                             "the per-epoch time would mix in fewer epochs")
    say(f"[cv] {task}: one engine.fit(fused_epoch=True) epoch of one member "
        f"({len(train[0]) // CFG.batch_size} full steps; {1 + extra} epochs less 1, over "
        f"{extra}, its graph captured in a warm-up call) {ms:.3f} ms host clock ({ev:.3f} ms "
        f"CUDA events); {n_folds} such runs would take {n_folds * ms:.3f} ms, the population "
        f"{pop_ms / (n_folds * ms):.2f}x that; {card}")
    return ms, ev


def profile_population_step(dev, card, task="rna2dna", n_samples=1040, n_folds=10):
    """Device busy share and kernels a step of one population epoch of
    ``n_folds`` members (torch.profiler), beside one plain ``engine.fit``
    epoch of its first member: each member's batch is 32 rows, as at 8000
    samples, and 1040 samples give one group of 10 equal folds (842
    training rows, 27 steps). The kernels a step include the epoch's one
    validation pass."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=n_samples, seed=2)
    tr, va = cv_fold_tables(tpm, beta, site, n_folds)
    steps = -(-len(tr[0][0]) // CFG.batch_size)
    seed = vmap_meta.member_seeds(0, n_folds)[0]
    calls = {
        f"{n_folds}-member population": lambda: vmap_meta.fit_folds(
            task, CFG, tr, va, 0, N_SITES, num_epochs=1, mask_sizes=False, device=dev),
        "one member, engine.fit": lambda: engine.fit(
            task, CFG, tr[0], va[0], seed, N_SITES, num_epochs=1, drop_last=False, device=dev),
    }
    for what, call in calls.items():
        wall_ms, rows = profile_call(call)
        busy_ms = sum(r[0] for r in rows)
        kernels = sum(r[1] for r in rows)
        say(f"[cv-profile] {task} {what}, one epoch of {steps} steps ({n_samples}-sample "
            f"cohort, init included): wall {wall_ms:.3f} ms under the profiler, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {kernels} kernels, "
            f"{kernels / steps:.1f} a step; {card}")
        for ms, count, key in sorted(rows, reverse=True)[:6]:
            say(f"[cv-profile]   {short_name(key):48s} {ms:9.3f} ms  {count:6d} launches")


def phase_cross_modality_cv(dev, tpm, beta, site, card):
    """The CV slice: `compare_populations`, then ``cross_modality_cv.main``
    with ``data=`` arrays (5 folds x 3 epochs, ``--subset 0.99``, both
    directions, the four
    families with unified VAE/AE populations) with every launch count at 0
    just before it: its summary table, wall seconds and loss-pair launches
    (each >= 1), ten finite records of 5 folds; then `time_population_epoch`
    for the VAE and the AE of RNA→DNA and `profile_population_step`.
    Returns the CV's launch counts."""
    compare_populations(dev, tpm, beta, site, card)
    tee = Tee(sys.stdout)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        results = cross_modality_cv.main(["--folds", str(CV_FOLDS), "--epochs", str(CV_EPOCHS),
                                          "--subset", str(CV_SUBSET)],
                                         data=(tpm, beta, site), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for name in ("rna2dna_loss_forward", "rna2dna_loss_backward"):
        if launches[name] < 1:
            raise AssertionError(f"the cross-modality CV never launched {name}")
    if "FINAL RESULTS SUMMARY" not in tee.copy.getvalue():
        raise AssertionError("the CV printed no summary table")
    if len(results) != 10 or any(
            len(v) != CV_FOLDS or not np.isfinite(v).all()
            for r in results for v in r["fold_metrics"].values()):
        raise AssertionError(f"CV records: {[(r['direction'], r['model']) for r in results]}")
    say(f"[cv] cross_modality_cv.main, {CV_FOLDS} folds x {CV_EPOCHS} epochs, --subset "
        f"{CV_SUBSET} of 1024 samples, "
        f"both directions, mean, kNN (k = 5, 10), unified VAE/AE: {wall:.2f} s; loss-pair "
        f"launches forward {launches['rna2dna_loss_forward']}, backward "
        f"{launches['rna2dna_loss_backward']}; {card}")
    for task in ("rna2dna", "rna2dna_ae"):
        time_population_epoch(dev, card, task)
    profile_population_step(dev, card)
    return launches


# ---------------------------------------------------------------------------
# the masked-size populations (POP_MASK_SIZES, the default): uneven folds as
# one population, the loss pair on each member's valid rows

MASKED_TIMING = (8004, 10)  # samples, folds: inner training sets of 6482 and 6483 rows


def spy_groups():
    """Wrap ``vmap_meta._fit_group`` to record each population's member
    count; returns (the records, a function that restores it)."""
    calls, real = [], vmap_meta._fit_group

    def spy(task, cfg, tr, *a, **k):
        calls.append(tr.tpm.shape[0])
        return real(task, cfg, tr, *a, **k)

    vmap_meta._fit_group = spy
    return calls, lambda: setattr(vmap_meta, "_fit_group", real)


def masked_population_of_one(name, tr, va, seed, maxima, overrides, dev, copies=1):
    """One fold's masked population at the padded ``maxima`` (n_train,
    n_val), or its tables and seed repeated ``copies`` times (the batched
    shapes of a population of that size); returns the first member."""
    stack = lambda t, n: Batch(*(torch.stack([x] * copies) for x in  # noqa: E731
                                 vmap_meta._pad_rows(engine._as_batch(t, dev), n)))
    if overrides is not None:
        overrides = {k: np.repeat(v, copies, 0) for k, v in overrides.items()}
    return vmap_meta._fit_group(get_task(name), CFG, stack(tr, maxima[0]), stack(va, maxima[1]),
                                [seed] * copies, N_SITES, CV_EPOCHS, False, dev,
                                overrides=overrides,
                                sizes=([len(tr[0])] * copies, [len(va[0])] * copies))[0]


def compare_masked_populations(dev, tpm, beta, site, card):
    """`vmap_meta.fit_folds` with ``mask_sizes=True`` of the ``--subset
    0.99`` folds (5 folds x 3 epochs) for each of `CV_TASKS`, every launch
    count at 0 just before each: one population a task (the exact mode
    trains two size groups); the largest and the smallest member bit for
    bit the first member of a population of their own tables and seed
    repeated 5 times (the same batched shapes: a member's numbers are its
    rows' alone); each member against its population of one at the same
    padded maxima, and the largest against ``engine.fit(masked_sizes=True)``
    (a single run), the epochs, best epoch, βs and rates equal and the
    losses' relative distance printed: the batched products of another
    member count round otherwise, and Adam turns that noise in the pre-BN
    biases' zero gradients into ±lr steps (measured on the card: DNA→RNA
    members within 4.6e-5 to 1.92e-3 of their populations of one after 3
    epochs, RNA→DNA within 4.5e-5); and the RNA→DNA populations' loss pair
    exactly a forward a member a true step and a validation, a backward a
    member a true step (the short batches' calls on their valid rows).
    Returns the RNA→DNA VAE's launch counts."""
    rows = cross_modality_cv.subset_rows(len(tpm), CV_SUBSET)
    tr, va = cv_fold_tables(tpm[rows], beta[rows], site[rows], CV_FOLDS)
    n_trs, n_vas = [len(t[0]) for t in tr], [len(v[0]) for v in va]
    maxima = (vmap_meta.bucket_rows(max(n_trs)), vmap_meta.bucket_rows(max(n_vas)))
    seeds = vmap_meta.member_seeds(0, CV_FOLDS)
    big = int(np.argmax(n_trs))
    steps = sum(CV_EPOCHS * -(-n // CFG.batch_size) for n in n_trs)
    want = {"rna2dna_loss_forward": steps + CV_EPOCHS * CV_FOLDS, "rna2dna_loss_backward": steps}
    launches = None
    for name in CV_TASKS:
        unified = name.endswith("_unified")
        overrides = {"kl_on": np.zeros(CV_FOLDS, np.float32)} if unified else None
        groups, restore = spy_groups()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            pop = vmap_meta.fit_folds(name, CFG, tr, va, 0, N_SITES, num_epochs=CV_EPOCHS,
                                      state_overrides=overrides, mask_sizes=True, device=dev)
        finally:
            restore()
        torch.cuda.synchronize()
        pop_s = time.perf_counter() - t0
        counts = read_counts()
        if groups != [CV_FOLDS]:
            raise AssertionError(f"{name}: the masked folds trained as populations of {groups}")
        pair = {k: counts[k] for k in want}
        if name.startswith("rna2dna") and not name.endswith("_ae"):
            if pair != want:
                raise AssertionError(f"{name} masked population: loss-pair launches {pair}, "
                                     f"want {want}")
            launches = launches or counts
        elif any(pair.values()):
            raise AssertionError(f"{name} masked population launched the loss pair: {pair}")
        kl_off = {"kl_on": np.zeros(1, np.float32)} if unified else None
        for i in sorted({big, int(np.argmin(n_trs))}):
            rep = masked_population_of_one(name, tr[i], va[i], seeds[i], maxima, kl_off, dev,
                                           copies=CV_FOLDS)
            if not same_run(pop[i], rep):
                raise AssertionError(f"{name} masked member {i}: val {pop[i].val_losses}, its "
                                     f"tables repeated {CV_FOLDS} times {rep.val_losses}")
        worst = 0.0
        for i, res in enumerate(pop):
            one = masked_population_of_one(name, tr[i], va[i], seeds[i], maxima, kl_off, dev)
            worst = max(worst, hold_member(f"{name} masked member {i}", res, one, CV_EPOCHS,
                                           rtol=None))
        params, state = get_task(name).init(torch.Generator().manual_seed(seeds[big]), CFG,
                                            N_SITES, dev)
        if unified:
            state["kl_on"] = torch.zeros((), device=dev)
        single = engine.fit(
            name, CFG, tuple(vmap_meta._pad_rows(engine._as_batch(tr[big], dev), maxima[0])),
            tuple(vmap_meta._pad_rows(engine._as_batch(va[big], dev), maxima[1])), seeds[big],
            N_SITES, num_epochs=CV_EPOCHS, drop_last=False, init_params=params,
            init_state=state, masked_sizes=True, true_sizes=(n_trs[big], n_vas[big]),
            device=dev)
        rel = hold_member(f"{name} largest masked member", pop[big], single, CV_EPOCHS,
                          rtol=None)
        say(f"[masked] fit_folds {name}{' (kl_on 0)' if unified else ''} mask_sizes=True, "
            f"{CV_FOLDS} folds of {sorted(set(n_trs))} training and {sorted(set(n_vas))} "
            f"validation rows padded to {maxima}: one population; the largest and smallest "
            f"members bit for bit their tables repeated {CV_FOLDS} times; each member within "
            f"{worst:.3g} (rel) of its population of one, the largest within {rel:.3g} of "
            f"engine.fit(masked_sizes=True), epochs, best epoch, betas and rates equal; loss "
            f"pair {pair}; population {pop_s:.3f} s; {card}")
    return launches


def time_masked_population_epoch(dev, card, task="rna2dna"):
    """One population epoch of `MASKED_TIMING`'s folds, masked (one
    population) against ``POP_MASK_SIZES=0`` (two exact size groups), in
    turns masked, exact, exact, masked (`timed_epochs`: host clock and CUDA
    events, the init taken off)."""
    n_samples, n_folds = MASKED_TIMING
    tpm, beta, site = generate_synthetic_arrays(n_samples=n_samples, seed=2)
    tr, va = cv_fold_tables(tpm, beta, site, n_folds)
    sizes = sorted({len(t[0]) for t in tr})
    groups, restore = spy_groups()
    times = {"masked": [], "exact": []}
    try:
        for mode in ("masked", "exact", "exact", "masked"):
            with env_set(POP_MASK_SIZES="1" if mode == "masked" else "0"):
                del groups[:]
                times[mode].append(timed_epochs(lambda n: vmap_meta.fit_folds(
                    task, CFG, tr, va, 0, N_SITES, num_epochs=n, device=dev), 0, 1))
            if len(groups) != (2 if mode == "masked" else 4):  # two calls, 0 and 1 epoch
                raise AssertionError(f"{mode}: populations of {groups} in two calls")
    finally:
        restore()
    mean = {m: tuple(float(np.mean(x)) for x in zip(*t)) for m, t in times.items()}
    say(f"[masked] {task}, {n_samples}-sample cohort, {n_folds} folds ({sizes} training rows, "
        f"padded to {vmap_meta.bucket_rows(max(sizes))}): one population epoch masked "
        f"(one population) {mean['masked'][0]:.3f} ms host clock ({mean['masked'][1]:.3f} ms "
        f"CUDA events) against POP_MASK_SIZES=0 (two size groups) {mean['exact'][0]:.3f} ms "
        f"({mean['exact'][1]:.3f}), {mean['exact'][0] / mean['masked'][0]:.2f}x host; each "
        f"call (masked, exact, exact, masked): "
        + ", ".join(f"{h:.3f}/{e:.3f}" for h, e in times["masked"][:1] + times["exact"]
                    + times["masked"][1:]) + f" ms; {card}")
    return mean


def phase_masked_populations(dev, tpm, beta, site, card):
    """The masked-size slice: `compare_masked_populations`, then
    `time_masked_population_epoch`. Returns the launch counts of the
    RNA→DNA VAE's masked population."""
    launches = compare_masked_populations(dev, tpm, beta, site, card)
    time_masked_population_epoch(dev, card)
    return launches


# ---------------------------------------------------------------------------
# the HPO: trial populations against single runs, the padded bucket, rung
# continuation, the search entry and the training CLI's --replicates

HPO_TRIALS = {  # four tri-modal trials of the live shape, each hyperparameter its own
    "lr": np.array([5e-4, 1e-3, 2e-4, 2e-3], np.float32),
    "weight_decay": np.array([1e-5, 1e-4, 1e-6, 3e-5], np.float32),
    "beta_start": np.array([1e-3, 4e-3, 2e-4, 8e-3], np.float32),
    "gamma": np.array([1.0, 2.5, 0.6, 4.0], np.float32),
}
HPO_EPOCHS = 3
HPO_PADDED = (10, 37, 100)  # one --pad-shapes bucket: the ends and a middle of the space
HPO_MAIN_ARGV = ["--trials", "8", "--epochs", "3", "--prune-rungs", "2"]
REPLICATES = 3


def hpo_split(tpm, beta, site):
    """The HPO's (and the training CLIs') split: (train, val, balanced class
    weights of the training rows)."""
    tr, va = train_val_indices(len(tpm), CFG.train_test_split, CFG.random_seed)
    return ((tpm[tr], beta[tr], site[tr]), (tpm[va], beta[va], site[va]),
            compute_class_weights(site[tr], N_SITES))


def trial_hp(pop, i):
    """``engine.hyperparams`` of trial ``i`` of a population."""
    return engine.hyperparams(CFG, **{k: float(v[i]) for k, v in pop.items()})


PRE_BN_BIASES = ("encoder_a/fc/b", "encoder_b/fc1/b", "encoder_b/fc2/b")  # true gradient 0


def same_run(a, b):
    """Whether two ``FitResult``s hold the same bits: loss rows, best
    epoch and final parameters."""
    return (np.array_equal(a.train_losses, b.train_losses)
            and np.array_equal(a.val_losses, b.val_losses) and a.best_epoch == b.best_epoch
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(
                engine._named_leaves(a.final_params), engine._named_leaves(b.final_params))))


def same_tail(cont, full):
    """Whether a continued run's loss rows and final state are the last rows
    and the final state of the uninterrupted run, bit for bit."""
    k = len(cont.val_losses)
    return same_run(cont, full._replace(train_losses=full.train_losses[-k:],
                                        val_losses=full.val_losses[-k:]))


def compare_trial_step(dev, train, cw, seeds):
    """One train step of the `HPO_TRIALS` population from the trials' inits
    on 32 training rows with injected eps and dropout masks, against each
    trial's own step: the loss rtol 1e-5, the 39 gradients atol 1e-3 + rtol
    1e-4 (2e-3 for `PRE_BN_BIASES`), the tri-modal train step's tolerances.
    Returns the largest gradient difference."""
    task = get_task("multimodal")
    n = len(seeds)
    inits = [task.init(torch.Generator().manual_seed(s), CFG, N_SITES, dev) for s in seeds]
    rows = engine._as_batch(tuple(x[:32] for x in train), dev)
    g = torch.Generator(device=dev).manual_seed(7)
    noise = {"eps": torch.randn(n, 32, CFG.latent_dim, generator=g, device=dev)}
    for name, width in (("drop_a", 128), ("drop_b1", H1), ("drop_b2", H2)):
        noise[name] = (torch.rand(n, 32, width, generator=g, device=dev) < 0.9).float()
    cw = torch.as_tensor(cw).to(dev)

    def step(params, state, batch, beta, gamma, injected):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = task.loss(leaves, state, batch, beta, True, None, gamma=gamma,
                            class_weights=cw, **injected)
        return loss.detach(), torch.autograd.grad(loss.sum(), tree_leaves(leaves))

    loss_p, grads_p = step(
        vmap_meta._stack([p for p, _ in inits]), vmap_meta._stack([s for _, s in inits]),
        Batch(*(torch.stack([x] * n) for x in rows)),
        torch.as_tensor(HPO_TRIALS["beta_start"]).to(dev),
        torch.as_tensor(HPO_TRIALS["gamma"]).to(dev), noise)
    names = [name for name, _ in engine._named_leaves(inits[0][0])]
    worst, rel = 0.0, {True: [], False: []}  # relative differences, by PRE_BN_BIASES or not
    for i, (params, state) in enumerate(inits):
        loss_s, grads_s = step(params, state, rows, float(HPO_TRIALS["beta_start"][i]),
                               float(HPO_TRIALS["gamma"][i]),
                               {k: v[i] for k, v in noise.items()})
        check_close(f"trial {i} step loss", loss_p[i], loss_s, 0.0, 1e-5)
        for name, a, b in zip(names, grads_p, grads_s):
            err = check_close(f"trial {i} gradient {name}", a[i], b,
                              2e-3 if name in PRE_BN_BIASES else 1e-3, 1e-4)
            worst = max(worst, err)
            rel[name in PRE_BN_BIASES].append(err / max(b.abs().max().item(), 1e-30))
    say(f"[hpo] the population's first step against each trial's: the largest gradient "
        f"difference {worst:.3g}; relative to the tensor's largest entry at most "
        f"{max(rel[False]):.3g} in the {len(names) - len(PRE_BN_BIASES)} other tensors, "
        f"{min(rel[True]):.3g} to {max(rel[True]):.3g} in {', '.join(PRE_BN_BIASES)} (their "
        f"true gradient is 0: what is left is fp32 noise)")
    return worst


def compare_trials(dev, tpm, beta, site, card):
    """`vmap_meta.fit_trials` of `HPO_TRIALS` (the tri-modal task, balanced
    class weights, `HPO_EPOCHS` epochs) on the cohort's split:
      * each trial alone (a population of one) gives its ``engine.fit`` run
        at its seed with its hyperparameters bit for bit on the card (loss
        rows, best epoch, final parameters);
      * the 4-trial population's first step against each trial's
        (`compare_trial_step`);
      * the 4-trial population against the single runs: the epochs, best
        epoch, βs and rates equal, the losses' relative distance printed (the
        batched products round otherwise than the single ones, and Adam
        turns the fp32 noise of `PRE_BN_BIASES`' zero gradients into ±lr
        steps, so the trajectories part by a distance that grows with lr;
        PERF.md §6);
      * two rungs: 2 epochs, then all 4 trials for 1 more from their carries
        give the uninterrupted population bit for bit; trial 2 alone in two
        rungs gives its single run bit for bit; trials 0 and 2 continued as a
        population of two are printed against the uninterrupted one."""
    train, val, cw = hpo_split(tpm, beta, site)
    n = len(HPO_TRIALS["lr"])
    seeds = vmap_meta.member_seeds(0, n)
    fit = functools.partial(vmap_meta.fit_trials, "multimodal", CFG, train, val, 0, N_SITES,
                            class_weights=cw, mask_sizes=False, device=dev)
    trial = lambda *idx: {k: v[list(idx)] for k, v in HPO_TRIALS.items()}  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop = fit(HPO_TRIALS, num_epochs=HPO_EPOCHS)
    torch.cuda.synchronize()
    pop_s, single_s, rels, alones = time.perf_counter() - t0, 0.0, [], []
    for i, res in enumerate(pop):
        t0 = time.perf_counter()
        single = engine.fit("multimodal", CFG, train, val, seeds[i], N_SITES,
                            num_epochs=HPO_EPOCHS, class_weights=cw, hp=trial_hp(HPO_TRIALS, i),
                            device=dev)
        torch.cuda.synchronize()
        single_s += time.perf_counter() - t0
        alones.append(fit(trial(i), num_epochs=HPO_EPOCHS, seeds=[seeds[i]])[0])
        alone = alones[-1]
        if not same_run(alone, single):
            raise AssertionError(f"trial {i} alone: val {alone.val_losses}, its single run "
                                 f"{single.val_losses}")
        if not (res.epochs_ran == single.epochs_ran == HPO_EPOCHS
                and res.best_epoch == single.best_epoch
                and np.array_equal(res.betas, single.betas)
                and np.array_equal(res.lrs, single.lrs) and np.isfinite(res.val_losses).all()):
            raise AssertionError(f"trial {i}: epochs {res.epochs_ran}, best {res.best_epoch}/"
                                 f"{single.best_epoch}, betas {res.betas}/{single.betas}")
        rels.append(max(float(np.max(np.abs(res.train_losses / single.train_losses - 1))),
                        float(np.max(np.abs(res.val_losses / single.val_losses - 1)))))
    step_err = compare_trial_step(dev, train, cw, seeds)
    say(f"[hpo] fit_trials multimodal, {n} trials (lr {', '.join(f'{x:g}' for x in HPO_TRIALS['lr'])}; weight decay, "
        f"beta, gamma each their own) x {HPO_EPOCHS} epochs, {len(train[0])} training rows: "
        f"each trial alone is its engine.fit run bit for bit; the population's first step "
        f"within {step_err:.3g} of each trial's (gradients, atol 1e-3 + rtol 1e-4); the "
        f"population's losses within {', '.join(f'{r:.3g}' for r in rels)} (rel) of the single "
        f"runs, epochs, best epoch, betas and rates equal; population {pop_s:.3f} s, the {n} "
        f"single runs {single_s:.3f} s; {card}")

    first = fit(HPO_TRIALS, num_epochs=HPO_EPOCHS - 1, seeds=seeds)
    rest = fit(HPO_TRIALS, num_epochs=1, carry0=[r.carry for r in first],
               start_epoch=HPO_EPOCHS - 1, seeds=seeds)
    head = fit(trial(2), num_epochs=HPO_EPOCHS - 1, seeds=[seeds[2]])
    tail = fit(trial(2), num_epochs=1, carry0=[head[0].carry], start_epoch=HPO_EPOCHS - 1,
               seeds=[seeds[2]])[0]
    if not (all(same_tail(r, p) for r, p in zip(rest, pop)) and same_tail(tail, alones[2])):
        raise AssertionError("a continued population differs from the uninterrupted one")
    keep = [0, 2]
    kept = fit(trial(*keep), num_epochs=1, carry0=[first[j].carry for j in keep],
               start_epoch=HPO_EPOCHS - 1, seeds=[seeds[j] for j in keep])
    moved = []
    for res, j in zip(kept, keep):
        if not (res.best_epoch == pop[j].best_epoch and res.betas[0] == pop[j].betas[-1]):
            raise AssertionError(f"trial {j} continued: best epoch {res.best_epoch}/"
                                 f"{pop[j].best_epoch}")
        moved.append(float(abs(res.val_losses[0] / pop[j].val_losses[-1] - 1)))
    say(f"[hpo] two rungs ({HPO_EPOCHS - 1} epochs, then 1 from the carries): all {n} trials "
        f"continued give the uninterrupted population bit for bit, trial 2 alone its single "
        f"run bit for bit; trials {keep} continued as a population of 2 within "
        f"{', '.join(f'{m:.3g}' for m in moved)} (rel) of the population of {n}'s last "
        f"validation loss, best epochs and betas equal; {card}")
    return train, val, cw


def masked_slices(tree, member, width, live=False):
    """Member ``member``'s slices of the encoder heads' columns and the
    decoders' first-layer rows beyond its live ``width`` (``live``: within)."""
    cut = slice(None, width) if live else slice(width, None)
    out = {}
    for enc in ("encoder_a", "encoder_b", "encoder_c"):
        for head in ("mu", "logvar"):
            out[f"{enc}/{head}/w"] = tree[enc][head]["w"][member][:, cut]
            out[f"{enc}/{head}/b"] = tree[enc][head]["b"][member][cut]
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        out[f"{dec}/fc1/w"] = tree[dec]["fc1"]["w"][member][cut]
    return out


def check_padded_bucket(dev, train, val, cw, card):
    """One ``--pad-shapes`` bucket: trials of latent widths `HPO_PADDED`
    trained 2 epochs at the largest as one ``multimodal_padded`` population
    from ``hpo._padded_carry``; then one train-mode forward and backward of
    the trained trials on 32 training rows: the masked dims of mu and logvar,
    their KL terms and the gradients of every masked weight slice exactly 0,
    every live slice's gradient not; and each trial alone (its own padded
    carry) against ``engine.fit`` from the same init, bit for bit, with the
    population's distance from those runs printed."""
    width = max(HPO_PADDED)
    cfg = CFG.replace(latent_dim=width, patience=10**6)
    seeds = hpo._trial_seeds(0, range(len(HPO_PADDED)))
    lrs = HPO_TRIALS["lr"][:len(HPO_PADDED)]
    carry = hpo._padded_carry(cfg, N_SITES, seeds, lrs, HPO_PADDED, dev)
    res = vmap_meta.fit_trials("multimodal_padded", cfg, train, val, 0, N_SITES, {"lr": lrs},
                               num_epochs=2, class_weights=cw, carry0=carry, seeds=seeds,
                               mask_sizes=False, device=dev)
    params = vmap_meta._stack([r.final_params for r in res])
    state = vmap_meta._stack([r.final_state for r in res])
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    rows = engine._as_batch(tuple(x[:32] for x in train), dev)
    batch = Batch(*(torch.stack([t] * len(seeds)) for t in rows))
    gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    out = multimodal_vae_apply(leaves, state, a=batch.tpm, b=batch.beta, site=batch.site,
                               train=True, generator=gens, latent_mask=state["latent_mask"])
    total, _ = losses.vae_loss(out.out_a, batch.tpm, out.out_b_logits, batch.beta, out.out_c,
                               batch.site, out.mu, out.logvar, beta=1e-3, gamma=1.0,
                               class_weights=torch.as_tensor(cw).to(dev), members=True)
    flat = iter(torch.autograd.grad(total.sum(), tree_leaves(leaves)))
    grads = tree_map(lambda _: next(flat), leaves)
    n_slices = 0
    for j, w in enumerate(HPO_PADDED):
        mu, lv = out.mu[j, :, w:].detach(), out.logvar[j, :, w:].detach()
        if mu.any() or lv.any() or losses.kl_divergence(mu, lv).item() != 0.0:
            raise AssertionError(f"padded trial {j} (latent {w}): masked mu/logvar not 0")
        for name, g in masked_slices(grads, j, w).items():
            if g.numel() and g.any():
                raise AssertionError(f"padded trial {j}: gradient in masked slice {name}")
            n_slices += g.numel() > 0
        if not all(g.abs().max() > 0 for g in masked_slices(grads, j, w, live=True).values()):
            raise AssertionError(f"padded trial {j}: a live slice got no gradient")
    vals = [float(r.val_losses[-1]) for r in res]
    if not np.isfinite(vals).all():
        raise AssertionError(f"padded bucket: validation losses {vals}")
    rels = []
    for j, w in enumerate(HPO_PADDED):  # each trial alone against its single run
        own = hpo._padded_carry(cfg, N_SITES, seeds[j:j + 1], lrs[j:j + 1], (w,), dev)
        alone = vmap_meta.fit_trials("multimodal_padded", cfg, train, val, 0, N_SITES,
                                     {"lr": lrs[j:j + 1]}, num_epochs=2, class_weights=cw,
                                     carry0=own, seeds=seeds[j:j + 1], mask_sizes=False,
                                     device=dev)[0]
        single = engine.fit("multimodal_padded", cfg, train, val, seeds[j], N_SITES,
                            num_epochs=2, class_weights=cw,
                            hp=engine.hyperparams(cfg, lr=float(lrs[j])),
                            init_params=tree_map(lambda t: t[0], own["params"]),
                            init_state=tree_map(lambda t: t[0], own["state"]), device=dev)
        if not same_run(alone, single):
            raise AssertionError(f"padded trial {j} alone: val {alone.val_losses}, its single "
                                 f"run {single.val_losses}")
        rels.append(float(np.max(np.abs(res[j].val_losses / single.val_losses - 1))))
    say(f"[hpo] padded bucket, latents {HPO_PADDED} at {width}, 2 epochs: validation losses "
        f"{', '.join(f'{v:.2f}' for v in vals)}; masked mu, logvar, KL and {n_slices} masked "
        f"weight slices' gradients exactly 0; each trial alone is its engine.fit run "
        f"(multimodal_padded, from its padded init) bit for bit, the population within "
        f"{', '.join(f'{r:.3g}' for r in rels)} (rel) of those runs; {card}")


def run_hpo_main(dev, tpm, beta, site, argv, card):
    """``hpo.main(argv, data=...)`` with every launch count at 0 just before
    it: its wall seconds, a finite best value, ``best_hyperparameters.json``
    and the retrained checkpoint (read back, its latent width the winner's);
    returns the launch counts (the tri-modal plain path launches none)."""
    for path in ("best_hyperparameters.json",
                 os.path.join(CFG.checkpoint_dir, "best_multivae_optimized.npz")):
        if os.path.exists(path):
            os.remove(path)
    tee = Tee(sys.stdout)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best, value = hpo.main(argv, data=(tpm, beta, site), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    with open("best_hyperparameters.json") as f:
        saved = json.load(f)
    params, _ = checkpoint.load(os.path.join(CFG.checkpoint_dir, "best_multivae_optimized.npz"))
    if not (np.isfinite(value) and saved["best_params"] == best
            and params["decoder_a"]["fc1"]["w"].shape == (best["latent_dim"], 128)):
        raise AssertionError(f"hpo.main {argv}: best {best}, value {value}, saved {saved}")
    if any(launches.values()):
        raise AssertionError(f"hpo.main launched kernels: {launches}")
    text = tee.copy.getvalue()
    say(f"[hpo] hpo.main {' '.join(argv)}: {wall:.2f} s, best val loss {value:.2f} ({best}), "
        f"{text.count('[complete]')} complete, {text.count('PRUNED@')} pruned, "
        f"{text.count('[failed]')} failed, both artifacts written; launches {launches}; {card}")
    return launches


def phase_replicates(dev, workdir, tpm, beta, site, card):
    """``run_training("rna2dna", ...)`` with ``--replicates`` `REPLICATES`
    and USE_PALLAS (routed to the plain population path, which the CLI
    says), every launch count at 0 just before it: each replicate's value
    printed, the best kept, and the loss pair exactly once a member a step
    and a validation (forward) and once a member a step (backward); no other
    kernel. Returns the launch counts."""
    tee = Tee(sys.stdout)
    zero_counts()
    with contextlib.redirect_stdout(tee):
        result, run_id, wall = run_training(
            "rna2dna", "rna2dna", cfg=CFG.replace(use_pallas=True),
            argv=["--epochs", str(HPO_EPOCHS), "--replicates", str(REPLICATES)],
            data=(tpm, beta, site), device=dev, root=workdir)
    launches = read_counts()
    text = tee.copy.getvalue()
    n_train = len(train_val_indices(len(tpm), CFG.train_test_split, CFG.random_seed)[0])
    steps = n_train // CFG.batch_size
    want = {"rna2dna_loss_forward": REPLICATES * HPO_EPOCHS * (steps + 1),
            "rna2dna_loss_backward": REPLICATES * HPO_EPOCHS * steps}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if ({k: launches[k] for k in want} != want or others
            or "using the plain population path" not in text
            or any(f"r{r}=" not in text for r in range(REPLICATES))
            or not np.isfinite(result.best_val_loss)):
        raise AssertionError(f"--replicates {REPLICATES}: launches {launches} (want {want}), "
                             f"best {result.best_val_loss}")
    say(f"[hpo] run_training rna2dna --replicates {REPLICATES} (USE_PALLAS, routed to the plain "
        f"population path), {HPO_EPOCHS} epochs of {steps} steps: {wall:.2f} s, kept best val "
        f"loss {result.best_val_loss:.2f}; loss pair forward {launches['rna2dna_loss_forward']}"
        f", backward {launches['rna2dna_loss_backward']} (once a member a step, and a "
        f"validation); {card}")
    return launches


def time_trial_population(dev, card, n_samples=8000, n_trials=8):
    """One epoch of an ``n_trials`` tri-modal trial population (the live
    shape, the hyperparameters of ``hpo.sample_trials``) on the
    ``n_samples`` cohort beside one plain ``engine.fit`` epoch of its first
    trial (`timed_epochs`: host clock and CUDA events, the init taken off);
    then the device busy share and kernels a step of one epoch of each on
    the 1024-sample cohort (25 steps a member, the same step as at 8000)."""
    trials = hpo.sample_trials(n_trials, 0, n_trials)
    pop = {k: np.asarray([t[name] for t in trials], np.float32)
           for k, name in hpo.FIT_KEYS.items()}
    seed = vmap_meta.member_seeds(0, n_trials)[0]
    for samples in (n_samples, 1024):
        train, val, cw = hpo_split(*generate_synthetic_arrays(n_samples=samples, seed=2))
        runs = {
            f"{n_trials}-trial population": lambda n: vmap_meta.fit_trials(
                "multimodal", CFG, train, val, 0, N_SITES, pop, num_epochs=n,
                class_weights=cw, mask_sizes=False, device=dev),
            "one trial, engine.fit": lambda n: engine.fit(
                "multimodal", CFG, train, val, seed, N_SITES, num_epochs=n, class_weights=cw,
                hp=trial_hp(pop, 0), device=dev),
        }
        steps = len(train[0]) // CFG.batch_size
        if samples == n_samples:
            (pop_ms, pop_ev), (one_ms, one_ev) = (timed_epochs(run, 0, 1)
                                                  for run in runs.values())
            say(f"[hpo] multimodal, {samples}-sample cohort, {n_trials} trials ({steps} steps): "
                f"one population epoch {pop_ms:.3f} ms host clock ({pop_ev:.3f} ms CUDA "
                f"events) against one plain engine.fit epoch of one trial {one_ms:.3f} ms "
                f"({one_ev:.3f}); {n_trials} single runs would take {n_trials * one_ms:.3f} ms, "
                f"{n_trials * one_ms / pop_ms:.2f}x the population; {card}")
            continue
        for what, run in runs.items():
            wall_ms, rows = profile_call(lambda: run(1))
            busy_ms = sum(r[0] for r in rows)
            kernels = sum(r[1] for r in rows)
            say(f"[hpo-profile] multimodal {what}, one epoch of {steps} steps ({samples}-sample "
                f"cohort, init included): wall {wall_ms:.3f} ms under the profiler, device busy "
                f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {kernels} kernels, "
                f"{kernels / steps:.1f} a step; {card}")
            for ms, count, key in sorted(rows, reverse=True)[:6]:
                say(f"[hpo-profile]   {short_name(key):48s} {ms:9.3f} ms  {count:6d} launches")


def phase_hpo(dev, workdir, tpm, beta, site, card):
    """The HPO slice: `compare_trials`, `check_padded_bucket`, `run_hpo_main`
    with `HPO_MAIN_ARGV` and with ``--pad-shapes``, `phase_replicates`, and
    `time_trial_population`. Returns the launch counts of each driven path."""
    train, val, cw = compare_trials(dev, tpm, beta, site, card)
    check_padded_bucket(dev, train, val, cw, card)
    counts = {"hpo": run_hpo_main(dev, tpm, beta, site, HPO_MAIN_ARGV, card),
              "hpo_padded": run_hpo_main(dev, tpm, beta, site,
                                         ["--trials", "8", "--epochs", "3", "--pad-shapes"],
                                         card),
              "replicates": phase_replicates(dev, workdir, tpm, beta, site, card)}
    time_trial_population(dev, card)
    return counts


# ---------------------------------------------------------------------------
# phase 6: time

def time_call(fn, reps=30, warmup=5):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def alternate(kernel, plain, reps=30, warmup=5):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, averaged."""
    p1 = time_call(plain, reps, warmup)
    k1 = time_call(kernel, reps, warmup)
    k2 = time_call(kernel, reps, warmup)
    p2 = time_call(plain, reps, warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


def host_ms(fn, reps=30):
    """Median host milliseconds of one call of ``fn`` (what it takes to
    enqueue its work), each call made after the card has drained."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e3


def time_loop(fn, reps=20):
    """Milliseconds a call of ``fn`` over ``reps`` calls back to back (CUDA
    events), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


STEP_FN = {"multimodal": "multimodal_fused_train_step", "dna2rna": "dna2rna_fused_train_step",
           "rna2dna": "rna2dna_fused_train_step"}


def step_call(mod, task, inp, seed=1, step=0, injected=False, beta=BETA, gamma=GAMMA):
    """A call of ``task``'s step wrapper in ``mod`` on ``inp`` = (params,
    state, rows), Philox noise (as ``engine.fit`` calls it) or the rows'
    injected noise; γ and the rows' class weights for the tri-modal model."""
    params, state, r = inp
    fn = getattr(mod, STEP_FN[task])
    kw = dict(seed=seed, step=step, beta=beta)
    if task == "multimodal":
        kw.update(gamma=gamma, class_weights=r["cw"])
        if injected:
            kw.update({k: r[k] for k in MM_NOISE})
        return lambda: fn(params, state, r["a"], r["b"], r["site"], N_SITES, **kw)
    if task == "dna2rna":
        if injected:
            kw.update(eps=r["eps"], drop_mask1=r["drop1"], drop_mask2=r["drop2"])
        return lambda: fn(params, state, r["t"], r["x"], r["site"], N_SITES, **kw)
    if injected:
        kw.update(eps=r["eps"], drop_mask=r["drop"])
    return lambda: fn(params, state, r["x"], r["t"], r["site"], N_SITES, **kw)


def host_loop_entry(mod, task, inp):
    """The host-loop C entry of an older tree's step (its phases launched
    from the host; every step of this tree is a graph), on buffers packed
    once, Philox noise."""
    params, state, r = inp
    lib, dev = mod.library(), r["site"].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    order, dims_of, entry = {
        "multimodal": (mod.PARAM_ORDER_MM, mod.dims_of_mm, "multimodal_train_step"),
        "dna2rna": (mod.PARAM_ORDER_D2R, mod.dims_of_d2r, "dna2rna_train_step"),
        "rna2dna": (mod.PARAM_ORDER, mod.dims_of, "rna2dna_train_step")}[task]
    flat = mod.flatten_params(params, order)
    dims_t = dims_of(flat)
    dims = (ctypes.c_int * len(dims_t))(*dims_t)
    keep = {"p": mod.pack(flat, order), "loss": torch.empty(1, device=dev)}
    keep["g"] = torch.empty_like(keep["p"])
    keep["work"] = torch.empty(getattr(lib, entry.replace("_step", "_workspace_floats"))(
        dims, 32, 0), device=dev)
    if task == "rna2dna":
        bn = state["encoder_rna"]["bn"]
        keep["rm"], keep["rv"] = torch.empty_like(bn["mean"]), torch.empty_like(bn["var"])
        args = (r["x"].data_ptr(), r["t"].data_ptr(), r["site"].data_ptr(), keep["p"].data_ptr(),
                dims, 32, bn["mean"].data_ptr(), bn["var"].data_ptr(), keep["rm"].data_ptr(),
                keep["rv"].data_ptr(), None, None, 1, 1, 0, BETA)
    else:
        bn = mod.bn_mm(state) if task == "multimodal" else mod.bn_d2r(state)
        keep["bn_in"] = torch.cat(bn)
        keep["bn_out"] = torch.empty_like(keep["bn_in"])
        if task == "multimodal":
            args = (r["a"].data_ptr(), r["b"].data_ptr(), r["site"].data_ptr(), r["cw"].data_ptr(),
                    keep["p"].data_ptr(), dims, 32, keep["bn_in"].data_ptr(),
                    keep["bn_out"].data_ptr(), None, None, None, None, 1, 1, 0, BETA, GAMMA)
        else:
            args = (r["x"].data_ptr(), r["t"].data_ptr(), r["site"].data_ptr(),
                    keep["p"].data_ptr(), dims, 32, keep["bn_in"].data_ptr(),
                    keep["bn_out"].data_ptr(), None, None, None, 1, 1, 0, BETA)
    call = functools.partial(getattr(lib, entry), *args, keep["loss"].data_ptr(),
                             keep["g"].data_ptr(), keep["work"].data_ptr(), stream)
    call.keep = keep
    return call


def c_entry(mod, task, inp):
    """The step's C entry alone, on buffers filled once: a cached step
    graph's launch where the tree has one for ``task``, else its host-loop
    entry."""
    graphs = getattr(mod, "step_graphs", None)
    if graphs is None or task not in getattr(mod, "STEP_GRAPH_TASKS", ()):
        return host_loop_entry(mod, task, inp)
    step_call(mod, task, inp)()
    g = graphs[task][1]
    lib = mod.library()
    stream = torch.cuda.current_stream(inp[2]["site"].device).cuda_stream
    return functools.partial(lib.step_graph_launch, g.handle,
                             mod.step_args(1, 0, BETA, GAMMA), stream)


def step_split(name, task, inp, card):
    """A step call at B = 32 split into host and device: the wrapper's
    CUDA-event ms a call and host ms, its C entry alone back to back between
    CUDA events and its host ms (`c_entry`), the device µs by kernel of one
    wrapper call (torch.profiler) and the launches a call."""
    call, entry = step_call(ft, task, inp), c_entry(ft, task, inp)
    call_ms, call_host = time_call(call), host_ms(call)
    loop_ms, entry_host = time_loop(entry, 50), host_ms(entry)
    _, rows = profile_call(call)
    graph = ft.step_graphs.get(task, (None, None))[1]
    launch = (f"1 graph launch of {graph.nodes} kernels (captured in "
              f"{graph.capture_seconds * 1e3:.1f} ms)" if graph is not None
              else "the host loop's launches")
    device = ("not measured (the profiler caught no kernel)" if not rows else
              f"{1e3 * sum(r[0] for r in rows):.2f} us in {sum(r[1] for r in rows)} kernels ("
              + ", ".join(f"{short_name(k)} {1e3 * ms:.2f} us x{n}"
                          for ms, n, k in sorted(rows, reverse=True)) + ")")
    say(f"[split] {name} B=32: a wrapper call {call_ms:.4f} ms, its host {1e3 * call_host:.1f} "
        f"us; the C entry alone {loop_ms:.4f} ms back to back, its host "
        f"{1e3 * entry_host:.1f} us; device {device}; a call is {launch}; {card}")


def profile_call(fn):
    """(wall ms, [(device ms, launches, kernel name)]) of one call of ``fn``
    under torch.profiler, after a warm-up call. A window that caught no
    device event is profiled again (up to three times): such windows were
    seen on the card after an earlier profiler session in the process."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                rows.append((us / 1e3, ev.count, ev.key))
        if rows:
            break
    return wall_ms, rows


def short_name(key):
    return key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1][:48]


def profile_epoch(fn, what, card):
    """Device time by kernel over one call (torch.profiler), against its
    wall time: the device's busy and idle shares."""
    wall_ms, rows = profile_call(fn)
    busy_ms = sum(r[0] for r in rows)
    say(f"[profile] {what}: wall {wall_ms:.3f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle {100 - 100 * busy_ms / wall_ms:.1f}%; "
        f"{sum(r[1] for r in rows)} kernels; {card}")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        say(f"[profile]   {short_name(key):48s} {ms:9.3f} ms  {count:6d} launches  "
            f"{1e3 * ms / count:8.2f} us each")


def time_serving(dev, card):
    """Each serving kernel at B in SERVE_TIMED against its plain version
    (CUDA events, alternated) beside its bound; one call at B = 205 and at
    B = 1 profiled (device time by kernel, kernels a call) and the host cost
    of a call (the CUDA-event time of one call at B = 1 less its device
    time); DNA→RNA at a DNA input of 65,536, B = 205. Returns {name: (ms,
    plain_ms, None, bound work)} at B = 205."""
    out = {}
    for k, (name, (cls, model_cls, ckpt, din, _)) in enumerate(KERNELS.items()):
        params, state = jax_from_state_dict(port_model(model_cls, k, False).state_dict(), ckpt)
        fused = cls(params, state, dev)
        g = torch.Generator(device=dev).manual_seed(300 + k)
        for batch in (1,) + SERVE_TIMED:
            x = torch.rand((batch, din), generator=g, device=dev)
            site = torch.randint(0, N_SITES, (batch,), generator=g, device=dev)
            call = lambda: fused(x, site, seed=7)  # noqa: E731
            if batch in SERVE_TIMED:
                ms, plain_ms = alternate(call, lambda: cls._reference(
                    fused.folded, x, site, fv.NOISE_PHILOX, None, 7))
                work = serving_work(name, batch)
                bound_ms, bound_by = bound(work)
                say(f"[time] {name} B={batch}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.5f} ms ({bound_by}); "
                    f"{fused.plan(batch).plan.kernels} kernel(s) a call; {card}")
                if batch == 205:
                    out[name] = (ms, plain_ms, None, work)
            if batch in (1, 205):
                _, rows = profile_call(call)
                if not rows:
                    say(f"[profile] {name} B={batch}: device time not measured (the profiler "
                        f"caught no kernel in three windows), nor the host cost; {card}")
                    continue
                device_us = 1e3 * sum(r[0] for r in rows)
                by_kernel = ", ".join(f"{short_name(key)} {1e3 * ms:.2f} us x{n}"
                                      for ms, n, key in sorted(rows, reverse=True))
                line = (f"[profile] {name} B={batch}: {sum(r[1] for r in rows)} kernel(s) a "
                        f"call, device {device_us:.2f} us ({by_kernel})")
                if batch == 1:
                    call_us = 1e3 * time_call(call)
                    line += (f"; the call {call_us:.2f} us (CUDA events, median of 30), so the "
                             f"host costs {call_us - device_us:.2f} us a call")
                say(f"{line}; {card}")
    name = "dna2rna_fused_forward"
    params, state = jax_from_state_dict(
        port_model(DNA2RNAVAE, 5, False, dna=65_536).state_dict(), "dna2rna")
    fused = fv.FusedDNA2RNA(params, state, dev)
    g = torch.Generator(device=dev).manual_seed(305)
    x = torch.rand((205, 65_536), generator=g, device=dev)
    site = torch.randint(0, N_SITES, (205,), generator=g, device=dev)
    ms, plain_ms = alternate(lambda: fused(x, site, seed=7), lambda: fv.dna2rna_fused_reference(
        fused.folded, x, site, fv.NOISE_PHILOX, None, 7), reps=10, warmup=2)
    bound_ms, bound_by = bound(serving_work(name, 205, dna=65_536))
    _, rows = profile_call(lambda: fused(x, site, seed=7))
    device = (", ".join(f"{short_name(key)} {1e3 * t:.2f} us" for t, _, key in rows)
              or "not measured (the profiler caught no kernel)")
    say(f"[time] {name} at DNA 65536, B=205: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}); device {device}; {card}")
    del fused, x
    torch.cuda.empty_cache()
    return out


def time_fit(dev, card, n_samples, epochs, task="rna2dna"):
    """Wall time of ``engine.fit`` through the task's epoch kernel
    (validation and the host loop included) on the synthetic cohort of
    ``n_samples``, after a warm-up run; returns (ms per epoch, samples/s)."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=n_samples, seed=2)
    tr, va = train_val_indices(n_samples, CFG.train_test_split, CFG.random_seed)
    arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
    run = lambda n: engine.fit(task, CFG, arrays(tr), arrays(va), 0, N_SITES,  # noqa: E731
                               num_epochs=n, fused_epoch=True, device=dev)
    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(epochs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / res.epochs_ran
    rate = engine.samples_trained(len(tr), CFG.batch_size, 1) / ms * 1e3
    say(f"[time] engine.fit {task}, epoch kernel, {n_samples}-sample cohort "
        f"({len(tr) // CFG.batch_size} "
        f"steps, {len(va)} validation rows): {ms:.3f} ms per epoch over {res.epochs_ran} epochs, "
        f"{rate:,.0f} samples/s; its {graph_line(task)} (in the warm-up run); {card}")
    return ms, rate


def phase_timing(dev, card):
    """Returns {name: (ms, plain_ms, library_ms, bound work)}."""
    out = {}

    params, state = train_params(dev, 4)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    r = train_rows(dev, 32, 10)
    ms, plain_ms = alternate(
        lambda: ft.rna2dna_fused_train_step(params, state, r["x"], r["t"], r["site"], N_SITES,
                                            seed=1, step=0, beta=BETA),
        lambda: ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                                r["site"], r["eps"], r["drop"], BETA))
    out["rna2dna_train_step"] = (ms, plain_ms, None, step_work(32))
    say(f"[time] rna2dna_train_step B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")
    step_split("rna2dna_train_step", "rna2dna", (params, state, r), card)

    # one epoch of bench.py's cohort: 8000 samples, 6400 train rows, 200 steps
    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    tr, _ = train_val_indices(8000, CFG.train_test_split, CFG.random_seed)
    n_steps = len(tr) // 32
    rows = tr[: n_steps * 32]
    x, t, s = (torch.as_tensor(a[rows]).to(dev) for a in (tpm, beta, site))
    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    zt = ft.unflatten(zeros)
    ms, plain_ms = alternate(
        lambda: fe.rna2dna_fused_epoch(params, zt, zt, state, x, t, s, N_SITES, seed=2,
                                       beta=BETA, lr=LR, weight_decay=WD, n_batches=n_steps),
        lambda: fe.rna2dna_epoch_reference(flat, zeros, zeros, bn["mean"], bn["var"], x, t, s,
                                           None, None, seed=2, beta=BETA, lr=LR, weight_decay=WD,
                                           step0=0, n_batches=n_steps),
        reps=2, warmup=1)
    say(f"[time] rna2dna_train_epoch: the {n_steps}-step {graph_line('rna2dna')} (host clock, "
        f"once per key); {card}")
    profile_epoch(lambda: fe.rna2dna_fused_epoch(
        params, zt, zt, state, x, t, s, N_SITES, seed=2, beta=BETA, lr=LR, weight_decay=WD,
        n_batches=n_steps), f"rna2dna_train_epoch ({n_steps} steps)", card)
    leaves = [v.clone() for v in flat.values()]
    for p in leaves:
        p.grad = torch.randn_like(p) * 1e-3
    adamw = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD, fused=True)
    library_ms = time_call(adamw.step)
    out["rna2dna_train_epoch"] = (ms, plain_ms, library_ms, epoch_work(n_steps, 32))
    say(f"[time] rna2dna_train_epoch {n_steps} steps x 32 rows: kernel {ms:.4f} ms "
        f"({len(rows) / ms * 1e3:,.0f} samples/s), plain {plain_ms:.4f} ms; torch.optim.AdamW "
        f"(fused) step over the same 19 tensors {library_ms:.4f} ms (x{n_steps} per epoch); {card}")

    # the cohort's shapes (the kernels' JSON record), then the wide paths': a
    # training batch's forward and backward, the validation split's forward
    for batch, name, backward, width in ((205, "rna2dna_loss_forward", False, CFG.input_dim_b),
                                         (32, "rna2dna_loss_backward", True, CFG.input_dim_b),
                                         (103, "rna2dna_loss_forward", False, WIDE_D),
                                         (32, "rna2dna_loss_forward", False, WIDE_D),
                                         (32, "rna2dna_loss_backward", True, WIDE_D)):
        logits, tt, mu, lv = loss_inputs(dev, batch, width, scale=1.0)
        b = torch.tensor(BETA, device=dev)
        one = torch.tensor(1.0, device=dev)
        if backward:
            kernel = lambda: fl._backward(logits, tt, mu, lv, b, one)  # noqa: E731
            plain = lambda: fl.loss_backward_reference(logits, tt, mu, lv, b, one)  # noqa: E731

            def library():  # a yardstick the port never calls
                return (torch.sigmoid(logits).sub_(tt).mul_(one), b * mu * one,
                        -0.5 * b * (1.0 - torch.exp(lv)) * one)
        else:
            kernel = lambda: fl._forward(logits, tt, mu, lv, b)  # noqa: E731
            plain = lambda: fl.loss_forward_reference(logits, tt, mu, lv, b)  # noqa: E731

            def library():
                kld = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
                return F.binary_cross_entropy_with_logits(logits, tt, reduction="sum") + b * kld
        ms, plain_ms = alternate(kernel, plain)
        library_ms = time_call(library)
        work = loss_work(batch, backward, width)
        if width == CFG.input_dim_b:
            out[name] = (ms, plain_ms, library_ms, work)
        bound_ms, bound_by = bound(work)
        say(f"[time] {name} {batch}x{width}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library composite {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{100 * bound_ms / ms:.1f}% of it); {card}")
        del logits, tt
    torch.cuda.empty_cache()
    time_short_loss(dev, card)
    time_fit(dev, card, 1024, 10)
    time_fit(dev, card, 8000, 3)
    out.update(time_d2r(dev, card, t, x, s, n_steps))
    time_fit(dev, card, 1024, 10, "dna2rna")
    time_fit(dev, card, 8000, 3, "dna2rna")
    out.update(time_mm(dev, card, x, t, s, n_steps))
    time_fit(dev, card, 1024, 10, "multimodal")
    time_fit(dev, card, 8000, 3, "multimodal")
    return out


def time_short_loss(dev, card):
    """The loss pair at `LOSS_SHORT` rows x 1211, the valid prefixes a
    masked population's short batches hand it: kernel against plain (CUDA
    events), forward and backward."""
    parts = []
    for batch in LOSS_SHORT:
        logits, tt, mu, lv = loss_inputs(dev, batch, CFG.input_dim_b, scale=1.0)
        b, one = torch.tensor(BETA, device=dev), torch.tensor(1.0, device=dev)
        fwd = alternate(lambda: fl._forward(logits, tt, mu, lv, b),
                        lambda: fl.loss_forward_reference(logits, tt, mu, lv, b))
        bwd = alternate(lambda: fl._backward(logits, tt, mu, lv, b, one),
                        lambda: fl.loss_backward_reference(logits, tt, mu, lv, b, one))
        parts.append(f"{batch} rows forward {fwd[0]:.4f} ms (plain {fwd[1]:.4f}), backward "
                     f"{bwd[0]:.4f} ms (plain {bwd[1]:.4f})")
    say(f"[time] loss pair at short valid prefixes x {CFG.input_dim_b}: " + "; ".join(parts)
        + f"; {card}")


def time_d2r(dev, card, x, t, s, n_steps):
    """The DNA→RNA step at B = 32, one epoch of ``n_steps`` steps on the
    rows x (DNA), t (RNA), s (sites), profiled once, and fused AdamW over
    its 21 tensors; returns {name: (ms, plain_ms, library_ms, bound work)}."""
    out = {}
    params, state = d2r_params(dev, 14)
    flat, bn = ft.flatten_params(params, D2R), ft.bn_d2r(state)
    r = d2r_rows(dev, 32, 20)
    ms, plain_ms = alternate(
        lambda: ft.dna2rna_fused_train_step(params, state, r["t"], r["x"], r["site"], N_SITES,
                                            seed=1, step=0, beta=BETA),
        lambda: ft.dna2rna_train_step_reference(flat, bn, r["x"], r["t"], r["site"], r["eps"],
                                                r["drop1"], r["drop2"], BETA))
    out["dna2rna_train_step"] = (ms, plain_ms, None, step_work_d2r(32))
    say(f"[time] dna2rna_train_step B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")
    step_split("dna2rna_train_step", "dna2rna", (params, state, r), card)

    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    zt = ft.unflatten(zeros, D2R)
    kernel = lambda: fe.dna2rna_fused_epoch(  # noqa: E731
        params, zt, zt, state, x, t, s, N_SITES, seed=2, beta=BETA, lr=LR, weight_decay=WD,
        n_batches=n_steps)
    ms, plain_ms = alternate(
        kernel,
        lambda: fe.dna2rna_epoch_reference(flat, zeros, zeros, bn, x, t, s, None, None, None,
                                           seed=2, beta=BETA, lr=LR, weight_decay=WD, step0=0,
                                           n_batches=n_steps),
        reps=2, warmup=1)
    say(f"[time] dna2rna_train_epoch: the {n_steps}-step {graph_line('dna2rna')} (host clock, "
        f"once per key); {card}")
    profile_epoch(kernel, f"dna2rna_train_epoch ({n_steps} steps)", card)
    leaves = [v.clone() for v in flat.values()]
    for p in leaves:
        p.grad = torch.randn_like(p) * 1e-3
    adamw = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD, fused=True)
    library_ms = time_call(adamw.step)
    out["dna2rna_train_epoch"] = (ms, plain_ms, library_ms, epoch_work_d2r(n_steps, 32))
    say(f"[time] dna2rna_train_epoch {n_steps} steps x 32 rows: kernel {ms:.4f} ms "
        f"({x.shape[0] / ms * 1e3:,.0f} samples/s), plain {plain_ms:.4f} ms; torch.optim.AdamW "
        f"(fused) step over the same 21 tensors {library_ms:.4f} ms (x{n_steps} per epoch); {card}")
    return out


def time_mm(dev, card, a, b, s, n_steps):
    """The tri-modal step at B = 32, one epoch of ``n_steps`` steps on the
    RNA rows a, DNA rows b and sites s (balanced class weights), profiled
    once, and fused AdamW over its 39 tensors; returns {name: (ms, plain_ms,
    library_ms, bound work)}."""
    out = {}
    params, state = mm_params(dev, 24)
    flat, bn = ft.flatten_params(params, MM), ft.bn_mm(state)
    r = mm_rows(dev, 32, 30)
    ms, plain_ms = alternate(
        lambda: ft.multimodal_fused_train_step(params, state, r["a"], r["b"], r["site"], N_SITES,
                                               seed=1, step=0, beta=BETA, gamma=GAMMA,
                                               class_weights=r["cw"]),
        lambda: ft.multimodal_train_step_reference(flat, bn, r["a"], r["b"], r["site"], r["cw"],
                                                   *(r[k] for k in MM_NOISE), BETA, GAMMA))
    out["multimodal_train_step"] = (ms, plain_ms, None, step_work_mm(32))
    say(f"[time] multimodal_train_step B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")
    step_split("multimodal_train_step", "multimodal", (params, state, r), card)

    cw = torch.as_tensor(compute_class_weights(s.cpu().numpy(), N_SITES)).to(dev)
    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    zt = ft.unflatten(zeros, MM)
    kernel = lambda: fe.multimodal_fused_epoch(  # noqa: E731
        params, zt, zt, state, a, b, s, N_SITES, seed=2, beta=BETA, gamma=GAMMA,
        class_weights=cw, lr=LR, weight_decay=WD, n_batches=n_steps)
    ms, plain_ms = alternate(
        kernel,
        lambda: fe.multimodal_epoch_reference(flat, zeros, zeros, bn, a, b, s, cw, (None,) * 4,
                                              seed=2, beta=BETA, gamma=GAMMA, lr=LR,
                                              weight_decay=WD, step0=0, n_batches=n_steps),
        reps=2, warmup=1)
    say(f"[time] multimodal_train_epoch: the {n_steps}-step {graph_line('multimodal')} (host "
        f"clock, once per key: engine.fit pays it in its first epoch); {card}")
    profile_epoch(kernel, f"multimodal_train_epoch ({n_steps} steps)", card)
    leaves = [v.clone() for v in flat.values()]
    for p in leaves:
        p.grad = torch.randn_like(p) * 1e-3
    adamw = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD, fused=True)
    library_ms = time_call(adamw.step)
    out["multimodal_train_epoch"] = (ms, plain_ms, library_ms, epoch_work_mm(n_steps, 32))
    say(f"[time] multimodal_train_epoch {n_steps} steps x 32 rows: kernel {ms:.4f} ms "
        f"({a.shape[0] / ms * 1e3:,.0f} samples/s), plain {plain_ms:.4f} ms; torch.optim.AdamW "
        f"(fused) step over the same 39 tensors {library_ms:.4f} ms (x{n_steps} per epoch); {card}")
    return out


def time_wide(dev, card):
    """The wide head at batch 32 and 256 against its plain version and the
    library composite, profiled once at each; returns {name: (ms, plain_ms,
    library_ms, bound work)} at batch 32, the training batch."""
    out = {}
    for batch in WIDE_BATCHES:
        h, t, w, b, mw, vw, mb, vb, step = wide_inputs(dev, batch, 100 + batch)
        kernel = lambda: fw.fused_wide_output_step(  # noqa: E731
            h, t, w, b, mw, vw, mb, vb, step, WIDE_LR, WIDE_WD)
        ms, plain_ms = alternate(
            kernel, lambda: fw.fused_wide_output_step_reference(
                h, t, w, b, mw, vw, mb, vb, step, WIDE_LR, WIDE_WD), reps=5, warmup=2)
        lw, lb = w.clone(), b.clone()
        lw.grad, lb.grad = torch.empty_like(lw), torch.empty_like(lb)
        adamw = torch.optim.AdamW([lw, lb], lr=WIDE_LR, weight_decay=WIDE_WD, fused=True)

        def library():
            logits = torch.addmm(lb, h, lw)
            loss = F.binary_cross_entropy_with_logits(logits, t, reduction="sum")
            dy = torch.sigmoid(logits) - t
            torch.mm(h.t(), dy, out=lw.grad)
            torch.sum(dy, 0, out=lb.grad)
            dh = dy @ lw.t()
            adamw.step()
            return loss, dh

        library_ms = time_call(library, reps=5, warmup=2)
        profile_epoch(kernel, f"fused_wide_output_step B={batch}", card)
        work = wide_work(batch)
        bound_ms, bound_by = bound(work)
        say(f"[time] fused_wide_output_step {WIDE_K}x{WIDE_D} B={batch}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library (cuBLAS + fused AdamW) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); {card}")
        if batch == WIDE_BATCHES[0]:
            out["fused_wide_output_step"] = (ms, plain_ms, library_ms, work)
        del h, t, w, b, mw, vw, mb, vb, lw, lb, adamw
        torch.cuda.empty_cache()
    return out


def distance_ops(m, n, d, metric):
    """Operations of one (m, n) distance matrix over d features: 2mnd for
    the product, 3mnd for L1 (a difference, an absolute value, a sum)."""
    return (3 if metric == "manhattan" else 2) * m * n * d


def time_knn(dev, card):
    """CUDA-event ms, on the 8000-sample cohort (RNA→DNA: 6400 training rows,
    1600 queries): the grid pass of each metric (`knn_grid_mse`, its 8
    combinations), a predict of the 1600 queries (k = 5) for each metric,
    the Gram PCA of the 1600 rows, and a t-SNE of them (1000 steps) with its
    affinity stage alone."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    x, y, q, yq, _, _ = (torch.as_tensor(a, device=dev)
                         for a in knn_directions(tpm, beta, site)["rna2dna"])
    shape = f"{len(x)} x {len(q)} x {x.shape[1]} (targets {y.shape[1]})"
    for metric in KNN_METRICS:
        ops = distance_ops(len(q), len(x), x.shape[1], metric)
        ms = time_call(lambda: knn.knn_grid_mse(x, y, q, yq, KNN_KS, KNN_MODES, metric=metric,
                                                device=dev), reps=3, warmup=1)
        say(f"[time] knn_grid_mse {metric} RNA→DNA {shape}, 8 combinations: {ms:.3f} ms "
            f"(its distance matrix {ops:.4g} operations: {ops / ms / 1e9:.3f} TFLOP/s if it "
            f"were all of it); {card}")
        model = knn.KNNRegressor(5, metric=metric, device=dev).fit(x, y)
        ms = time_call(lambda: model.predict(q), reps=3, warmup=1)
        say(f"[time] KNNRegressor(5, {metric}).predict of {len(q)} queries over {len(x)} rows: "
            f"{ms:.3f} ms; {card}")
    ms = time_call(lambda: pca.PCA(2, device=dev).fit_transform(q), reps=3, warmup=1)
    say(f"[time] PCA (Gram, eigh) of {len(q)} x {q.shape[1]}: {ms:.3f} ms; {card}")
    p_ms = time_call(lambda: tsne._joint_probabilities(tsne._sq_distances(q), 30.0), reps=3,
                     warmup=1)
    model = tsne.TSNE(n_components=2, random_state=42, perplexity=30.0, device=dev)
    ms = time_call(lambda: model.fit_transform(q), reps=1, warmup=1)
    say(f"[time] TSNE of {len(q)} x {q.shape[1]}, 1000 steps: {ms:.3f} ms (the affinities "
        f"{p_ms:.3f} ms; KL {model.kl_divergence_:.4f}); {card}")


def phase_knn_wide(dev, card):
    """The kNN grids at the whole-methylome width: the 1024-sample cohort at
    DNA 450,000 (819 training rows, 205 queries), both directions, both
    metrics, base and conditioned (`knn_grid_mse`, each one call timed by
    CUDA events): finite MSEs; the neighbour sets of 16 queries equal to a
    float64 recomputation on the card; the peak device memory."""
    t0 = time.perf_counter()
    tpm, beta, site = generate_synthetic_arrays(n_samples=1024, dim_b=WIDE_D, seed=0)
    say(f"[knn-wide] synthetic cohort 1024 x (1177 + {WIDE_D}) made in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for direction, arrays in knn_directions(tpm, beta, site).items():
        x, y, q, yq, s_tr, s_q = (torch.as_tensor(a, device=dev) for a in arrays)
        X = torch.cat([x, s_tr[:, None].float()], 1)
        Q = torch.cat([q, s_q[:, None].float()], 1)
        shape = f"{len(x)} x {len(q)} x {x.shape[1]} (targets {y.shape[1]})"
        for metric in KNN_METRICS:
            for conditioned, (xx, qq) in ((False, (x, q)), (True, (X, Q))):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                mses = knn.knn_grid_mse(xx, y, qq, yq, KNN_KS, KNN_MODES, conditioned=conditioned,
                                        metric=metric, device=dev)
                end.record()
                end.synchronize()
                if len(mses) != 8 or not all(math.isfinite(v) for v in mses.values()):
                    raise AssertionError(f"wide {direction} {metric}: MSEs {mses}")
                best = min(mses, key=mses.get)
                say(f"[knn-wide] knn_grid_mse {metric} {direction} {shape}"
                    f"{', conditioned' if conditioned else ''}: {start.elapsed_time(end):.3f} ms "
                    f"(one call); best {best} MSE {mses[best]:.6f}; {card}")
            _, _, idx = knn._neighbours(x, q[:16], max(KNN_KS), metric)
            d64 = torch.cdist(q[:16].double(), x.double(), p=1.0 if metric == "manhattan" else 2.0,
                              compute_mode="donot_use_mm_for_euclid_dist")
            ties = neighbour_ties(f"wide {direction} {metric}", idx.cpu().numpy(),
                                  d64.cpu().numpy())
            say(f"[knn-wide] {direction} {metric}: 16 queries' neighbour sets equal to float64 "
                f"on the card ({int(ties.sum())} with a tie at fp32 resolution)")
        del x, y, q, yq, X, Q
        torch.cuda.empty_cache()
    say(f"[knn-wide] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
        f"{card}")


# --- multi-device: data- and tensor-parallel training, sharded serving ----------

MD_TRAIN, MD_EPOCHS, MD_SERVE_ROWS = 819, 2, 600  # live-width DP fit rows, its epochs, served rows
MD_LR = 1e-3  # Config's learning rate: the DP fit's AdamW rate
MD_PRE_BN = ("encoder_rna/fc/b", "encoder_dna/fc1/b", "encoder_dna/fc2/b")  # feed BatchNorm


def _md_cohort():
    tpm, beta, site = generate_synthetic_arrays(n_samples=1024, seed=0)
    return (tpm[:MD_TRAIN], beta[:MD_TRAIN], site[:MD_TRAIN]), \
        (tpm[MD_TRAIN:], beta[MD_TRAIN:], site[MD_TRAIN:])


def _md_first_grads(dev, mesh):
    """(loss, gradients) of the live-width RNA→DNA fit's first step: epoch 0's
    shuffle and noise, its first batch of 32 (this rank's rows of it)."""
    from vae_los_angeles_torch.parallel import sharding

    task = get_task("rna2dna")
    (tr, _) = _md_cohort()
    params, state = task.init(torch.Generator().manual_seed(0), CFG, N_SITES, dev)
    train = engine._as_batch(tr, dev)
    gen, perm = engine.epoch_noise(0, 0, len(train), dev)
    idx = perm[:CFG.batch_size]
    lo, hi = mesh.row_range(len(idx))
    loss, grads, _ = sharding.sharded_loss_and_grads(task, params, state, train.take(idx[lo:hi]),
                                                     BETA, gen, mesh, len(idx), split=False)
    return float(loss), {n: t.cpu().numpy() for n, t in engine._named_leaves(grads)}


def _md_fit(dev, mesh):
    (tr, va) = _md_cohort()
    res = engine.fit("rna2dna", CFG, tr, va, 0, N_SITES, num_epochs=MD_EPOCHS, mesh=mesh,
                     device=dev)
    return res.val_losses, res.params["encoder_rna"]["fc"]["b"].cpu().numpy()


def _md_serve(dev, workdir):
    """The two directional loaders under USE_PALLAS on MD_SERVE_ROWS rows:
    (outputs, launches of each serving kernel)."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=MD_SERVE_ROWS, seed=1)
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"), use_pallas=True)
    out, launches = {}, {}
    for name, loader, kw in (("rna2dna", load_rna2dna, {"rna": tpm}),
                             ("dna2rna", load_dna2rna, {"dna": beta})):
        model = loader(cfg=cfg, root=workdir, device=dev)
        cls = KERNELS[f"{name}_fused_forward"][0]
        cls.launches = 0
        out[name] = model(site=site, generator=torch.Generator().manual_seed(3), **kw)
        launches[f"{name}_fused_forward"] = cls.launches
    return out, launches


def _md_tp(dev, task_name, mesh):
    """One step of ``task_name`` at DNA 450,000 unsplit and tensor-parallel
    over ``mesh`` from the same weights, batch and generator: (loss error,
    largest gradient error over the tensor's largest |g|, largest parameter
    error outside the pre-BN biases and the entries whose gradient is within
    1e-5 of the tensor's largest |g| of 0, the TP step's ms, the 57.6 MB
    all-reduce's ms)."""
    from vae_los_angeles_torch.parallel import comm, sharding

    cfg = CFG.replace(input_dim_b=WIDE_D)
    task = get_task(task_name)
    params, state = task.init(torch.Generator().manual_seed(0), cfg, N_SITES, dev)
    g = torch.Generator().manual_seed(5)
    batch = (torch.rand(32, CFG.input_dim_a, generator=g).to(dev),
             torch.rand(32, WIDE_D, generator=g).to(dev),
             torch.randint(0, N_SITES, (32,), generator=g).to(dev))
    whole = sharding.Mesh(1, 1)
    loss1, grads1, _ = sharding.sharded_loss_and_grads(
        task, params, state, Batch(*batch), BETA, torch.Generator(dev).manual_seed(9), whole, 32)
    p1, _ = optim.adamw_update(params, grads1, optim.adamw_init(params), WIDE_LR, WIDE_WD)
    local = sharding.shard_params(params, mesh)
    sb = sharding.shard_arrays(batch, mesh, dev)
    loss2, grads2, _ = sharding.sharded_loss_and_grads(
        task, local, state, sb.rows(), BETA, torch.Generator(dev).manual_seed(9), mesh, sb.n)
    p2, _ = optim.adamw_update(local, grads2, optim.adamw_init(local), WIDE_LR, WIDE_WD)
    specs = sharding.param_specs(params)
    cut = lambda tree: tree_map(lambda t, s: sharding._cut(t, s, mesh), tree, specs)  # noqa: E731
    top = max(float(t.abs().max()) for t in tree_leaves(grads1))
    grad_err = param_err = 0.0
    for (name, a), (_, b), (_, p_new), (_, p_want) in zip(
            engine._named_leaves(grads2), engine._named_leaves(cut(grads1)),
            engine._named_leaves(p2), engine._named_leaves(cut(p1))):
        # a pre-BN bias's true gradient is 0: its error is held against the largest of all
        scale = top if name in MD_PRE_BN else float(b.abs().max()) or 1.0
        grad_err = max(grad_err, float((a - b).abs().max()) / scale)
        # an entry within the gradient tolerance of 0 may take either sign, and Adam's
        # first step is then ±lr; a pre-BN bias moves up to lr either way (ROADMAP C)
        big = b.abs() > 1e-5 * float(b.abs().max())
        if name not in MD_PRE_BN and bool(big.any()):
            param_err = max(param_err, float((p_new - p_want)[big].abs().max()))
    del params, grads1, p1, grads2, p2
    step = sharding.sharded_train_step(task_name)
    opt = optim.adamw_init(local)
    gen = torch.Generator(dev).manual_seed(9)
    for _ in range(2):  # a warm-up, then the timed step
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        local, state, opt, _ = step(local, state, opt, sb, gen, WIDE_LR, WIDE_WD, BETA)
        torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    partial = torch.zeros(32, WIDE_D, device=dev)
    comm.all_reduce(partial, mesh.group("model"))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    comm.all_reduce(partial, mesh.group("model"))
    torch.cuda.synchronize(dev)
    ar_ms = (time.perf_counter() - t0) * 1e3
    return abs(float(loss2) - float(loss1)) / abs(float(loss1)), grad_err, param_err, step_ms, \
        ar_ms


def _md_gloo_rank(workdir):
    """A rank of the two gloo ranks that share card 0 (`phase_multidevice` a)."""
    from vae_los_angeles_torch.parallel import comm, dryrun, sharding

    dev = comm.device()
    out, times = {}, {}
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.run()
    times["dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = vmap_meta.population_mesh()
    out["grads"] = _md_first_grads(dev, mesh)
    out["fit"] = _md_fit(dev, mesh)
    times["dp_fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = _md_serve(dev, workdir)
    times["sharded_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_mesh = sharding.make_mesh(2, model_parallel=2)
    out["tp"] = {task: _md_tp(dev, task, tp_mesh) for task in ("rna2dna", "dna2rna")}
    times["tp_450k"] = time.perf_counter() - t0
    out["times"] = times
    out["routes"] = comm.routes()
    return out


def _md_nccl_one():
    """One NCCL rank: ``make_mesh(1)`` and the 1 x 1 sharded step against the
    plain step (the same bits), and one NCCL all-reduce on the card."""
    from vae_los_angeles_torch.parallel import comm, sharding

    dev = comm.device()
    mesh = sharding.make_mesh(1)
    task = get_task("rna2dna")
    params, state = task.init(torch.Generator().manual_seed(0), CFG, N_SITES, dev)
    tpm, beta, site = generate_synthetic_arrays(n_samples=64, seed=2)
    step = sharding.sharded_train_step("rna2dna")
    outs = []
    for batch in (sharding.shard_arrays((tpm, beta, site), mesh, dev), (tpm, beta, site)):
        p, _, _, loss = step(params, state, optim.adamw_init(params), batch,
                             torch.Generator(dev).manual_seed(9), LR, WD, BETA)
        outs.append((float(loss), torch.cat([t.reshape(-1) for t in tree_leaves(p)])))
    x = torch.ones(4, device=dev)
    torch.distributed.all_reduce(x)
    return {"mesh": dict(mesh.shape), "equal": outs[0][0] == outs[1][0]
            and bool(torch.equal(outs[0][1], outs[1][1])), "all_reduce": x.tolist(),
            "routes": comm.routes()}


def phase_multidevice(dev, card):
    """(a) two gloo ranks on card 0 (``cuda:0`` each): the dry run, the
    data-parallel RNA→DNA fit at the live widths against this process's
    single-device fit (first-step gradients within 1e-5 of each tensor's
    largest |g|, validation losses within 1e-3 relative, the pre-BN encoder
    bias within 2·lr·steps), the sharded serve through B0a/B0b under
    USE_PALLAS against the single call (TOL), and the tensor-parallel step at
    DNA 450,000 (RNA→DNA's row-split DecoderB output layer, DNA→RNA's
    column-split EncoderB input layer) against the unsplit step (loss rtol
    1e-5, gradients 1e-5 of each tensor's largest |g|, a pre-BN bias's of the
    largest of all, parameters 1e-5 outside the pre-BN biases and the entries
    whose gradient lies within that tolerance of 0, which may take either
    sign, so that Adam's first step, ±lr, flips); (b) one NCCL rank;
    (c) NCCL over every card when there are two or more. Prints each leg's
    wall time and the collectives' routes."""
    from vae_los_angeles_torch.parallel import comm, dryrun, sharding

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_md_") as workdir:
        cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"), use_pallas=True)
        for name in ("rna2dna", "dna2rna"):
            p, s_ = get_task(name).init(torch.Generator().manual_seed(7), CFG, N_SITES, "cpu")
            checkpoint.save_best(name, "md", p, s_, cfg.checkpoint_dir)
            checkpoint.write_run_id(name, "md", workdir)
        t0 = time.perf_counter()
        single = {"grads": _md_first_grads(dev, sharding.Mesh(1, 1)),
                  "fit": _md_fit(dev, None), "serve": _md_serve(dev, workdir)}
        say(f"[multidevice] single-device references: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        ranks = comm.spawn(_md_gloo_rank, 2, "gloo", "cuda:0", args=(workdir,), threads=4)
        wall_a = time.perf_counter() - t0
    say(f"[multidevice] (a) 2 gloo ranks on cuda:0: {wall_a:.2f} s with the spawn; routes "
        f"{ranks[0]['routes']}; legs (rank 0) "
        + ", ".join(f"{k} {v:.2f} s" for k, v in ranks[0]["times"].items()) + f"; {card}")
    say(f"[multidevice] dry run: {ranks[0]['dryrun']}")
    loss_w, grads_w = single["grads"]
    top = max(float(np.abs(g).max()) for g in grads_w.values())
    hazard = 2 * MD_LR * MD_EPOCHS * (MD_TRAIN // CFG.batch_size)
    for r, res in enumerate(ranks):
        loss, grads = res["grads"]
        if abs(loss - loss_w) > 1e-5 * abs(loss_w):
            raise AssertionError(f"rank {r}: DP first-step loss {loss} against {loss_w}")
        for name, g in grads.items():
            scale = top if name in MD_PRE_BN else float(np.abs(grads_w[name]).max())
            err = float(np.abs(g - grads_w[name]).max())
            if err > 1e-5 * scale:
                raise AssertionError(f"rank {r}: DP first-step gradient {name} off by {err:.3g} "
                                     f"(scale {scale:.3g})")
        val, bias = res["fit"]
        if not np.allclose(val, single["fit"][0], rtol=1e-3, atol=0):
            raise AssertionError(f"rank {r}: DP validation losses {val} against "
                                 f"{single['fit'][0]}")
        drift = float(np.abs(bias - single["fit"][1]).max())
        if drift > hazard:
            raise AssertionError(f"rank {r}: the pre-BN bias moved {drift:.3g} > {hazard:.3g}")
        served, launches = res["serve"]
        for name in ("rna2dna", "dna2rna"):
            for got, ref, what in zip(served[name], single["serve"][0][name],
                                      ("recon", "mu", "logvar")):
                if not np.allclose(got, ref, **TOL):
                    raise AssertionError(f"rank {r}: sharded {name} {what} off by "
                                         f"{np.abs(got - ref).max():.3g}")
        if min(launches.values()) < 1:
            raise AssertionError(f"rank {r}: the sharded serve launched {launches}")
        for task, (loss_err, grad_err, param_err, step_ms, ar_ms) in res["tp"].items():
            if loss_err > 1e-5 or grad_err > 1e-5 or param_err > 1e-5:
                raise AssertionError(f"rank {r}: TP {task} at 450,000: loss {loss_err:.3g}, "
                                     f"grads {grad_err:.3g}, params {param_err:.3g}")
    say(f"[multidevice] DP fit at the live widths: val losses {ranks[0]['fit'][0]} against "
        f"{single['fit'][0]}; sharded serve launches (a rank) {ranks[0]['serve'][1]}")
    for task, (loss_err, grad_err, param_err, step_ms, ar_ms) in ranks[0]["tp"].items():
        say(f"[multidevice] TP {task} at DNA 450,000 over 2 ranks: loss err {loss_err:.2e}, "
            f"grad err {grad_err:.2e}, param err {param_err:.2e}; step {step_ms:.1f} ms, "
            f"all-reduce of (32, 450,000) fp32 {ar_ms:.1f} ms (gloo, one card); {card}")

    t0 = time.perf_counter()
    one = comm.spawn(_md_nccl_one, 1, "nccl", None)[0]
    say(f"[multidevice] (b) 1 NCCL rank: {time.perf_counter() - t0:.2f} s; mesh {one['mesh']}, "
        f"1 x 1 step equal to the plain step: {one['equal']}; routes {one['routes']}")
    if not one["equal"] or one["all_reduce"] != [1.0] * 4:
        raise AssertionError(f"the one-rank NCCL leg failed: {one}")
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        res = comm.spawn(dryrun.run, n, "nccl", None)
        say(f"[multidevice] (c) NCCL over {n} cards: {time.perf_counter() - t0:.2f} s; {res[0]}")
    else:
        say("[multidevice] (c) NCCL across cards: skipped, one card visible")
    say(f"[multidevice] phase: {time.perf_counter() - t_phase:.2f} s; {card}")


def main():
    t_start = time.perf_counter()
    dev = device_policy.require_cuda()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off (vae_los_angeles_torch.device)")
    card = card_line()
    say(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all(SOURCES)
    say(f"[build] {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}")
    for name, b in built.items():
        say(f"[build] {b.path.name}: {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                say(f"[build]   {line.strip()}")

    errs = compare_serving(dev)
    errs["rna2dna_train_step"] = compare_train_step(dev)
    errs["rna2dna_train_epoch"] = compare_epoch(dev)
    errs.update(compare_loss(dev))
    check_philox(dev)
    errs["dna2rna_train_step"] = compare_d2r_step(dev)
    errs["dna2rna_train_epoch"] = compare_d2r_epoch(dev)
    check_philox_d2r(dev)
    compare_wide_epochs(dev)
    errs["multimodal_train_step"] = compare_mm_step(dev)
    errs["multimodal_train_epoch"] = compare_mm_epoch(dev)
    check_philox_mm(dev)
    for task, err in compare_step_graphs(dev).items():
        errs[f"{task}_train_step"] = max(errs[f"{task}_train_step"], err)
    errs["fused_wide_output_step"] = compare_wide(dev)
    # timed here, before any other profiler session in the process
    serving_timings = time_serving(dev, card)
    loss_kernels_a_call(dev, card)

    tpm, beta, site = generate_synthetic_arrays(n_samples=1024, seed=0)
    # the phases count each run's launches: no steady-state re-run of the
    # training CLI's, except where phase_cli asks for one
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir, env_set(WALL_DETAIL="0"):
        cwd = os.getcwd()
        os.chdir(workdir)  # the run-id protocol writes into the working directory
        try:
            counts, run_id = phase_train(dev, workdir, tpm, beta, site)
            counts_d2r, run_id_d2r = phase_train(dev, workdir, tpm, beta, site, "dna2rna")
            counts.update(counts_d2r)
            counts["serve"] = phase_serve(dev, workdir, tpm, beta, site,
                                          {"rna2dna": run_id, "dna2rna": run_id_d2r})
            counts.update(phase_clustering(dev, workdir, card))
            compare_knn(dev, tpm, beta, site)
            compare_tsne(dev, knn_directions(tpm, beta, site)["rna2dna"][2])
            counts["knn_comparison"] = phase_knn_comparison(dev, workdir, tpm, beta, site)
            counts_mm, run_id_mm = phase_train(dev, workdir, tpm, beta, site, "multimodal")
            counts.update(counts_mm)
            counts["evaluate"] = phase_evaluate(dev, workdir, tpm, beta, site, run_id_mm)
            counts.update(phase_downstream(dev, workdir, tpm, beta, site, card))
            counts.update(phase_autoencoders(dev, workdir, tpm, beta, site, card))
            counts["cv"] = phase_cross_modality_cv(dev, tpm, beta, site, card)
            counts["masked_cv"] = phase_masked_populations(dev, tpm, beta, site, card)
            counts.update(phase_hpo(dev, workdir, tpm, beta, site, card))
            counts.update(phase_train_wide(dev, workdir, card))
            counts.update(phase_cli(dev, workdir, card))
        finally:
            os.chdir(cwd)
    timings = phase_timing(dev, card)
    timings.update(serving_timings)
    timings.update(time_wide(dev, card))
    time_knn(dev, card)
    phase_knn_wide(dev, card)
    phase_multidevice(dev, card)

    path_of = {"rna2dna_fused_forward": "serve", "dna2rna_fused_forward": "serve",
               "rna2dna_train_epoch": "train", "rna2dna_loss_forward": "train",
               "rna2dna_train_step": "train_step", "rna2dna_loss_backward": "train_plain",
               "dna2rna_train_epoch": "train_d2r", "dna2rna_train_step": "train_step_d2r",
               "multimodal_train_epoch": "train_mm", "multimodal_train_step": "train_step_mm",
               "fused_wide_output_step": "wide"}
    sources = {name: "vae_los_angeles_torch/csrc/fused_vae.cu" for name in KERNELS}
    replaces = {name: spec[4] for name, spec in KERNELS.items()}
    for name, (src, rep, _) in TRAIN_KERNELS.items():
        sources[name], replaces[name] = src, rep
    kernels = []
    for name, path in path_of.items():
        launches = counts[path][name]
        if launches < 1:
            raise AssertionError(f"the {path} path never launched {name}")
        ms, plain_ms, library_ms, work = timings[name]
        bound_ms, bound_by = bound(work)
        say(f"[bound] {name}: {ms:.4f} ms against a bound of {bound_ms:.5f} ms "
            f"({bound_by}; {work[0]:.4g} operations, {work[1]:.4g} bytes); {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": launches, "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
