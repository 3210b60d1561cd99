#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (s2p_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which must pass (the script stops at the first failure):

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every CUDA kernel of the port from ``s2p_tpu_torch/csrc``.
3. kernels vs plain: each kernel's wrapper against its plain PyTorch
   version on the card, at every shape the 64px/ngf=64 main path gives it
   (batch 256, bf16 and f32, γ/β as strided halves of one γ‖β tensor as the
   fast path passes them, and contiguous as the module path does), the
   100px chain's odd shapes, the scalar path (channel counts off the 32
   grid, which must not take 16-byte loads, at shapes that run it resident
   and streaming, each whole and split over a cluster), the streaming path
   at 256² × 64 (batch 2, which must stream) and a |mean| ≫ std input
   (split over a cluster both resident and streaming at 32²); every case
   without and with the γ‖β conv's bias folded into the kernel
   (``gb_bias``), each launch with the bias counted in ``bias_launches``.
   Prints each shape's launch plan (path, cluster
   size k, channel tile, vector or scalar) and times kernel (also with the
   bias folded), plain version
   and the ``F.instance_norm`` yardstick per shape beside the bound, PR 2's
   kernel time and the wrapper's host time per call.
4. slice parity: a full-width cheetah generator (64px, ngf=64, state dim
   17, seeded random weights) runs ``generate_rollout_fast`` and
   ``generate_rollout`` (seq_len 5, batch 4, f32, TF32 off) on the card and
   on the CPU (plain norm); the frames must agree to 5e-3, and the kernel
   must have launched 13 times per step, every launch of the fast path with
   the γ‖β bias folded and none of the module path's.
5. serving throughput (a main path): the same generator in bf16 runs
   ``generate_rollout_fast`` at batch 256 × seq_len 8; prints frames/sec and
   checks the frames are finite. Every launch count is reset to 0 just
   before this phase and read just after it (no backward launch).
6. backward kernel vs plain: ``fused_mat_norm_bwd`` against
   ``fused_mat_norm_bwd_plain`` at every norm shape of the 100px/ngf=64
   training step (batch 16, bf16 and f32, γ separate and as a strided
   half of one γ‖β tensor), the scalar and the streaming paths; the whole
   ``FusedMATNorm`` against autograd of ``fused_mat_norm_plain``. Times
   kernel, plain version and the autograd backward of ``F.instance_norm``
   (a partial yardstick) per shape beside the bound and PR 2's time, with
   the launch plan; the forward kernel is timed at the same shapes.
7. training parity: one ``GANTrainer.train_step`` of the full-width
   training configuration (100px, ngf=64, ndf=64, 2 scales × 4 layers, VGG
   loss, R1 on at step 0, state dim 17) at batch 2 in f32 with TF32 off,
   on the card and on the CPU (plain forward and backward; in f32 and, as
   the reference, in f64) from the same seeded weights and uint8 batch:
   the card's metrics and G and D gradients must be as close to the f64
   step's as the CPU's f32 ones are (within 3×), every G parameter must
   get a non-zero gradient, and the step
   must launch the forward kernel 26 times and the backward 13 times. D's
   learning rate is 0 in this step: Adam's first step is ≈ lr·sign(g), so
   float noise in a D gradient near zero would move that weight by ±lr
   and the G gradients, taken against the updated D, would inherit it.
8. training throughput (a main path): the protocol configuration at batch
   16 in bf16 and in f32 (TF32 convs, PyTorch's default): 32 timed
   ``train_step``s (R1 fires at D steps 0 and 16) and one ``train_many``
   chunk; prints steps/sec and images/sec and checks the losses are
   finite. The launch counts are reset to 0 just before the bf16 window
   and read just after it.

Phase 3 also holds the forward kernel against its plain version at the
image bridge's shapes (the 100px chain at batch 256, bf16 and f32, γ and β
contiguous as the module path passes them) and times it there. Phases 3
and 6 also hold both kernels at the batches of phase 20's paths, whose
launch plans differ from phase 8's: the 100px chain at 8 a rank (bf16 and
f32) and at 2 a rank (f32, 20b's f32 step), and the forward at the serving
shapes at batch 4 (20c, f32); and at phase 25's ranks' shapes: the dry
run's GAN generator (32px, ngf 8, three up-blocks) at its 2 rows a rank,
f32, forward and backward, and its TP generator (32px, ngf 32) at each
TP world's batch of 2·world, f32, forward.

9. world model, card vs CPU: the full-width cheetah ensemble (obs 17, act
   6, E 7, hidden 256 × 3, the rollout CLI's defaults; seeded weights) in
   f32 with TF32 off runs ``generate_augmented_dataset`` and
   ``generate_multistep_dataset`` on 4,096 seeded rows on both: actions,
   window indices and every input column bit-equal, next obs, rewards and
   both uncertainties within 1e-5 of the CPU's largest value; one Adam NLL
   step's loss and gradients within 1e-5 (of the largest gradient).
10. image bridge, card vs CPU: the full-width 100px generator (ngf 64,
    state dim 17, seeded) runs ``generate_images_for_dataset`` on 8 rows in
    f32 with TF32 off: uint8 frames within 1 step, at most 1% of the values
    differ, 13 forward launches for the batch.
11. the augmentation pipeline (a main path): a seeded state-only cheetah
    dataset of 500 episodes × 1,000 steps; a fresh ensemble trained for the
    CLI's 2,000 steps (``train_ensemble``); ``generate_augmented_dataset``
    over all 500k rows; ``generate_images_for_dataset`` at batch 256 in
    bf16 on the first 16,384 rows with seeded 100px frames (500k frames
    would be 15 GB on the host). Prints ensemble steps/sec, augmented
    transitions/sec and generated frames/sec; checks uint8 frames, finite
    outputs, a falling NLL and 64 × 13 forward launches (counts reset to
    0 just before the phase and read just after it).
12. ``gb_int8``: the int8 γ‖β weights and conv on the card against the
    CPU (the serving shape, and 16 and 49 rows at batch 1), then the
    serving generator of phase 5 (bf16) runs
    ``generate_rollout_fast(gb_int8=True)`` at batch 256 × seq_len 8: PSNR
    ≥ 38 dB against the float fast path on the same card (the JAX test's
    bar), 13 launches per step (counts reset around the timed window);
    prints its frames/sec beside phase 5's.
13. SLAC + IQL, card vs CPU: the shipped image-RL configuration at full
    width (100px, 8-step windows, SLAC feature 256, z1 32, z2 256, heads
    256 × 2; policy over feature_action and critic over z, 1024 × 2; seeded
    weights) in f32 with TF32 off, on the card and on the CPU in f32 and
    f64, from the same windows (batch 4) and posterior noise: one
    ``latent_step`` (the three ELBO terms, every latent gradient) and one
    IQL ``train()`` with its joint latent step (metrics, the policy, critic
    and latent gradients, and the parameters after the step). The card's
    f32 result must be as close to the f64 one as the CPU's f32 result is
    (within 3×, or the floors of phase 7); after the Adam step, the share of
    entries more than 1e-6 from f64 likewise (floor 1e-4), none more than
    2·lr.
14. SLAC pretraining (a main path): a seeded real 100px dataset of 10
    episodes × 1,000 steps through ``ingest_real``; ``pretrain_latent`` at
    batch 32 (cuDNN TF32 on, PyTorch's default): ELBO steps/sec over 300
    timed steps, each loss at the first and the last of them (finite, the
    total must fall), and a profile of one ELBO step (launches, idle share).
15. S2P-augmented IQL + SLAC (a main path): one buffer, as
    ``run_iql_image.sh`` fills it: the first 1,000 rows of phase 14's
    dataset, and the first 1,000 rows of phase 11's augmented dataset with
    the frames its bridge rendered, through ``ingest_generated`` with the
    aleatoric penalty (λ 2); phase 14's latent; ``train_many`` at batch 128
    with the joint latent step: IQL + SLAC steps/sec over 100 timed steps,
    finite metrics, policy, critic and latent weights that moved, and a
    profile of one step (launches, idle share). Neither SLAC path launches
    a MAT-norm kernel (counts reset to 0 just before each timed window and
    read just after it); the generation that fills the buffer is counted
    in phase 11.

16. CQL and SAC, card vs CPU: one full-width CQL + SLAC ``train()`` in
    the ``run_cql_image.sh`` configuration (phase 13's SLAC, policy over
    feature_action and critic over z, 1024 × 2, ``num_random`` 10,
    ``min_q_version`` 3, ``min_q_weight`` 5; batch 4, data actions at the
    atanh clip ±1) twice: the BC warm-up (``policy_eval_start`` 40,000)
    without the Lagrange α′, and SAC's policy loss (0) with it; then one
    state SAC step at ``collect_dataset.py``'s width (cheetah obs 17,
    action 6, policy and critic 256 × 2, batch 256). f32 with TF32 off on
    the card and on the CPU in f32 and f64, from one set of host draws;
    held as phase 13 holds its steps.
17. S2P-augmented CQL + SLAC (a main path): phase 15's buffer (1,000 real
    + 1,000 generated rows, aleatoric λ 2) and phase 14's latent;
    ``train_many`` at batch 128 with the joint latent step: CQL + SLAC
    steps/sec over 100 timed steps, finite metrics, moved policy, critic
    and latent weights, a profile of one step (launches, idle share), no
    MAT-norm launch (counts reset just before the timed window and read
    just after it).
18. evaluation metrics: ``inception_fid_extractor`` pool3 features of a
    320² input (downsampled to 299²), calibrated ``LPIPSMetric`` distances
    and ``PerceptualMetric`` distances (64px), seeded weights, held card f32
    vs CPU f32 and f64 as phase 13 holds its steps; then (a main path,
    counts reset around it) ``evaluate_pairs(perceptual=LPIPSMetric)`` over
    the 2,048 64px frames of one phase-5 rollout against 2,048 seeded
    frames at batch 256 (LPIPS pairs/sec), the extractor over both sets
    (FID images/sec), ``compute_fid`` of the two, and a profile of one
    extraction batch.
19. the S2P-augmented RL experiment (a main path, ``run_iql_image.sh``):
    first one full-width acting step (a window of 8 100px frames,
    ``SlacAlgorithm.preprocess``, the deterministic ``PolicyAgent`` over
    ``TanhGaussianPolicy(1024, 1024)`` on the 2,090-wide feature_action),
    card f32 vs CPU f32 and f64, feature and action held as phase 13 holds
    its steps. Then the ``mujoco_finetune`` CLI's own pieces, on stub envs
    and in-memory data (the card machine has neither dm_control nor h5py):
    ``make_slac`` with phase 14's latent and real rows, then
    ``ingest_generated_on_device`` renders phase 11's 1,000 augmented rows
    with a seeded 100px ngf-64 generator in bf16 and ingests them (aleatoric
    λ 2; counts reset just before and read just after: 13 forward launches
    per batch of 256); then ``build_image_rl`` of the IQL configuration
    (batch 128, epochs −2, −1 and 0 of 100 steps, eval and exploration on
    ``StubEnv`` 100px with cheetah's 250-step horizon, no video) and its
    ``train()`` (no MAT-norm launch), then the CQL configuration for one
    offline epoch of 20 steps. Checks: progress.csv has the frozen columns
    of ``tests/fixtures/walker_image_iql_progress.csv``, finite trainer
    values, moved policy, critic and latent weights, 250-step eval paths,
    ``params.pkl`` and ``rewards_list.pkl``. Prints eval env-steps/sec,
    train steps/sec inside the loop, each epoch's ``time/`` columns,
    generated frames/sec and a profile of one acting step (launches, idle
    share).
20. data-parallel GAN training and the tensor-parallel generator, on
    BASELINE's multi-env configuration: cheetah (state 17) + walker (state
    24) pair datasets of 256 seeded uint8 100px rows each, concatenated
    (``S2PPairDataset.concat``, states zero-padded to 24), at the training
    protocol (global batch 16, bf16 on f32 parameters, ngf/ndf 64, 2 D
    scales x 4 layers, VGG19 loss, R1 every 16).
    20a (a main path): world 1 over NCCL (a TCP store on 127.0.0.1, this
    card); the per-step DP path (each step from the single-process
    trainer's state) and ``train_many_dp`` (2 steps at learning rate 0)
    held in f32 (TF32 off, cuDNN's deterministic algorithms) to the
    single-process ``train_step``/``train_many`` with the same draws
    (phase 7's floors; the largest differences printed); 30 timed
    bf16 per-step DP steps, in turns with 30 of a single-process copy of the
    trainer (and beside phase 8's rate), counts reset just before each DP
    window and read just after it (26 forward and 13 backward launches per
    step); the gradient sync alone (the flatten, the two all-reduces, the
    copies back) in device ms from the profiler, beside the stream's time
    between CUDA events.
    20b (a main path): 2 ranks over gloo, both on this card, spawned; one
    f32 step (global batch 4, D's learning rate 0 as in phase 7) held to
    the card's single-process f32 step on the global batch (phase 7's
    floors) and to that step in f64 on the CPU (phase 7's rule), the CPU's
    f64 and f32 steps replaying every ReLU's slope from the card's step (a
    pre-activation within f32 noise of zero flips its slope, and one flip
    moves a weight gradient by up to ~1e-2 of the largest; the flips are
    counted, and both steps' distances from f64 with their own slopes
    printed), then 2 bf16 per-step DP steps and 2 bf16
    ``train_many_dp`` steps; after every step the ranks' state checksums
    (all-gathered) must agree, and each rank must count 26 forward and 13
    backward MAT-norm launches in it (its counts start at 0 in its own
    process). The rate is gloo through the host on one card: a correctness
    check, not a multi-card number.
    20c (a main path): the serving generator (64px, ngf 64) sharded over a
    data=1 x model=2 mesh of gloo ranks on this card (``min_features``
    256): each rank's forward within 2e-5 of the replicated forward on the
    card in f32 (TF32 off), at least one layer sharded, 13 MAT-norm
    launches per rank. A rank that fails or times out fails the run.
21. data-parallel RL steps, on phase 15's IQL + SLAC and phase 17's CQL +
    SLAC configurations (batch 128, joint latent step at batch 32) and
    phase 14's ELBO step (batch 32).
    21a (a main path): world 1 over NCCL on phase 15's buffer (1,000 real +
    1,000 generated rows); per configuration one f32 DP step (TF32 off,
    cuDNN deterministic) bit-equal to the single-process step on the same
    draws (metrics, every gradient and parameter), then 15 timed DP steps
    (``train_many_dp``, or ``update_latent_many`` in a group) in turns with
    15 of a single-process copy, cuDNN TF32 on (counts reset just before
    each DP window and read just after it: no MAT-norm launch); the
    networks' parameter counts, the sync alone (the gradient and metric
    all-reduces of one step) in device ms and launches beside its f32 bytes,
    and a profile of one DP step.
    21b (a main path): 2 gloo ranks on this card, on 1,000 seeded real
    rows; per configuration one f32 step on each rank's rows of a global
    batch of 8 rows and 8 windows held to the card's single-process f32 step
    on the whole batch (phase 7's floors; the latent model's leaky-ReLU
    slopes replayed from that step, the flips counted), then a warm-up and
    3 timed steps at the shipped batches; after every step the ranks' state
    checksums (all-gathered) must agree. The rate is gloo through the host: a correctness check, not a
    multi-card number.
    21c (a main path): the state IQL and CQL loops of ``mujoco_finetune``'s
    state branch (256 x 2, batch 128) on 20,000 seeded cheetah transitions,
    world 1 over NCCL: ``train_many_dp`` bit-equal to ``train_many`` on the
    same rows over 5 steps (TF32 off), then 50 timed steps of each in turns.
22. the collection loop (a main path): ``collect_dataset.collect`` (SAC 256
    x 2, batch 256, one train step per env step after 1,000 random steps)
    for 2,000 steps of a stub of cheetah-run (state 17, action 6,
    ``physics.data.qpos``/``qvel`` 9 + 9, 250-step horizon) on the card:
    the JAX script's keys, dtypes and shapes, finite values, 8 timeouts;
    env steps/sec of the random and of the training phase from the stub's
    step stamps; no MAT-norm launch (counts reset around it); a profile of
    one SAC step (launches, idle share).
23. the CURL/RAD pixel path (a main path): 3-frame stacks (9 channels) of
    phase 11's 100px bridge frames. (a) every augmentation of
    ``nn.augmentations`` on the card against the CPU on the same draws
    (batch 128; crop, translate, cutout, flip, rotation and no-aug
    bit-equal; grayscale, the random convolution and the colour jitter
    within 1 uint8 step on ≤ 1% of the values), with its time a call;
    grayscale (RGB only, as in JAX) runs on the first frame and must raise
    ``ValueError`` on the whole 9-channel stack on both devices.
    (b) one f32 step (TF32 off) at full width (encoder feature 50, 4 layers
    of 32 filters, fc fan-in 39,200; heads 1024 x 2; action 6) on 16 rows of
    84px crops, on the card and on the CPU in f32 and f64 (the encoders'
    ReLU slopes replayed from the card's step): the encoder critic's twin-Q
    TD loss and CURL's loss and their gradients, the policy-with-encoder's
    sample, log-prob and policy-loss gradients (its convs get none), held as
    phase 7 holds its step. (c) pixel updates/sec at batch 128 (crop on the
    card → critic + CURL loss → backward → Adam), with one update's
    launches, device time and idle share; no MAT-norm launch.
24. the goal-conditioned and multitask path (a main path) on
    ``testing.goal_env.PointRobotGoalEnv``: ``GoalConditionedPathCollector``
    with a ``TanhGaussianPolicy`` (256 x 2) on the card fills
    ``ObsDictRelabelingBuffer`` (2,000 env steps); a relabelled batch's
    rewards are the env's for its goals; one SAC step on it card f32 vs CPU
    f32/f64 as phase 16's; 200 SAC steps (256 x 2, batch 256) on
    relabelled batches; then ``MetaRLAlgorithm`` over
    ``MultiTaskReplayBuffer`` (3 iterations of 10 tasks x 20 env steps and
    20 SAC steps on 4 tasks x 64 rows). Env steps/sec and SAC steps/sec;
    no MAT-norm launch.
25. the dry run (``s2p_tpu_torch.cli.dryrun``, the port of
    ``__graft_entry__.py``; a main path each). (a) ``entry()`` on the card:
    the full-width generator's f32 forward (64px, ngf 64, batch 8, TF32
    off) on seeded inputs launches 13 MAT-norm kernels a call (counts reset
    just before); each norm's kernel output against the plain version on
    the same inputs (1e-5), the forward against the same forward with the
    plain norm on the card and on the CPU (5e-3); ms a call of both.
    (b) ``dryrun_multichip(2)`` and (c) ``dryrun_multichip(4)``: gloo ranks
    sharing the card run every leg of the JAX dry run (data-parallel GAN
    step, IQL + SLAC step, GAN ``train_many_dp``, the state and image IQL
    and CQL ``train_many_dp`` loops; at 4 ranks the TP generator on a 2 x 2
    mesh within 1e-4 of its unsharded forward); with 2 or 4 cards these run
    over NCCL, a card a rank; (d) with another count of cards (≥ 2),
    ``dryrun_multichip(device_count)`` over NCCL. Each rank's MAT-norm
    launches per leg come back in its record (2 forward and 1 backward per
    G step, 2 TP forwards, none in the RL legs) and go into the kernels
    line under ``dryrun``. Every trained leg leaves the ranks' parameters
    bit-equal, and the state legs (on global batch indices and CQL draws
    the ranks share out) within 1e-5 of one process's ``train_many``.
26. GauGAN (a main path): the SPADE-norm kernel against its plain version
    at the 18 norm shapes of one pass (ADE20K 256², ngf 64; batch 32, f32
    and bf16, γ and β as the halves of one γ‖β tensor and as contiguous
    tensors, plus a scalar-path shape off the vector grid), without and
    with the γ‖β bias folded, with its plan and its device time (also with
    the bias folded) beside its bytes-bound time and the plain version's
    per shape; then ``synthesize_fast`` at batch 32 in bf16 with the
    ``spade-ade256-b32`` cell's weights and maps: a pass must launch the
    kernel 18 times, each with the bias folded (counts reset just before),
    the module path none with a bias, and its frames must hold to the
    module path in f32 (TF32 off) within the cell's limits.

27. the hidden-map kernel (a main path each): one fast-path pass of each
    cell's generator (``cheetah64-rollout-b256`` and
    ``walker100-bridge-b256`` through ``fast_apply``, ``spade-ade256-b32``
    through ``synthesize_fast``; full width, the cell's batch, bf16) must
    launch ``hidden_maps`` 5 times with the constant-map terms (S2P) or 7
    times without (GauGAN), counts reset just before, and one module-path
    pass none; at every call's shapes of those passes the kernel is held to
    ``hidden_maps_plain`` in bf16 and f32 (the terms as the same strided
    slice of a wider tensor), with its device time beside its bytes-bound
    time (read h, write the maps), the plain version's and that of the glue
    it replaced, per shape and per pass.
28. StyleGAN (a main path): the MAT-norm kernel as AdaIN against its plain
    version at the 9 shapes of its 18 launches a pass (FFHQ 1024², batch
    32, bf16 and f32, γ‖β one ``[B, 2C]`` style tensor broadcast over the
    pixels at stride 0, ε 1e-8), every launch counted in ``style_launches``,
    with its plan and device time beside its bytes-bound time (read x,
    write out, 2·B·C style values) per shape and per pass; the
    style-epilogue kernel against ``style_epilogue_plain`` at the same 9
    shapes (bf16 and f32; noise, strength and bias N(0, 1), so that leaving
    out the noise or the bias, or a wrong slope, fails the tolerance, which
    is checked on the plain version), one launch counted each, its device
    time beside its bytes-bound time (x read and written, the f32 noise),
    the plain version's and the eager ops' it replaced; then
    ``synthesize_style_fast`` at batch 32 in bf16 with the
    ``stylegan-ffhq1024-b32`` cell's weights: a pass must launch the
    MAT-norm kernel 18 times, all style launches, and the epilogue kernel
    18 times (counts reset just before), its device time, and its frames
    must hold to the module path in f32 (TF32 off, the same noise; 18 and
    18 launches too) within the cell's limits; one pass of the S2P fast and
    module paths must launch the MAT-norm kernel with no style launch and
    the epilogue kernel not at all.

``--ab DIR`` runs phases 1 and 2, then times the norm kernels against
those of the checkout in DIR in turns (without and with the γ‖β bias
folded), then the two main paths end to end
(serving frames/sec, bf16 and f32 train step), each side in processes of
its own (``--time-paths ROOT``), in turns, and stops. ``--sweep`` runs
phases 1 and 2, then times every launch plan of the two kernels at each
bf16 main-path shape, and stops. ``--spade`` runs phases 1, 2 and 26, and
stops; ``--hidden`` runs phases 1, 2 and 27, and stops; ``--stylegan`` runs
phases 1, 2 and 28, and stops.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes a
torch.profiler summary of one throughput rollout, of one bf16 train step,
of four bridge batches, of 20 ensemble steps, of one ``gb_int8`` rollout,
of one ELBO step, of one IQL + SLAC step, of one CQL + SLAC step, of one
LPIPS batch, of one FID extraction batch, of one acting step, of one
SAC step of the collection loop and of one pixel update to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
STATE_DIM = 17  # cheetah
FULL = dict(image_size=64, ngf=64, state_freqs=6, state_embed_dim=256, mat_hidden=128)
BF16_TOL = 1e-2  # rtol and atol: one bf16 rounding step (2^-7 relative) of the same f32 value
F32_TOL = 1e-5
ROLLOUT_TOL = 5e-3  # tests/test_fast_inference.py:137
BATCH, SEQ_LEN, TIMED_ROLLOUTS = 256, 8, 10
# the training protocol: docs/E2E_RESULTS.md, s2p_tpu/cli/train_gan.py defaults
TRAIN_SIZE, TRAIN_BATCH, TIMED_STEPS, MANY_STEPS = 100, 16, 32, 16
TRAIN_D, D_LR = dict(ndf=64, num_scales=2, n_layers=4), 4e-4
# backward kernel vs plain, relative to max|plain|: f32 sums over up to
# 10,000 pixels in another order (~1e-6 seen); bf16 outputs may differ by
# one bf16 rounding step (2^-8) of the largest element
BWD_F32_TOL, BWD_BF16_TOL = 1e-4, 1e-2
# train step parity: the card's f32 step may be at most PARITY_SLACK times
# as far from the f64 CPU step as the CPU's f32 step is (f32 sums in R1's
# double backward and in the backward through the instance norms of D's
# small coarse-scale maps cancel, so the f32 error is set by the
# configuration, which the CPU's f32 run measures); floors: relative for
# metrics, of the module's largest |gradient| for gradients
PARITY_SLACK, METRIC_FLOOR, GRAD_FLOOR = 3.0, 1e-5, 1e-4
# PR 2's kernel ms per launch (one block per (image, 32 channels), x read
# three times, scalar loads), PERF.md §5: NVIDIA H100 80GB HBM3, 700.00 W;
# (H=W, C) → ms. Wall time per wrapper call, host included: printed beside
# this run's wall time per call, never compared with it and not in the
# kernels record (--ab times PR 2's tree in the same call).
PR2_SERVING_FWD_MS = {(4, 512): 0.0342, (8, 256): 0.0326, (8, 512): 0.0395, (16, 128): 0.0535,
                      (16, 256): 0.0621, (32, 64): 0.0737, (32, 128): 0.1647, (64, 64): 0.3306}
PR2_TRAIN_FWD_MS = {(7, 512): 0.0339, (13, 256): 0.0329, (13, 512): 0.0593, (25, 128): 0.0359,
                    (25, 256): 0.0589, (50, 64): 0.0332, (50, 128): 0.0528, (100, 64): 0.2067}
PR2_TRAIN_BWD_MS = {(7, 512): 0.0288, (13, 256): 0.0275, (13, 512): 0.0490, (25, 128): 0.0305,
                    (25, 256): 0.0489, (50, 64): 0.0501, (50, 128): 0.1115, (100, 64): 0.4535}
PR2_STEP_MS = dict(serving_fwd=1.4224, train_fwd=0.9250, train_bwd=1.4913,
                   train_fwd_f32=1.0465, train_bwd_f32=1.6213)
# off the main path: the streaming path (a slice too large for shared memory
# even split 8 ways) at 256² × 64, batch 2; the scalar path, (batch, H=W, C)
# with C off the 32 grid, at shapes that take it resident and streaming,
# each whole and split over a cluster (tests/test_torch_mat_norm_plan.py)
STREAM_SHAPE = (2, 256, 64)
SCALAR_SHAPES = ((16, 13, 12), (16, 8, 100), (16, 5, 40), (2, 50, 100), (8, 50, 100),
                 (64, 25, 40))
SCALAR_PATHS = {("resident", False), ("resident", True), ("streaming", False),
                ("streaming", True)}  # (path, split over a cluster)
# the augmentation pipeline: the cheetah ensemble at the rollout CLI's
# defaults (E 7, hidden 256 × 3) and the 100px generator of the image bridge
ACT_DIM = 6
BRIDGE_SIZE = 100
WM_ROWS, WM_TOL = 4096, 1e-5
PIPE_EPISODES, PIPE_EPISODE_LEN, PIPE_TRAIN_STEPS = 500, 1000, 2000  # the reference's 500k rows
PIPE_FRAMES = 16384  # frames rendered: 64 batches of 256 (all 500k: 15 GB of uint8 on the host)
BRIDGE_MAX_DIFF, BRIDGE_DIFF_SHARE = 1, 0.01
GB_INT8_PSNR, GB_INT8_ROLLOUTS = 38.0, 3  # tests/test_fast_inference.py:170
# SLAC + IQL image RL at the shipped configuration (run_iql_image.sh,
# s2p_tpu/cli/mujoco_finetune.py:180-188,254-267): cheetah (action dim 6),
# 100px frames, 8-step windows, SLAC feature 256, z1 32, z2 256, heads
# (256, 256), latent batch 32, Adam 1e-4; policy and critic (1024, 1024);
# IQL batch 128, joint latent update every step
SLAC_KW = dict(num_sequences=8, feature_dim=256, z1_dim=32, z2_dim=256, hidden_units=(256, 256),
               image_size=BRIDGE_SIZE, lr_latent=1e-4)
IQL_KW = dict(discount=0.99, policy_lr=1e-4, qf_lr=3e-4, reward_scale=1.0, beta=0.1,
              quantile=0.7, clip_score=100.0, soft_target_tau=0.005, target_update_period=2)
IQL_HIDDEN, IQL_BATCH, SLAC_BATCH = (1024, 1024), 128, 32
SLAC_PARITY_BATCH = 4  # phase 13: windows per step on the card, the CPU f32 and the CPU f64
SLAC_EPISODES, SLAC_EPISODE_LEN = 10, 1000  # phase 14's real dataset: 10k 100px frames
PRETRAIN_STEPS, IQL_STEPS = 300, 100  # timed ELBO steps (phase 14), IQL + SLAC steps (15)
SLAC_REAL_ROWS = SLAC_GEN_ROWS = 1000  # data_mix_num_real, data_mix_num_gen
UNCERTAINTY_TYPE, UNCERTAINTY_LAMBDA = "aleatoric", 2.0
# CQL + SLAC at run_cql_image.sh's configuration (s2p_tpu/cli/mujoco_finetune.py:254-275):
# IQL's networks and batch, the CLI's CQL defaults
CQL_KW = dict(discount=0.99, policy_lr=1e-4, qf_lr=3e-4, reward_scale=1.0, soft_target_tau=5e-3,
              policy_eval_start=40_000, temp=1.0, min_q_version=3, min_q_weight=5.0,
              num_random=10)
CQL_PARITY_CASES = ((False, 40_000), (True, 0))  # (with_lagrange, policy_eval_start)
CQL_STEPS = 100  # timed CQL + SLAC steps (phase 17)
# SAC at collect_dataset.py:56-61 (cheetah obs 17, action 6, 256 x 2, batch 256)
SAC_HIDDEN, SAC_BATCH = (256, 256), 256
# evaluation metrics (phase 18): one phase-5 rollout's frames at batch 256
EVAL_BATCH, EVAL_PARITY_SIZE = 256, 320
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
PARITY_RUNS = (("cpu f64", "cpu", "float64"), ("cpu f32", "cpu", "float32"),
               ("cuda f32", "cuda", "float32"))
# the RL experiment (phase 19): run_iql_image.sh through the CLI's assembly,
# cut to epochs -2..0 of 100 steps (the reference: -150..0 of 2,000); CQL one
# offline epoch of 20; cheetah's horizon, 1,000 steps / frame skip 4
RL_LOOP_STEPS, RL_CQL_STEPS, CHEETAH_HORIZON = 100, 20, 250
FROZEN_CSV = os.path.join("tests", "fixtures", "walker_image_iql_progress.csv")
# data-parallel GAN training (phase 20): BASELINE's multi-env configuration,
# cheetah + walker (state 24, cheetah's 17 zero-padded), DP_ROWS seeded rows
# each, at the training protocol (global batch TRAIN_BATCH); DP_STEPS timed
# per-step DP steps at world 1 over NCCL; the tensor-parallel generator at
# the serving width (FULL) on a data=1 x model=2 mesh
WALKER_STATE_DIM, DP_ROWS, DP_STEPS, DP_WORLD = 24, 256, 30, 2
# 20b's f32 step against f64 on the CPU: a global batch of 4 (2 a rank), since
# a full-width f64 step costs ~4 s per image on the card machine's CPU
DP_PARITY_BATCH = 4
TP_MIN_FEATURES, TP_BATCH = 256, 4
TP_TOL = 2e-5  # tests/test_parallel.py::test_model_shard_params_tensor_parallel_generator
# data-parallel RL (phase 21): phase 15's IQL + SLAC, phase 17's CQL + SLAC and
# phase 14's ELBO step; DP_RL_STEPS timed steps a window at world 1 over NCCL
# (21a); 2 gloo ranks on this card (21b) on DP_RL_ROWS seeded real rows, their
# f32 step at a global batch of DP_RL_PARITY_BATCH rows and windows (4 a rank:
# fewer pre-activations within f32 noise of a ReLU's kink than at 128), then
# DP_RL_GLOO_STEPS timed steps a configuration; the state loops (21c) of
# mujoco_finetune's state branch (256 x 2, batch 128) on STATE_ROWS seeded
# cheetah transitions
DP_RL_STEPS, DP_RL_GLOO_STEPS, DP_RL_PARITY_BATCH, DP_RL_ROWS = 15, 3, 8, 1000
STATE_HIDDEN, STATE_ROWS, STATE_STEPS, STATE_PARITY_STEPS = (256, 256), 20_000, 50, 5
# the collection loop (phase 22): collect_dataset.py's SAC on a stub of cheetah
COLLECT_STEPS, COLLECT_RANDOM = 2000, 1000
# the CURL/RAD pixel path (phase 23): the encoder's defaults (feature 50, 4
# layers of 32 filters), heads 1024 x 2, 3 stacked 100px frames (9 channels)
# cropped to 84 (fc fan-in OUT_DIM_84[4]^2 x 32 = 39,200), batch 128 (the RL
# CLI's --batch_size), action 6; the f32 step held to f64 on the CPU at
# PIXEL_PARITY_BATCH rows (an f64 step at 128 costs ~40 s of the card
# machine's CPU); PIXEL_STEPS timed updates
PIXEL_ENC = dict(feature_dim=50, num_layers=4, num_filters=32)
PIXEL_HIDDEN, PIXEL_STACK, PIXEL_CROP, PIXEL_BATCH = (1024, 1024), 3, 84, 128
PIXEL_TRANSLATE, PIXEL_CUTOUT = 108, (10, 30)
PIXEL_PARITY_BATCH, PIXEL_STEPS, PIXEL_LR = 16, 50, 1e-3
# the goal-conditioned and multitask path (phase 24): a goal-dict point robot
# (10 tasks, 20-step episodes), SAC 256 x 2 at batch 256 (collect_dataset.py's),
# HER with 20% rollout goals; the meta loop: 10 tasks an iteration, 4 tasks x
# 64 rows a SAC batch
GOAL_ENV_STEPS, GOAL_BUFFER, GOAL_SAC_STEPS = 2000, 10_000, 200
META_ITERS, META_TRAIN_STEPS, META_TASKS, META_BATCH = 3, 20, 4, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` with no synchronisation: what one call
    costs the CPU. Where it is near the kernel's time, the timed loop reads
    launch overhead, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, whose replay is timed with events, so that no host time between
    launches enters the number (the wrapper's own host work is not in the
    graph)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


class HostWindow:
    """A timed window of host-bound steps (``with HostWindow() as w``), and
    what it spent besides its own work: the CPU seconds of this thread and
    of the whole process against the wall (``wall``, synchronized at both
    ends), the cores' mean clock at the end, the cyclic garbage collector's
    pauses, the caching allocator's device mallocs, frees and retries (each
    cudaMalloc or cudaFree synchronizes) and the objects the collector
    tracks."""

    def __enter__(self):
        import gc

        import torch

        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self._gc)
        self._mem = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        self._wall, self._cpu = time.perf_counter(), time.process_time()
        self._thread = time.thread_time()
        return self

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def __exit__(self, *exc) -> None:
        import gc

        import torch

        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self._wall
        self.cpu = time.process_time() - self._cpu
        self.thread = time.thread_time() - self._thread
        gc.callbacks.remove(self._gc)
        mem = torch.cuda.memory_stats()
        self.device_mallocs = {k: mem.get(k, 0) - self._mem.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")}
        self.reserved_gb = torch.cuda.memory_reserved() / 1e9
        self.objects = len(gc.get_objects())
        try:
            with open("/proc/cpuinfo") as f:
                mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
            self.mhz = sum(mhz) / len(mhz)
        except (OSError, ValueError, ZeroDivisionError):
            self.mhz = float("nan")

    def __str__(self) -> str:
        return (f"wall {self.wall:.3f} s, CPU {self.thread:.3f} s this thread, {self.cpu:.3f} s "
                f"the process, cores at {self.mhz:.0f} MHz, gc {self.gc_s:.3f} s in {self.gc_n} "
                f"collections ({self.objects} objects tracked), allocator "
                + ", ".join(f"{k.removeprefix('num_')} {v}" for k, v in self.device_mallocs.items())
                + f" (reserved {self.reserved_gb:.1f} GB)")


def plan_label(plan) -> str:
    return (f"{plan.path} k={plan.cluster} tile={plan.tile_c} "
            f"{'vec16' if plan.vec else 'scalar'} grid={plan.grid}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_shapes(gen) -> dict:
    """(H, C) → launches per generator step, from the generator's blocks:
    norm_0 on the block input, norm_1 on min(in, out), norm_s on the input
    when the channel count changes."""
    shapes: dict = {}
    for size, (c_in, c_out) in zip(gen.sizes, gen.block_channels):
        for c in [c_in, min(c_in, c_out)] + ([c_in] if c_in != c_out else []):
            shapes[(size, c)] = shapes.get((size, c), 0) + 1
    return shapes


def dryrun_worlds() -> list:
    """(label, world) of phase 25's dry runs: 2 and 4 ranks, and with
    another count of cards (≥ 2) one rank a card."""
    import torch

    worlds = [("25b", 2), ("25c", 4)]  # NCCL already where each rank has a card
    if torch.cuda.device_count() >= 2 and torch.cuda.device_count() not in (2, 4):
        worlds.append(("25d", torch.cuda.device_count()))
    return worlds


def dryrun_norm_shapes() -> dict:
    """``norm_shapes`` of the dry run's two generators: the GAN legs' ("dryrun
    gan") and the TP leg's ("dryrun tp")."""
    from s2p_tpu_torch.gan import S2PGenerator
    from s2p_tpu_torch.testing import dryrun_worker as dw

    return {"dryrun gan": norm_shapes(S2PGenerator(STATE_DIM, image_size=dw.GAN_SIZE,
                                                   device="cpu", **dw.GAN_G)),
            "dryrun tp": norm_shapes(S2PGenerator(STATE_DIM, device="cpu", **dw.TP_G))}


def parallel_norm_cases() -> tuple:
    """(path, batch, generator, dtype names, backward too) of the MAT norms
    that the data- and tensor-parallel paths launch, whose launch plans
    depend on the batch: each 20b rank's bf16 protocol steps and its f32
    step on the 100px ("train") chain, each 20c rank's TP forward (f32) on
    the serving shapes, and phase 25's ranks: the GAN legs' f32 steps at
    ``dw.ROWS`` rows a rank and the TP leg's f32 forwards at each TP
    world's batch. 20a, at world 1, runs phase 8's batch."""
    from s2p_tpu_torch.testing import dryrun_worker as dw

    tp_batches = sorted({dw.ROWS * world for _, world in dryrun_worlds()
                         if "tp" in dw.leg_names(world)})
    return (("dp rank", TRAIN_BATCH // DP_WORLD, "train", ("bfloat16", "float32"), True),
            ("dp rank f32 step", DP_PARITY_BATCH // DP_WORLD, "train", ("float32",), True),
            ("tp forward", TP_BATCH, "serving", ("float32",), False),
            ("dryrun gan rank", dw.ROWS, "dryrun gan", ("float32",), True),
            *(("dryrun tp", b, "dryrun tp", ("float32",), False) for b in tp_batches))


def mat_norm_inputs(batch, size, C, dtype, strided, mean=0.0, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (mean + torch.randn(batch, size, size, C, device="cuda", generator=g)).to(dtype)
    gb = (0.5 * torch.randn(batch, size, size, 2 * C, device="cuda", generator=g)).to(dtype)
    if not strided:
        gb = gb.view(batch, size, size, 2, C).movedim(3, 0).contiguous()
        return x, gb[0], gb[1]
    return x, gb[..., :C], gb[..., C:]


def gb_bias_like(x, seed: int = 0):
    """A seeded γ‖β conv bias ``[2C]`` in x's type on the card, the operand
    the fast path folds into the norm kernels (``gb_bias``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (0.5 * torch.randn(2 * x.shape[-1], device="cuda", generator=g)).to(x.dtype)


def phase_kernels(ck, shapes, bridge_shapes) -> dict:
    import torch
    import torch.nn.functional as F

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def check(x, g, b, label):
        """The kernel against its plain version, without and with a folded bias."""
        for gb_bias in (None, gb_bias_like(x, seed=x.shape[-1])):
            before = ck.fused_mat_norm.bias_launches
            out = ck.fused_mat_norm(x, g, b, gb_bias=gb_bias)
            if ck.fused_mat_norm.bias_launches - before != (gb_bias is not None):
                fail(f"fused_mat_norm.bias_launches miscounted a launch at {label}")
            ref = ck.fused_mat_norm_plain(x, g, b, gb_bias=gb_bias)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            atol, rtol = (F32_TOL, 0.0) if x.dtype == torch.float32 else (BF16_TOL, BF16_TOL)
            bad = err > atol + rtol * ref.float().abs()
            max_err[x.dtype] = max(max_err[x.dtype], err.max().item())
            if not torch.isfinite(out).all() or bad.any():
                fail(f"fused_mat_norm vs plain at {label}, gb_bias "
                     f"{'folded' if gb_bias is not None else 'none'}: max |err| "
                     f"{err.max().item():.3g}")
        return ck.forward_plan(x, g, b)

    launches_before = ck.fused_mat_norm.launches
    step = dict(ms=0.0, bias_ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                instance_norm_ms=0.0)
    split = False  # a main-path shape ran resident with k > 1
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for (size, C), per_step in sorted(shapes.items()):
            for strided in (True, False):
                x, g, b = mat_norm_inputs(BATCH, size, C, dtype, strided, seed=size * C)
                plan = check(x, g, b, f"B={BATCH} H=W={size} C={C} {name} strided={strided}")
            x, g, b = mat_norm_inputs(BATCH, size, C, dtype, strided=True, seed=size * C)
            plan = ck.forward_plan(x, g, b)
            split |= plan.path == "resident" and plan.cluster > 1
            ms = device_ms(lambda: ck.fused_mat_norm(x, g, b))
            bias = gb_bias_like(x, seed=C)
            bias_ms = device_ms(lambda: ck.fused_mat_norm(x, g, b, gb_bias=bias))
            wall_ms = time_ms(lambda: ck.fused_mat_norm(x, g, b))
            plain_ms = device_ms(lambda: ck.fused_mat_norm_plain(x, g, b))
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, as the generator holds it
            inorm_ms = device_ms(lambda: F.instance_norm(x_nchw, eps=1e-5))
            bound_ms = 4 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            us = host_us(lambda: ck.fused_mat_norm(x, g, b))
            pr2 = (f" (PR 2 {PR2_SERVING_FWD_MS[(size, C)]:.4f})"
                   if dtype == torch.bfloat16 else "")
            print(f"mat_norm {name} B={BATCH} H=W={size} C={C} x{per_step}/step "
                  f"[{plan_label(plan)}]: kernel {ms:.4f} ms (gb_bias folded {bias_ms:.4f} ms, "
                  f"{100 * (bias_ms / ms - 1):+.2f}%), wall per call {wall_ms:.4f} ms"
                  f"{pr2}, host {us:.1f} us/call  plain {plain_ms:.4f} ms  F.instance_norm "
                  f"{inorm_ms:.4f} ms  bound {bound_ms:.4f} ms")
            if dtype == torch.bfloat16:  # the main path's working type
                for key, v in dict(ms=ms, bias_ms=bias_ms, wall_ms=wall_ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, instance_norm_ms=inorm_ms).items():
                    step[key] += per_step * v
    if not split:
        fail("no main-path shape ran the resident path split over a cluster")

    # 100px chain (odd H·W); the scalar path (channel counts off the 32 grid)
    odd = [(16, 7, 512), (16, 13, 512), (16, 13, 256), (16, 25, 256), (16, 25, 128),
           (16, 50, 128), (16, 50, 64), (16, 100, 64)]
    scalar_paths = set()
    for dtype in (torch.bfloat16, torch.float32):
        for batch, size, C in odd + list(SCALAR_SHAPES):
            for strided in (True, False):
                x, g, b = mat_norm_inputs(batch, size, C, dtype, strided, seed=size + C)
                plan = check(x, g, b, f"B={batch} H=W={size} C={C} {dtype} strided={strided}")
                if (batch, size, C) in SCALAR_SHAPES:
                    if plan.vec:
                        fail(f"C={C} took the vector path: {plan_label(plan)}")
                    scalar_paths.add((plan.path, plan.cluster > 1))
    if scalar_paths != SCALAR_PATHS:
        fail(f"the scalar forward ran {sorted(scalar_paths)}, not every path and split")
    # the image bridge: the 100px chain at batch 256, γ and β contiguous (the
    # module path's separate conv outputs); timed in bf16, its working type
    bridge = dict(ms=0.0, bias_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for (size, C), per_step in sorted(bridge_shapes.items()):
            x, g, b = mat_norm_inputs(BATCH, size, C, dtype, strided=False, seed=size + 3 * C)
            plan = check(x, g, b, f"bridge B={BATCH} H=W={size} C={C} {name}")
            if dtype != torch.bfloat16:
                print(f"mat_norm bridge {name} B={BATCH} H=W={size} C={C} [{plan_label(plan)}]: "
                      "matches plain")
                continue
            ms = device_ms(lambda: ck.fused_mat_norm(x, g, b))
            bias = gb_bias_like(x, seed=C)
            bias_ms = device_ms(lambda: ck.fused_mat_norm(x, g, b, gb_bias=bias))
            plain_ms = device_ms(lambda: ck.fused_mat_norm_plain(x, g, b))
            bound_ms = 4 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            print(f"mat_norm bridge {name} B={BATCH} H=W={size} C={C} x{per_step}/step "
                  f"[{plan_label(plan)}]: kernel {ms:.4f} ms (gb_bias folded {bias_ms:.4f} ms, "
                  f"{100 * (bias_ms / ms - 1):+.2f}%)  plain {plain_ms:.4f} ms  "
                  f"bound {bound_ms:.4f} ms")
            for key, v in dict(ms=ms, bias_ms=bias_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms).items():
                bridge[key] += per_step * v
            del x, g, b
    print("mat_norm per 100px/ngf=64 bridge batch of 256 bf16 (13 norms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in bridge.items()))
    for path, batch, gen, dtypes, _ in parallel_norm_cases():
        path_shapes = dict(train=bridge_shapes, serving=shapes, **dryrun_norm_shapes())[gen]
        for name in dtypes:
            plans = set()
            for size, C in sorted(path_shapes):
                for strided in (True, False):
                    x, g, b = mat_norm_inputs(batch, size, C, getattr(torch, name), strided,
                                              seed=batch + size + C)
                    plans.add(plan_label(check(x, g, b, f"{path} B={batch} H=W={size} C={C} "
                                                        f"{name} strided={strided}")))
            print(f"mat_norm {path} B={batch} {name}: {len(path_shapes)} shapes match plain "
                  f"({len(plans)} plans: {', '.join(sorted(plans))})")
    # the streaming path: 256² is too large for shared memory even split 8 ways
    batch, size, C = STREAM_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        x, g, b = mat_norm_inputs(batch, size, C, dtype, strided=True, seed=size)
        plan = check(x, g, b, f"B={batch} H=W={size} C={C} {dtype} (streaming)")
        if plan.path != "streaming":
            fail(f"{size}² x {C} did not take the streaming path: {plan_label(plan)}")
        ms = device_ms(lambda: ck.fused_mat_norm(x, g, b))
        bound_ms = 4 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"mat_norm {dtype} B={batch} H=W={size} C={C} [{plan_label(plan)}]: kernel "
              f"{ms:.4f} ms  bound {bound_ms:.4f} ms (off the main path)")
    # |mean| >> std, offset + k/64 at a power-of-two H·W: exact two-pass
    # statistics (every sum fits f32's 24 bits); 32² splits over a cluster,
    # streaming at batch 2 and resident at batch 32, so the statistics meet
    # across CTAs on both paths
    split_paths = set()
    for batch, size, offset in ((16, 4, 256.0), (16, 8, 256.0), (2, 32, 64.0), (32, 32, 64.0)):
        gen = torch.Generator(device="cuda").manual_seed(size)
        k = torch.randint(-64, 65, (batch, size, size, 64), device="cuda", generator=gen)
        x = offset + k.float() / 64.0
        _, g, b = mat_norm_inputs(batch, size, 64, torch.float32, strided=True)
        plan = check(x, g, b, f"|mean|>>std B={batch} H=W={size} mean {offset}")
        if plan.cluster > 1:
            split_paths.add(plan.path)
    if split_paths != {"resident", "streaming"}:
        fail(f"|mean|>>std was split over a cluster only on {sorted(split_paths)}")

    if ck.fused_mat_norm.launches <= launches_before:
        fail("fused_mat_norm's launch counter did not move")
    print(f"mat_norm max |kernel - plain|: f32 {max_err[torch.float32]:.3g}, "
          f"bf16 {max_err[torch.bfloat16]:.3g} (tolerance f32 atol {F32_TOL}, "
          f"bf16 rtol=atol {BF16_TOL})")
    print("mat_norm per 64px/ngf=64 step at batch 256 bf16 (13 norms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in step.items())
          + f"; PR 2 wall_ms {PR2_STEP_MS['serving_fwd']:.4f}")
    return dict(step, bridge=bridge, max_abs_err=max_err[torch.float32],
                max_abs_err_bf16=max_err[torch.bfloat16])


def phase_parity(ck, gen_cpu, gen_gpu) -> None:
    import numpy as np
    import torch

    from s2p_tpu_torch.gan import generate_rollout, generate_rollout_fast

    rs = np.random.RandomState(0)
    img = torch.from_numpy((rs.rand(4, 64, 64, 3) * 2 - 1).astype(np.float32))
    states = torch.from_numpy(rs.randn(5, 4, STATE_DIM).astype(np.float32))
    per_step = sum(norm_shapes(gen_gpu).values())
    for name, fn in (("generate_rollout_fast", generate_rollout_fast),
                     ("generate_rollout", generate_rollout)):
        t0 = time.time()
        ref = fn(gen_cpu, img, states)
        cpu_s = time.time() - t0
        before = ck.fused_mat_norm.launches, ck.fused_mat_norm.bias_launches
        out = fn(gen_gpu, img.cuda(), states.cuda())
        torch.cuda.synchronize()
        launches = ck.fused_mat_norm.launches - before[0]
        bias_launches = ck.fused_mat_norm.bias_launches - before[1]
        err = (out.cpu() - ref).abs().max().item()
        print(f"parity {name}: seq_len 5 batch 4 f32, max |cuda - cpu| {err:.3g} "
              f"(tolerance {ROLLOUT_TOL}), fused_mat_norm launches {launches} "
              f"({per_step}/step; {bias_launches} with the γ‖β bias folded), cpu "
              f"{cpu_s:.1f} s")
        if out.shape != (5, 4, 64, 64, 3) or not torch.isfinite(out).all():
            fail(f"{name}: bad output {tuple(out.shape)}")
        if err > ROLLOUT_TOL:
            fail(f"{name}: cuda and cpu rollouts differ by {err:.3g}")
        if launches != per_step * 5:
            fail(f"{name}: {launches} kernel launches, expected {per_step * 5}")
        if bias_launches != (launches if fn is generate_rollout_fast else 0):
            fail(f"{name}: {bias_launches} of {launches} launches folded the γ‖β bias")


def phase_throughput(ck, gen, card: str, profile_dir: str | None) -> dict:
    import torch

    from s2p_tpu_torch.gan import generate_rollout_fast

    g = torch.Generator(device="cuda").manual_seed(1)
    states = torch.randn(SEQ_LEN, BATCH, STATE_DIM, device="cuda", generator=g).bfloat16()
    init = (torch.rand(BATCH, 64, 64, 3, device="cuda", generator=g) * 2 - 1).bfloat16()
    for _ in range(2):
        generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()

    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        frames = generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ck.fused_mat_norm.launches
    if ck.fused_mat_norm_bwd.launches:
        fail("the inference path launched the backward kernel")

    fps = BATCH * SEQ_LEN * TIMED_ROLLOUTS / elapsed
    print(f"throughput generate_rollout_fast 64px ngf=64 bf16 batch {BATCH} seq_len "
          f"{SEQ_LEN}: {fps:.1f} frames/sec ({elapsed / TIMED_ROLLOUTS * 1e3:.2f} ms per "
          f"rollout, {TIMED_ROLLOUTS} rollouts) on {card}")
    if frames.shape != (SEQ_LEN, BATCH, 64, 64, 3) or not torch.isfinite(frames).all():
        fail("throughput rollout produced a bad or non-finite output")
    expected = sum(norm_shapes(gen).values()) * SEQ_LEN * TIMED_ROLLOUTS
    if launches != expected:
        fail(f"main path launched fused_mat_norm {launches} times, expected {expected}")
    if profile_dir:
        profile_device(lambda: generate_rollout_fast(gen, init, states), profile_dir,
                       "rollout")
    return dict(launches=launches, fps=fps, frames=frames)


# kinds of device work, by kernel name (first match wins)
KERNEL_KINDS = (
    ("MAT-norm backward kernel", ("fused_mat_norm_bwd",)),
    ("MAT-norm forward kernel", ("fused_mat_norm",)),
    ("cuDNN/cuBLAS convs and GEMMs", ("xmma", "cutlass", "cudnn", "nhwcAddPadding", "gemm",
                                      "nchwToNhwc", "nhwcToNchw", "nvjet")),
    ("random draws", ("distribution_elementwise", "philox")),
    ("reductions", ("reduce_kernel",)),
    ("copies, casts, cat, memsets", ("copy", "memcpy", "memset", "CatArray")),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("pooling and upsampling", ("upsample", "pool")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other elementwise"


def profile_device(fn, out_dir: str | None, name: str) -> dict:
    """Device time by kernel and by kind over one call of ``fn``, and the
    device's idle share of its wall time; written to ``out_dir`` when given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():  # device-side events only: kernels, copies, sets
        if str(evt.device_type).endswith("CUDA") and not getattr(evt, "is_user_annotation",
                                                                  False):
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    kinds: dict = {}
    for n, ms, c in rows:
        k = kinds.setdefault(kernel_kind(n), [0.0, 0])
        k[0] += ms
        k[1] += c
    kinds = dict(sorted(kinds.items(), key=lambda kv: -kv[1][0]))
    summary = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                   device_idle_share=1 - busy_ms / wall_ms, launches=sum(r[2] for r in rows),
                   kinds={k: dict(ms=ms, count=c) for k, (ms, c) in kinds.items()},
                   kernels=[dict(name=n[:120], ms=ms, count=c) for n, ms, c in rows[:40]])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}_trace.json"))
    print(f"profile: one {name} {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"(idle share {summary['device_idle_share']:.3f}), {summary['launches']} launches")
    for k, (ms, c) in kinds.items():
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {c:5d}x  {k}")
    for n, ms, c in rows[:12]:
        print(f"  {ms:9.3f} ms  {c:5d}x  {n[:90]}")
    return summary


def phase_backward(ck, shapes) -> dict:
    import torch
    import torch.nn.functional as F

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def rel_check(got, ref, dtype, label):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        max_err[dtype] = max(max_err[dtype], err)
        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        if not torch.isfinite(got).all() or err > tol * scale:
            fail(f"{label}: max |err| {err:.3g} against max |ref| {scale:.3g}")

    def inputs(batch, size, C, dtype, strided, seed):
        x, g, b = mat_norm_inputs(batch, size, C, dtype, strided, mean=0.5, seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
        _, mean, rstd = ck._plain_forward(x, g, b, 1e-5)
        return x, g, b, dy, mean.float().contiguous(), rstd.float().contiguous()

    def check(batch, size, C, dtype, strided):
        label = f"B={batch} H=W={size} C={C} {dtype} strided={strided}"
        x, g, b, dy, mean, rstd = inputs(batch, size, C, dtype, strided, seed=size * C + 7)
        plan = ck.backward_plan(dy, x, g)
        dx, dg = ck.fused_mat_norm_bwd(dy, x, g, mean, rstd)
        rdx, rdg = ck.fused_mat_norm_bwd_plain(dy, x, g, mean, rstd)
        rel_check(dx, rdx, dtype, f"fused_mat_norm_bwd dx at {label}")
        rel_check(dg, rdg, dtype, f"fused_mat_norm_bwd dgamma at {label}")
        # the whole Function against autograd of the plain forward
        leaves = [t.detach().requires_grad_() for t in (x, g, b)]
        got = torch.autograd.grad(ck.fused_mat_norm(*leaves), leaves, dy)
        ref = torch.autograd.grad(ck.fused_mat_norm_plain(*leaves), leaves, dy)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
            rel_check(a, r, dtype, f"FusedMATNorm {name} vs autograd(plain) at {label}")
        return plan

    before = ck.fused_mat_norm_bwd.launches
    step = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, instance_norm_bwd_ms=0.0,
                fwd_ms=0.0, fwd_wall_ms=0.0, fwd_plain_ms=0.0, fwd_bound_ms=0.0)
    step_f32 = dict(ms=0.0, wall_ms=0.0, bound_ms=0.0, fwd_ms=0.0, fwd_wall_ms=0.0,
                    fwd_bound_ms=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for (size, C), per_step in sorted(shapes.items()):
            for strided in (False, True):
                check(TRAIN_BATCH, size, C, dtype, strided)
            # the module path's layout: γ and β separate conv outputs
            x, g, b, dy, mean, rstd = inputs(TRAIN_BATCH, size, C, dtype, False, seed=size + C)
            plan, fwd_plan = ck.backward_plan(dy, x, g), ck.forward_plan(x, g, b)
            ms = device_ms(lambda: ck.fused_mat_norm_bwd(dy, x, g, mean, rstd))
            wall_ms = time_ms(lambda: ck.fused_mat_norm_bwd(dy, x, g, mean, rstd))
            us = host_us(lambda: ck.fused_mat_norm_bwd(dy, x, g, mean, rstd))
            plain_ms = device_ms(lambda: ck.fused_mat_norm_bwd_plain(dy, x, g, mean, rstd))
            fwd_ms = device_ms(lambda: ck._launch_forward(x, g, b, 1e-5, True))
            fwd_wall_ms = time_ms(lambda: ck._launch_forward(x, g, b, 1e-5, True))
            fwd_plain_ms = device_ms(lambda: ck._plain_forward(x, g, b, 1e-5))
            xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
            y = F.instance_norm(xr, eps=1e-5)
            dyr = dy.permute(0, 3, 1, 2)
            inorm_ms = time_ms(lambda: torch.autograd.grad(y, xr, dyr, retain_graph=True))
            nbytes = x.numel() * x.element_size()
            bound_ms = 5 * nbytes / HBM_BYTES_PER_S * 1e3
            fwd_bound_ms = 4 * nbytes / HBM_BYTES_PER_S * 1e3
            bf16 = dtype == torch.bfloat16
            pr2 = f" (PR 2 {PR2_TRAIN_BWD_MS[(size, C)]:.4f})" if bf16 else ""
            pr2_fwd = f" (PR 2 {PR2_TRAIN_FWD_MS[(size, C)]:.4f})" if bf16 else ""
            print(f"mat_norm_bwd {name} B={TRAIN_BATCH} H=W={size} C={C} x{per_step}/step "
                  f"[{plan_label(plan)}]: kernel {ms:.4f} ms, wall per call {wall_ms:.4f} ms"
                  f"{pr2}, host {us:.1f} us/call  plain {plain_ms:.4f} ms  F.instance_norm "
                  f"backward (wall) {inorm_ms:.4f} ms  bound {bound_ms:.4f} ms | forward "
                  f"[{plan_label(fwd_plan)}] kernel {fwd_ms:.4f} ms, wall per call "
                  f"{fwd_wall_ms:.4f} ms{pr2_fwd}  plain {fwd_plain_ms:.4f} ms  "
                  f"bound {fwd_bound_ms:.4f} ms")
            acc = step if dtype == torch.bfloat16 else step_f32
            for k, v in dict(ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             instance_norm_bwd_ms=inorm_ms, fwd_ms=fwd_ms,
                             fwd_wall_ms=fwd_wall_ms, fwd_plain_ms=fwd_plain_ms,
                             fwd_bound_ms=fwd_bound_ms).items():
                if k in acc:
                    acc[k] += per_step * v
    for path, batch, gen, dtypes, backward in parallel_norm_cases():
        path_shapes = dict(train=shapes, **dryrun_norm_shapes()).get(gen, {})
        for name in dtypes if backward else ():
            plans = {plan_label(check(batch, size, C, getattr(torch, name), strided))
                     for size, C in sorted(path_shapes) for strided in (False, True)}
            print(f"mat_norm_bwd {path} B={batch} {name}: {len(path_shapes)} shapes match "
                  f"plain ({len(plans)} plans: {', '.join(sorted(plans))})")
    scalar_paths = set()
    for dtype in (torch.bfloat16, torch.float32):  # the scalar path: C off the 32 grid
        for batch, size, C in SCALAR_SHAPES:
            for strided in (False, True):
                plan = check(batch, size, C, dtype, strided)
                if plan.vec:
                    fail(f"backward at C={C} took the vector path: {plan_label(plan)}")
                scalar_paths.add((plan.path, plan.cluster > 1))
        batch, size, C = STREAM_SHAPE  # the streaming path
        plan = check(batch, size, C, dtype, strided=True)
        if plan.path != "streaming":
            fail(f"backward at {size}² x {C} did not stream: {plan_label(plan)}")
    if scalar_paths != SCALAR_PATHS:
        fail(f"the scalar backward ran {sorted(scalar_paths)}, not every path and split")
    if ck.fused_mat_norm_bwd.launches <= before:
        fail("fused_mat_norm_bwd's launch counter did not move")
    print(f"mat_norm_bwd max |kernel - plain|: f32 {max_err[torch.float32]:.3g}, bf16 "
          f"{max_err[torch.bfloat16]:.3g} (tolerance: f32 {BWD_F32_TOL}, bf16 "
          f"{BWD_BF16_TOL}, of max |plain|)")
    print("mat_norm per 100px/ngf=64 train step at batch 16 (13 norms each way): bf16 "
          + ", ".join(f"{k} {v:.4f}" for k, v in step.items()) + "; f32 "
          + ", ".join(f"{k} {v:.4f}" for k, v in step_f32.items())
          + "; PR 2 wall_ms " + ", ".join(f"{k} {v:.4f}" for k, v in PR2_STEP_MS.items()
                                      if k.startswith("train")))
    return dict(step, f32=step_f32, max_abs_err=max_err[torch.float32],
                max_abs_err_bf16=max_err[torch.bfloat16])


def phase_ab(ck, other_dir: str, card: str) -> None:
    """This checkout's norm kernels against another checkout's (``--ab
    DIR``, e.g. ``git archive`` of a parent commit unpacked under build/),
    on one card, in turns (other, this, this, other): the MAT-norm forward
    at every norm shape of the serving step (batch 256, 64px, γ/β strided
    halves of γ‖β, bf16 and f32), of the bridge (batch 256, 100px, bf16) and
    of the module path at batch 1 (f32), the forward (saving the statistics)
    and the backward at every shape of the training step (batch 16, 100px,
    γ and β separate, bf16 and f32), and ``spade_norm`` at the 18 shapes of
    a GauGAN pass (batch 32, bf16 and f32). Each kernel runs without a bias
    on both sides; where this checkout's wrappers take ``gb_bias``, the
    fast paths' shapes run again with it on this side (the other side
    without, as a checkout that adds the bias in a pass of its own runs
    them). Each side's kernel ms (device, CUDA graph replay), wall ms per
    call and host µs per call are the means over its two turns."""
    import importlib.util
    import inspect

    import torch
    from portbench import harness
    from portbench.counts import spade as spade_counts

    from s2p_tpu_torch.gan import S2PGenerator

    path = os.path.join(other_dir, "s2p_tpu_torch", "gan", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("other_cuda_kernels", path)
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other  # dataclasses look their module up there
    spec.loader.exec_module(other)
    other.load_library()
    other.load_spade_library()
    ck.load_spade_library()
    sides = dict(other=other, this=ck)
    folds = "gb_bias" in inspect.signature(ck.fused_mat_norm).parameters
    bf16, f32 = torch.bfloat16, torch.float32

    def train_inputs(size, C, dtype):
        x, g, b = mat_norm_inputs(TRAIN_BATCH, size, C, dtype, False, mean=0.5, seed=size + C)
        dy = torch.randn(x.shape, device="cuda").to(dtype)
        _, mean, rstd = ck._plain_forward(x, g, b, 1e-5)
        return x, g, b, dy, mean.float().contiguous(), rstd.float().contiguous()

    def fwd_inputs(batch, size, C, dtype, strided):
        x, g, b = mat_norm_inputs(batch, size, C, dtype, strided, seed=size * C)
        return x, g, b, gb_bias_like(x, seed=C)

    def spade_inputs(h, w, c, dtype):
        g = torch.Generator(device="cuda").manual_seed(c)
        x = (torch.randn(SPADE_BATCH, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        gb = torch.randn(SPADE_BATCH, h, w, 2 * c, generator=g, device="cuda").to(dtype)
        a = torch.rand(c, generator=g, device="cuda") + 0.5
        return x, gb[..., :c], gb[..., c:], a, torch.randn(c, generator=g, device="cuda"), \
            gb_bias_like(x, seed=c)

    plain_fwd = lambda m, t: m.fused_mat_norm(*t[:3])
    plain_spade = lambda m, t: m.spade_norm(*t[:5])
    if folds:  # this side folds the bias, the other side runs without one
        fold_fwd = lambda m, t: (m.fused_mat_norm(*t[:3], gb_bias=t[3]) if m is ck
                                 else m.fused_mat_norm(*t[:3]))
        fold_spade = lambda m, t: (m.spade_norm(*t[:5], gb_bias=t[5]) if m is ck
                                   else m.spade_norm(*t[:5]))
    cases = []  # (path, shape label, launches per step, inputs, call(module, inputs))
    serving = norm_shapes(S2PGenerator(STATE_DIM, seed=0, device="cpu", **FULL))
    training = norm_shapes(S2PGenerator(STATE_DIM, image_size=TRAIN_SIZE, ngf=64, device="cpu"))
    for dtype in (bf16, f32):
        name = str(dtype).split(".")[-1]
        for (size, C), n in sorted(serving.items()):
            make = lambda size=size, C=C, dtype=dtype: fwd_inputs(BATCH, size, C, dtype, True)
            cases.append((f"serving fwd {name}", f"H=W={size} C={C}", n, make, plain_fwd))
            if folds:
                cases.append((f"serving fwd {name}, bias folded here", f"H=W={size} C={C}", n,
                              make, fold_fwd))
        for (size, C), n in sorted(training.items()):
            make = lambda size=size, C=C, dtype=dtype: train_inputs(size, C, dtype)
            cases.append((f"train fwd {name}", f"H=W={size} C={C}", n, make,
                          lambda m, t: m._launch_forward(t[0], t[1], t[2], 1e-5, True)))
            cases.append((f"train bwd {name}", f"H=W={size} C={C}", n, make,
                          lambda m, t: m.fused_mat_norm_bwd(t[3], t[0], t[1], t[4], t[5])))
    for (size, C), n in sorted(training.items()):
        make = lambda size=size, C=C: fwd_inputs(BATCH, size, C, bf16, True)
        cases.append(("bridge fwd bfloat16", f"H=W={size} C={C}", n, make, plain_fwd))
        if folds:
            cases.append(("bridge fwd bfloat16, bias folded here", f"H=W={size} C={C}", n, make,
                          fold_fwd))
    for (size, C), n in sorted(serving.items()):
        make = lambda size=size, C=C: fwd_inputs(1, size, C, f32, False)
        cases.append(("module fwd float32 b1", f"H=W={size} C={C}", n, make, plain_fwd))
    spade_shapes = spade_counts.norm_shapes(harness.load_cell(SPADE_CELL).config["opt"])
    for dtype in (bf16, f32):
        name = str(dtype).split(".")[-1]
        for (h, w, c), n in sorted(spade_shapes.items()):
            make = lambda h=h, w=w, c=c, dtype=dtype: spade_inputs(h, w, c, dtype)
            cases.append((f"spade {name}", f"{h}x{w} C={c}", n, make, plain_spade))
            if folds:
                cases.append((f"spade {name}, bias folded here", f"{h}x{w} C={c}", n, make,
                              fold_spade))

    totals: dict = {}
    with torch.no_grad():
        for path, label, n, make, call in cases:
            t = make()
            got = {side: [] for side in sides}
            for side in ("other", "this", "this", "other"):
                fn = lambda m=sides[side]: call(m, t)
                got[side].append((device_ms(fn), time_ms(fn), host_us(fn)))
            mean = {side: [sum(v) / len(v) for v in zip(*runs)] for side, runs in got.items()}
            for side, (ms, wall, us) in mean.items():
                acc = totals.setdefault((path, side), [0.0, 0.0])
                acc[0] += n * ms
                acc[1] += n * wall
            (o_ms, o_wall, o_us), (t_ms, t_wall, t_us) = mean["other"], mean["this"]
            print(f"ab {path} {label} x{n}/step: kernel other {o_ms:.4f} this {t_ms:.4f} "
                  f"ms ({t_ms / o_ms:.3f}x); wall per call other {o_wall:.4f} this "
                  f"{t_wall:.4f} ms ({t_wall / o_wall:.3f}x); host other {o_us:.1f} this "
                  f"{t_us:.1f} us/call")
            del t
    for path in dict.fromkeys(p for p, *_ in cases):
        (o_ms, o_wall), (t_ms, t_wall) = totals[(path, "other")], totals[(path, "this")]
        print(f"ab {path} per step or pass: kernel other {o_ms:.4f} this {t_ms:.4f} ms "
              f"({t_ms / o_ms:.4f}x); wall other {o_wall:.4f} this {t_wall:.4f} ms; on {card}")

    # the main paths end to end: each side's package in a process of its own
    # (two packages of one name cannot share a process), in turns
    here = os.path.dirname(os.path.abspath(__file__))
    paths = {side: [] for side in sides}
    for side in ("other", "this", "this", "other") * 2:
        root = os.path.abspath(other_dir) if side == "other" else here
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-paths", root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            fail(f"--time-paths {root} exited {run.returncode}:\n{run.stderr[-3000:]}")
        paths[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(f"ab paths {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in paths[side][-1].items()))
    for key in paths["this"][0]:
        o, t = ([r[key] for r in paths[side]] for side in ("other", "this"))
        print(f"ab paths {key}: other {sum(o) / len(o):.4f} (runs {', '.join(f'{v:.4f}' for v in o)})"
              f"; this {sum(t) / len(t):.4f} (runs {', '.join(f'{v:.4f}' for v in t)}); ratio "
              f"{sum(t) / sum(o):.3f}; on {card}")


def time_paths() -> dict:
    """The two main paths end to end, as phases 5 and 8 time them but
    without their checks, for the ``s2p_tpu_torch`` first on ``sys.path``:
    serving frames/sec (bf16, batch 256 × seq_len 8) and ms per
    ``train_step`` (batch 16, bf16 and f32). One side of ``--ab``."""
    import numpy as np
    import torch

    from s2p_tpu_torch.gan import S2PGenerator, generate_rollout_fast

    gen = S2PGenerator(STATE_DIM, seed=0, device="cpu", **FULL).to("cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    states = torch.randn(SEQ_LEN, BATCH, STATE_DIM, device="cuda", generator=g).bfloat16()
    init = (torch.rand(BATCH, 64, 64, 3, device="cuda", generator=g) * 2 - 1).bfloat16()
    for _ in range(2):
        generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        generate_rollout_fast(gen, init, states)
    torch.cuda.synchronize()
    result = dict(frames_per_s=BATCH * SEQ_LEN * TIMED_ROLLOUTS / (time.perf_counter() - t0))
    del gen

    torch.backends.cudnn.allow_tf32 = True  # as phase 8
    batches = list(synthetic_pairs(512, seed=12).batches(TRAIN_BATCH, np.random.RandomState(0)))
    for dtype in (torch.bfloat16, torch.float32):
        trainer = make_trainer("cuda", dtype)
        for b in batches[:2]:
            trainer.train_step(b)
        torch.cuda.synchronize()
        trainer.g_step = trainer.d_step = 0
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        result[f"train_step_ms_{name}"] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        del trainer
    return result


def launch_plan(ck, plan, x, g, b, dy=None, mean=None, rstd=None) -> None:
    """One launch of a MAT-norm kernel with ``plan`` in place of the one
    ``mat_norm_plan`` picks, straight through the library's C entry points
    (the wrappers take no plan): the forward when ``dy`` is None (writing
    the statistics into ``mean``/``rstd`` when given), else the backward."""
    import torch

    lib, (B, H, W, C) = ck.load_library(), x.shape
    dtype, stream = ck._DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream
    out, g_strides = torch.empty_like(x), ck._batch_pixel_strides(g, "gamma")
    if dy is None:
        err = lib.s2p_fused_mat_norm(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), None, out.data_ptr(),
            None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
            B, H * W, C, *g_strides, *ck._batch_pixel_strides(b, "beta"), dtype, 1e-5,
            *ck._plan_args(plan), stream)
    else:
        err = lib.s2p_fused_mat_norm_bwd(
            dy.data_ptr(), x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            out.data_ptr(), torch.empty_like(x).data_ptr(), B, H * W, C, *g_strides, dtype,
            *ck._plan_args(plan), stream)
    if err:
        fail(f"MAT-norm launch with {plan_label(plan)}: cudaError {err}")


def phase_sweep(ck, card: str) -> None:
    """Every plan variant (channel tile × cluster size, resident where the
    slice fits and streaming) of the MAT-norm kernels at every bf16
    main-path shape (serving forward at batch 256 with strided γ/β; training
    forward and backward at batch 16), kernel ms by CUDA-graph replay,
    beside the plan ``mat_norm_plan`` picks."""
    import torch

    from s2p_tpu_torch.gan import S2PGenerator

    bf16 = torch.bfloat16
    gens = dict(serving=(BATCH, S2PGenerator(STATE_DIM, seed=0, device="cpu", **FULL)),
                train=(TRAIN_BATCH, S2PGenerator(STATE_DIM, image_size=TRAIN_SIZE, ngf=64,
                                                 device="cpu")))
    for name, (batch, gen) in gens.items():
        for (size, C), n in sorted(norm_shapes(gen).items()):
            x, g, b = mat_norm_inputs(batch, size, C, bf16, name == "serving", mean=0.5)
            dy = torch.randn(x.shape, device="cuda").to(bf16)
            _, mean, rstd = ck._plain_forward(x, g, b, 1e-5)
            mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
            saved = (mean, rstd) if name == "train" else (None, None)  # as the wrappers do
            calls = dict(forward=lambda p: launch_plan(ck, p, x, g, b, None, *saved),
                         backward=lambda p: launch_plan(ck, p, x, g, b, dy, mean, rstd))
            for direction, call in calls.items():
                if name == "serving" and direction == "backward":
                    continue
                chosen = ck.mat_norm_plan(batch, size * size, C, bf16, direction, True)
                times = {}
                for tile_c in ck.plan_tiles(C, bf16, True):
                    for k in ck.CLUSTER_SIZES:
                        plan = ck.plan_variant(batch, size * size, C, bf16, direction, True,
                                               tile_c, k)
                        times[plan] = device_ms(lambda: call(plan))
                        if plan.path == "resident":  # the same split, streaming
                            stream = ck.plan_variant(batch, size * size, C, bf16, direction,
                                                     True, tile_c, k, resident=False)
                            times[stream] = device_ms(lambda: call(stream))
                best = min(times, key=times.get)
                print(f"sweep {name} {direction} B={batch} H=W={size} C={C} x{n}/step: plan "
                      f"[{plan_label(chosen)}] {times[chosen]:.4f} ms; best [{plan_label(best)}] "
                      f"{times[best]:.4f} ms; all: " + ", ".join(
                          f"{p.tile_c}/{p.cluster}{'' if p.path == 'resident' else 's'} "
                          f"{ms:.4f}" for p, ms in times.items()))
    print(f"sweep on {card}")


def make_trainer(device, compute_dtype, d_lr=D_LR, state_dim=STATE_DIM, dp_group=None):
    import torch

    from s2p_tpu_torch.gan.losses import GANLossConfig
    from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer

    return GANTrainer.create(
        state_dim, image_size=TRAIN_SIZE, generator_kwargs=dict(ngf=64),
        discriminator_kwargs=TRAIN_D, loss_cfg=GANLossConfig(r1_gamma=1.0, r1_interval=16),
        opt_cfg=GANOptConfig(d_lr=d_lr), compute_dtype=compute_dtype, seed=0,
        device=torch.device(device), dp_group=dp_group)


def synthetic_pairs(n: int, seed: int):
    """A seeded stand-in for the cheetah pair dataset: n uint8 100px frames
    and states, episodes of 64 steps."""
    import numpy as np

    from s2p_tpu_torch.data.pair_dataset import S2PPairDataset

    rs = np.random.RandomState(seed)
    timeouts = np.zeros(n, np.float32)
    timeouts[63::64] = 1.0
    return S2PPairDataset.from_dataset(dict(
        image_observations=rs.randint(0, 256, (n, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8),
        next_observations=rs.randn(n, STATE_DIM).astype(np.float32), timeouts=timeouts))


def multi_env_pairs():
    """BASELINE's multi-env configuration as a seeded stand-in: cheetah
    (state 17) and walker (state 24) pair datasets of DP_ROWS uint8 100px
    rows each, concatenated (states zero-padded to 24, env ids 0 and 1)."""
    import numpy as np

    from s2p_tpu_torch.data.pair_dataset import S2PPairDataset

    envs = []
    for seed, state_dim in ((20, STATE_DIM), (21, WALKER_STATE_DIM)):
        rs = np.random.RandomState(seed)
        frames = lambda: rs.randint(0, 256, (DP_ROWS, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8)
        envs.append(S2PPairDataset.from_dataset(dict(
            image_observations=frames(), image_observations_tp1=frames(),
            next_observations=rs.randn(DP_ROWS, state_dim).astype(np.float32),
            timeouts=np.zeros(DP_ROWS, np.float32))))
    return S2PPairDataset.concat(envs)


def check_avg_pool_backward() -> None:
    """D's 3×3/2 average pool (count_include_pad=False) differentiated on the
    card against float64 on the CPU: the port's ``avg_pool_2x``, and
    PyTorch's pool on a channels_last input, which it avoids."""
    import torch
    import torch.nn.functional as F

    from s2p_tpu_torch.gan.discriminator import avg_pool_2x

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 2 * 3 + STATE_DIM, TRAIN_SIZE, TRAIN_SIZE, generator=gen,
                    dtype=torch.float64)
    dy = torch.randn(2, x.shape[1], TRAIN_SIZE // 2, TRAIN_SIZE // 2, generator=gen,
                     dtype=torch.float64)

    def grad(fn, xin, dyin):
        xin = xin.detach().requires_grad_()
        return torch.autograd.grad(fn(xin), xin, dyin)[0].double().cpu()

    pool = lambda t: F.avg_pool2d(t, 3, stride=2, padding=1, count_include_pad=False)
    ref = grad(pool, x, dy)
    x_cl = x.float().cuda().contiguous(memory_format=torch.channels_last)
    errs = [((grad(fn, x_cl, dy.float().cuda()) - ref).norm() / ref.norm()).item()
            for fn in (avg_pool_2x, pool)]
    print(f"avg_pool_2x backward on the card against f64: relative error {errs[0]:.3g}; "
          f"PyTorch's pool on the channels_last input: {errs[1]:.3g}")
    if errs[0] > 1e-5:
        fail(f"avg_pool_2x backward on the card: relative error {errs[0]:.3g}")


def phase_train_parity(ck) -> None:
    import numpy as np
    import torch

    check_avg_pool_backward()
    batch = synthetic_pairs(8, seed=11).eval_batch(0, 2)
    runs = {}
    for name, device, dtype in (("cpu f64", "cpu", torch.float64), ("cpu f32", "cpu", torch.float32),
                                ("cuda f32", "cuda", torch.float32)):
        trainer = make_trainer(device, dtype, d_lr=0.0)
        before = (ck.fused_mat_norm.launches, ck.fused_mat_norm_bwd.launches)
        t0 = time.time()
        metrics = {k: v.item() for k, v in trainer.train_step(batch).items()}
        seconds = time.time() - t0
        launches = (ck.fused_mat_norm.launches - before[0],
                    ck.fused_mat_norm_bwd.launches - before[1])
        grads = {mod: {k: p.grad.double().cpu() for k, p in getattr(trainer, mod).named_parameters()}
                 for mod in ("generator", "discriminator")}
        runs[name] = (metrics, grads)
        print(f"train parity {name}: one step {seconds:.1f} s, " + ", ".join(
            f"{k} {v:.8g}" for k, v in sorted(metrics.items())))
        del trainer
    (ref_m, ref_g), (cpu_m, cpu_g), (got_m, got_g) = runs.values()
    if sorted(got_m) != sorted(ref_m) or not ref_m["d_r1"] > 0:
        fail(f"train step metrics {sorted(got_m)} (d_r1 {ref_m.get('d_r1')})")
    # the card's f32 step must be as close to the f64 step as the CPU's f32
    # step is: within PARITY_SLACK times the CPU's error, or the floor
    for k, r in ref_m.items():
        e_cpu, e_got = (abs(m[k] - r) / abs(r) for m in (cpu_m, got_m))
        if not np.isfinite(got_m[k]) or e_got > max(PARITY_SLACK * e_cpu, METRIC_FLOOR):
            fail(f"train step metric {k}: cuda {got_m[k]}, cpu {cpu_m[k]}, f64 {r}")
    for mod, ref in ref_g.items():
        scale = max(g.abs().max().item() for g in ref.values())

        def worst(grads):
            return max(((grads[k] - r).abs().max().item() / scale, k) for k, r in ref.items())

        (e_cpu, k_cpu), (e_got, k_got) = worst(cpu_g[mod]), worst(got_g[mod])
        print(f"train parity {mod} gradients against f64, of the largest |gradient| "
              f"{scale:.3g}: cuda {e_got:.3g} ({k_got}), cpu {e_cpu:.3g} ({k_cpu})")
        if e_got > max(PARITY_SLACK * e_cpu, GRAD_FLOOR):
            fail(f"{mod} gradients of the card's train step: {e_got:.3g} from f64 "
                 f"(the CPU's f32 step: {e_cpu:.3g})")
    zero = [k for k, g in got_g["generator"].items() if not g.abs().max().item() > 0]
    if zero:
        fail(f"G parameters with a zero gradient on the card: {zero}")
    print(f"train parity: the card's step launched fused_mat_norm {launches[0]}x and "
          f"fused_mat_norm_bwd {launches[1]}x (expected 26 and 13); every G parameter has a "
          f"non-zero gradient")
    if launches != (26, 13):
        fail(f"train step launched {launches} forward/backward MAT-norm kernels, expected (26, 13)")


def phase_train_throughput(ck, card: str, profile_dir: str | None) -> dict:
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, for the f32 run
    ds = synthetic_pairs(512, seed=12)
    batches = list(ds.batches(TRAIN_BATCH, np.random.RandomState(0)))
    data = dict(prev_image=torch.as_tensor(ds.prev_images, device="cuda"),
                state=torch.as_tensor(ds.states, device="cuda"),
                target_image=torch.as_tensor(ds.target_images, device="cuda"))
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        trainer = make_trainer("cuda", dtype)
        for b in batches[:2]:  # warm-up
            trainer.train_step(b)
        torch.cuda.synchronize()
        trainer.g_step = trainer.d_step = 0  # so R1 fires at D steps 0 and 16 in the window
        if dtype == torch.bfloat16:
            ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
        with HostWindow() as window:
            metrics = [trainer.train_step(batches[i % len(batches)]) for i in range(TIMED_STEPS)]
        elapsed = window.wall
        sps = TIMED_STEPS / elapsed
        if dtype == torch.bfloat16:
            launches = dict(fwd=ck.fused_mat_norm.launches, bwd=ck.fused_mat_norm_bwd.launches,
                            steps_per_s=sps)
        print(f"train throughput {name}: {sps:.3f} steps/sec, {sps * TRAIN_BATCH:.1f} "
              f"images/sec ({elapsed / TIMED_STEPS * 1e3:.2f} ms per train_step, "
              f"{TIMED_STEPS} steps, batch {TRAIN_BATCH}, 100px, ngf=64, ndf=64, VGG on, R1 "
              f"every 16 D steps) on {card}; host: {window}")
        values = torch.stack([v for m in metrics for v in m.values()])
        if not torch.isfinite(values).all():
            fail(f"train_step {name}: non-finite losses")
        gen = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        many = trainer.train_many(data, MANY_STEPS, TRAIN_BATCH, gen)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        print(f"train throughput {name} train_many: {MANY_STEPS / elapsed:.3f} steps/sec, "
              f"{MANY_STEPS * TRAIN_BATCH / elapsed:.1f} images/sec ({MANY_STEPS} steps, "
              f"dataset staged on the card) on {card}")
        if not all(torch.isfinite(v) for v in many.values()):
            fail(f"train_many {name}: non-finite losses")
        if profile_dir and dtype == torch.bfloat16:
            trainer.d_step = 1  # a step without R1, the common case
            profile_device(lambda: trainer.train_step(batches[0]), profile_dir, "train_step")
        del trainer
    expected = dict(fwd=26 * TIMED_STEPS, bwd=13 * TIMED_STEPS)
    counted = dict(fwd=launches["fwd"], bwd=launches["bwd"])
    print(f"train main path launches (bf16 window): {counted} (expected {expected})")
    if counted != expected:
        fail(f"training launched the MAT-norm kernels {launches}, expected {expected}")
    return launches


def state_dataset(n_episodes: int, episode_len: int, seed: int) -> dict:
    """A seeded state-only cheetah dataset (obs 17, act 6; timeouts on each
    episode's last row) in the image-RL schema without images. The next
    observation and the reward follow (obs, act) through a fixed seeded
    linear map plus noise, so the ensemble has a relation to learn."""
    import numpy as np

    rs = np.random.RandomState(seed)
    n = n_episodes * episode_len
    obs = rs.randn(n, STATE_DIM).astype(np.float32)
    act = rs.uniform(-1, 1, (n, ACT_DIM)).astype(np.float32)
    dyn = (0.3 * rs.randn(STATE_DIM + ACT_DIM, STATE_DIM + 1)).astype(np.float32)
    y = np.concatenate([obs, act], axis=1) @ dyn
    y += (0.1 * rs.randn(n, STATE_DIM + 1)).astype(np.float32)
    timeouts = np.zeros(n, np.float32)
    timeouts[episode_len - 1::episode_len] = 1.0
    return dict(observations=obs, actions=act, rewards=y[:, -1].copy(),
                next_observations=obs + y[:, :-1], terminals=np.zeros(n, np.float32),
                timeouts=timeouts)


def rel_err(got, ref) -> float:
    """max |got − ref| over max |ref| (numpy or torch)."""
    import numpy as np

    got, ref = (np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float64)
                for v in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def phase_world_model() -> None:
    import numpy as np
    import torch

    from s2p_tpu_torch.cli.state_transition_rollout import ensemble_training_arrays
    from s2p_tpu_torch.world_model import (
        EnsembleTransition,
        compute_normalization,
        generate_augmented_dataset,
        generate_multistep_dataset,
        make_ensemble_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = state_dataset(4, WM_ROWS // 4, seed=21)
    norm = compute_normalization(ds)
    low, high = np.full(ACT_DIM, -1.0), np.full(ACT_DIM, 1.0)
    cpu = EnsembleTransition(STATE_DIM, ACT_DIM, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    predicted = {"next_observations", "rewards", "disagreement_uncertainty",
                 "aleatoric_uncertainty"}
    for name, fn, kw, floats in (
            ("generate_augmented_dataset", generate_augmented_dataset, dict(num_sequences=8),
             predicted),
            ("generate_multistep_dataset", generate_multistep_dataset, dict(horizon=5),
             predicted | {"observations"})):
        t0 = time.time()
        ref = fn(ds, cpu, norm, low, high, seed=3, **kw)
        cpu_s = time.time() - t0
        got = fn(ds, gpu, norm, low, high, seed=3, **kw)
        if sorted(got) != sorted(ref):
            fail(f"{name}: keys {sorted(got)} on the card, {sorted(ref)} on the CPU")
        worst = {}
        for k, r in ref.items():
            g = got[k]
            if g.shape != r.shape or g.dtype != r.dtype:
                fail(f"{name} {k}: {g.dtype} {g.shape} on the card, {r.dtype} {r.shape} on the CPU")
            if k in floats:
                worst[k] = rel_err(g, r)
                if not np.isfinite(g).all() or worst[k] > WM_TOL:
                    fail(f"{name} {k}: card vs CPU {worst[k]:.3g} of max |cpu| (tolerance "
                         f"{WM_TOL})")
            elif not np.array_equal(g, r):
                fail(f"{name} {k}: the card's and the CPU's are not bit-equal")
        print(f"world model {name} on {WM_ROWS} rows, f32: " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + f" of max |cpu| (tolerance {WM_TOL}); "
            f"every other column bit-equal; cpu {cpu_s:.1f} s")

    x, y = ensemble_training_arrays(ds, norm)
    idx = np.random.RandomState(5).randint(0, len(x), 256)
    steps = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        model = copy.deepcopy(model)
        dev = next(model.parameters()).device
        loss = make_ensemble_train_step(model)(torch.from_numpy(x[idx]).to(dev),
                                               torch.from_numpy(y[idx]).to(dev))
        steps[name] = (loss.item(), {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    (loss_ref, g_ref), (loss, grads) = steps["cpu"], steps["cuda"]
    scale = max(g.abs().max().item() for g in g_ref.values())
    g_err = max((grads[k] - g).abs().max().item() / scale for k, g in g_ref.items())
    l_err = abs(loss - loss_ref) / abs(loss_ref)
    print(f"world model Adam NLL step, batch 256: loss cuda {loss:.8g} cpu {loss_ref:.8g} "
          f"(relative {l_err:.3g}); gradients {g_err:.3g} of the largest |gradient| {scale:.3g} "
          f"(tolerance {WM_TOL})")
    if l_err > WM_TOL or g_err > WM_TOL:
        fail(f"world model train step: loss {l_err:.3g}, gradients {g_err:.3g} from the CPU's")


def phase_bridge_parity(ck, gen_cpu, gen_gpu) -> None:
    import numpy as np
    import torch

    from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset

    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(31)
    ds = dict(next_observations=rs.randn(8, STATE_DIM).astype(np.float32),
              image_observations=rs.randint(0, 256, (8, BRIDGE_SIZE, BRIDGE_SIZE, 3),
                                            dtype=np.uint8))
    t0 = time.time()
    ref = generate_images_for_dataset(ds, gen_cpu, batch_size=8)
    cpu_s = time.time() - t0
    before = ck.fused_mat_norm.launches
    got = generate_images_for_dataset(ds, gen_gpu, batch_size=8)
    launches = ck.fused_mat_norm.launches - before
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    share = float((diff > 0).mean())
    print(f"bridge parity generate_images_for_dataset 100px ngf=64, 8 rows f32: max |cuda - cpu| "
          f"{diff.max()} uint8 steps, {100 * share:.3f}% of values differ (tolerance "
          f"{BRIDGE_MAX_DIFF}, {100 * BRIDGE_DIFF_SHARE}%), fused_mat_norm launches {launches}, "
          f"cpu {cpu_s:.1f} s")
    if got.shape != (8, BRIDGE_SIZE, BRIDGE_SIZE, 3) or got.dtype != np.uint8:
        fail(f"bridge: {got.dtype} {got.shape}")
    if diff.max() > BRIDGE_MAX_DIFF or share > BRIDGE_DIFF_SHARE:
        fail(f"bridge frames: card and CPU differ by up to {diff.max()} in {share:.3%}")
    if launches != sum(norm_shapes(gen_gpu).values()):
        fail(f"bridge: {launches} forward launches for one batch, expected 13")


def phase_pipeline(ck, gen, card: str, profile_dir: str | None) -> tuple:
    """Returns the forward launches, and the first ``SLAC_GEN_ROWS`` rows
    of the augmented dataset with the real frames under them and the frames
    the bridge rendered for them (phase 15's generated data)."""
    import numpy as np
    import torch

    from s2p_tpu_torch.cli.generate_images import generate_images_for_dataset
    from s2p_tpu_torch.cli.state_transition_rollout import (
        ensemble_training_arrays,
        train_ensemble,
    )
    from s2p_tpu_torch.world_model import (
        EnsembleTransition,
        compute_normalization,
        generate_augmented_dataset,
        make_ensemble_train_step,
    )

    t0 = time.time()
    ds = state_dataset(PIPE_EPISODES, PIPE_EPISODE_LEN, seed=41)
    frames_in = np.random.RandomState(42).randint(
        0, 256, (PIPE_FRAMES, BRIDGE_SIZE, BRIDGE_SIZE, 3), dtype=np.uint8)
    n = len(ds["observations"])
    print(f"pipeline: {n} state rows and {PIPE_FRAMES} 100px frames made in "
          f"{time.time() - t0:.1f} s")
    warm = dict(next_observations=ds["next_observations"][:BATCH],
                image_observations=frames_in[:BATCH])
    generate_images_for_dataset(warm, gen, BATCH, bf16=True)  # cuDNN's first calls
    torch.cuda.synchronize()

    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    norm = compute_normalization(ds)
    model = EnsembleTransition(STATE_DIM, ACT_DIM, seed=0, device="cuda")
    history = train_ensemble(model, ds, norm, PIPE_TRAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aug = generate_augmented_dataset(ds, model, norm, np.full(ACT_DIM, -1.0),
                                     np.full(ACT_DIM, 1.0), seed=0)
    aug_s = time.perf_counter() - t0
    bridge = dict(next_observations=aug["next_observations"][:PIPE_FRAMES],
                  image_observations=frames_in)
    t0 = time.perf_counter()
    frames = generate_images_for_dataset(bridge, gen, BATCH, bf16=True)
    gen_s = time.perf_counter() - t0
    launches, bwd = ck.fused_mat_norm.launches, ck.fused_mat_norm_bwd.launches

    print(f"pipeline ensemble (E 7, hidden 256 x 3, f32): {PIPE_TRAIN_STEPS} Adam steps at batch "
          f"256 in {train_s:.2f} s, {PIPE_TRAIN_STEPS / train_s:.1f} steps/sec; nll "
          + ", ".join(f"step {i} {v:.4f}" for i, v in history) + f" on {card}")
    print(f"pipeline generate_augmented_dataset: {n} rows in {aug_s:.2f} s, "
          f"{n / aug_s:.1f} augmented transitions/sec on {card}")
    print(f"pipeline generate_images_for_dataset 100px ngf=64 bf16 batch {BATCH}: {PIPE_FRAMES} "
          f"frames in {gen_s:.2f} s, {PIPE_FRAMES / gen_s:.1f} generated frames/sec; "
          f"fused_mat_norm launches {launches} (expected {PIPE_FRAMES // BATCH} batches x 13) "
          f"on {card}")
    for k in ("next_observations", "rewards", "disagreement_uncertainty", "aleatoric_uncertainty"):
        if not np.isfinite(aug[k]).all():
            fail(f"pipeline: non-finite {k}")
    if aug["slac_observation_indices"].shape != (n, 9) or aug["actions"].shape != (n, ACT_DIM):
        fail("pipeline: augmented columns of the wrong shape")
    if frames.dtype != np.uint8 or frames.shape != frames_in.shape:
        fail(f"pipeline frames: {frames.dtype} {frames.shape}")
    if not history[-1][1] < history[0][1]:
        fail(f"pipeline: the ensemble's NLL did not fall ({history})")
    expected = PIPE_FRAMES // BATCH * sum(norm_shapes(gen).values())
    if launches != expected or bwd:
        fail(f"pipeline launched fused_mat_norm {launches} times (expected {expected}) and "
             f"its backward {bwd} times")
    if profile_dir:
        sub = {k: v[:4 * BATCH] for k, v in bridge.items()}
        profile_device(lambda: generate_images_for_dataset(sub, gen, BATCH, bf16=True),
                       profile_dir, "bridge")
        # 20 training steps as train_ensemble takes them: indices up, rows gathered
        x, y = (torch.from_numpy(a).cuda() for a in ensemble_training_arrays(ds, norm))
        step, rs = make_ensemble_train_step(model), np.random.RandomState(1)

        def steps():
            for _ in range(20):
                idx = torch.from_numpy(rs.randint(0, n, 256)).to("cuda")
                step(x[idx], y[idx])

        profile_device(steps, profile_dir, "ensemble_20_steps")
    rows = SLAC_GEN_ROWS
    generated = {k: v[:rows] for k, v in aug.items()}
    generated["image_observations"] = frames_in[:rows]
    return launches, generated, frames[:rows]


def phase_gb_int8(ck, gen, card: str, serving_fps: float, profile_dir: str | None) -> int:
    import torch

    from s2p_tpu_torch.gan import generate_rollout_fast
    from s2p_tpu_torch.gan.fast_inference import _conv_gb_int8, _quantize_gb_kernel

    # the int8 weights and product on the card against the CPU (int32 sums are
    # exact): the serving shape, and 16 (padded) and 49 rows at batch 1
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(512, 128, 3, 3, device="cuda", generator=g) / 34.0
    bias = 0.1 * torch.randn(512, device="cuda", generator=g)
    q, q_cpu = _quantize_gb_kernel(w), _quantize_gb_kernel(w.cpu())
    if not all(torch.equal(q[k].cpu(), q_cpu[k]) for k in q):
        fail("gb_int8: the weights quantized on the card differ from the CPU's")
    for batch, size in ((BATCH, 16), (1, 4), (1, 7)):
        h = torch.randn(batch, 128, size, size, device="cuda", generator=g).relu()
        h = h.contiguous(memory_format=torch.channels_last)
        err = rel_err(_conv_gb_int8(h, q, bias), _conv_gb_int8(h.cpu(), q_cpu, bias.cpu()))
        print(f"gb_int8 conv B={batch} {size}x{size} 128 -> 512 on the card vs the CPU: "
              f"{err:.3g} of max |cpu| (tolerance 1e-6)")
        if err > 1e-6:
            fail(f"gb_int8 conv at B={batch} {size}x{size}: card and CPU differ by {err:.3g}")

    r = torch.Generator(device="cuda").manual_seed(1)  # phase 5's inputs
    states = torch.randn(SEQ_LEN, BATCH, STATE_DIM, device="cuda", generator=r).bfloat16()
    init = (torch.rand(BATCH, 64, 64, 3, device="cuda", generator=r) * 2 - 1).bfloat16()
    ref_frames = generate_rollout_fast(gen, init, states).float()
    generate_rollout_fast(gen, init, states, gb_int8=True)
    torch.cuda.synchronize()
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(GB_INT8_ROLLOUTS):
        frames = generate_rollout_fast(gen, init, states, gb_int8=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ck.fused_mat_norm.launches
    fps = BATCH * SEQ_LEN * GB_INT8_ROLLOUTS / elapsed
    mse = (frames.float() - ref_frames).square().mean().item()
    psnr = 10 * math.log10(4.0 / max(mse, 1e-12))
    print(f"gb_int8 generate_rollout_fast 64px ngf=64 bf16 batch {BATCH} seq_len {SEQ_LEN}: "
          f"{fps:.1f} frames/sec ({elapsed / GB_INT8_ROLLOUTS * 1e3:.2f} ms per rollout, "
          f"{GB_INT8_ROLLOUTS} rollouts; the float path in phase 5: {serving_fps:.1f}); PSNR "
          f"{psnr:.2f} dB against the float path (bar {GB_INT8_PSNR}) on {card}")
    if frames.shape != (SEQ_LEN, BATCH, 64, 64, 3) or not torch.isfinite(frames).all():
        fail("gb_int8 rollout produced a bad or non-finite output")
    if psnr < GB_INT8_PSNR:
        fail(f"gb_int8 rollout at {psnr:.2f} dB against the float path")
    expected = sum(norm_shapes(gen).values()) * SEQ_LEN * GB_INT8_ROLLOUTS
    if launches != expected or ck.fused_mat_norm_bwd.launches:
        fail(f"gb_int8 path launched fused_mat_norm {launches} times, expected {expected}")
    if profile_dir:
        profile_device(lambda: generate_rollout_fast(gen, init, states, gb_int8=True),
                       profile_dir, "rollout_gb_int8")
    return launches


def slac_dataset(n_episodes: int, episode_len: int, seed: int) -> dict:
    """A seeded real 100px image-RL dataset in the schema ``ingest_real``
    reads: uint8 frames, the next row's frame as ``image_observations_tp1``
    (the last row repeats its own), uniform actions, normal rewards, a
    timeout on each episode's last row."""
    import numpy as np

    rs = np.random.RandomState(seed)
    n = n_episodes * episode_len
    imgs = rs.randint(0, 256, (n, BRIDGE_SIZE, BRIDGE_SIZE, 3), dtype=np.uint8)
    timeouts = np.zeros(n, np.float32)
    timeouts[episode_len - 1::episode_len] = 1.0
    return dict(image_observations=imgs,
                image_observations_tp1=np.concatenate([imgs[1:], imgs[-1:]]),
                actions=rs.uniform(-1, 1, (n, ACT_DIM)).astype(np.float32),
                rewards=rs.randn(n).astype(np.float32), timeouts=timeouts)


def make_slac(device, batch_size_latent: int, buffer_size: int, dp_group=None):
    from s2p_tpu_torch.slac import SlacAlgorithm

    return SlacAlgorithm(ACT_DIM, buffer_size=buffer_size, batch_size_latent=batch_size_latent,
                         seed=0, device=device, dp_group=dp_group, **SLAC_KW)


def slac_rl_nets(slac, dtype=None):
    """The shipped policy over feature_action and critic over z (1024 x 2),
    seeded weights (in ``dtype`` when given)."""
    from s2p_tpu_torch.rl import CriticSLAC, TanhGaussianPolicy

    policy = TanhGaussianPolicy(slac.feature_action_dim, IQL_HIDDEN, ACT_DIM, seed=1)
    critic = CriticSLAC(slac.z_dim, ACT_DIM, IQL_HIDDEN, seed=2)
    if dtype is not None:
        policy, critic = policy.to(dtype), critic.to(dtype)
    return policy, critic


def make_iql(slac, dtype=None):
    """The shipped IQL trainer over ``slac`` (in its data-parallel group)."""
    from s2p_tpu_torch.rl import IQLTrainer

    return IQLTrainer(*slac_rl_nets(slac, dtype), slac_algo=slac, seed=0, device=slac.device,
                      dp_group=slac.dp_group, **IQL_KW)


def make_cql(slac, dtype=None, **kw):
    """The shipped CQL trainer over ``slac`` (``kw`` over ``CQL_KW``; in its
    data-parallel group)."""
    from s2p_tpu_torch.rl import CQLTrainer

    return CQLTrainer(*slac_rl_nets(slac, dtype), slac_algo=slac, seed=0, device=slac.device,
                      dp_group=slac.dp_group, **dict(CQL_KW, **kw))


def fill_rl_buffer(slac, pretrain: dict, generated: dict, generated_frames) -> tuple:
    """Phase 14's latent, and one buffer as ``run_{iql,cql}_image.sh`` fill
    it: phase 14's first real rows, then phase 11's augmented rows with the
    frames its bridge rendered (the aleatoric penalty); returns the slots
    (real, generated)."""
    slac.latent.load_state_dict(pretrain["latent"])
    n_real = slac.buffer.ingest_real(pretrain["real"])
    slac.buffer.mark_real()
    n_gen = slac.buffer.ingest_generated(generated, UNCERTAINTY_TYPE, UNCERTAINTY_LAMBDA,
                                         generated_frames=generated_frames)
    return n_real, n_gen


def _f64(named) -> dict:
    return {k: t.detach().double().cpu() for k, t in named}


def hold_to_f64(label: str, runs: dict, kind: str, lr: float = 0.0) -> None:
    """The card's f32 result against the CPU's f64 one, as far as the CPU's
    f32 result is (PARITY_SLACK times, or the floor). ``runs`` maps "cpu
    f64", "cpu f32", "cuda f32" to dicts of floats (``kind`` "metric":
    relative error), of gradient tensors ("grad": of the largest |gradient|)
    or of parameters after one Adam step ("param": the share of entries off
    by more than 1e-6, none by more than 2·lr + 1e-6, since Adam's first
    step is lr·g/(|g| + ε) and a gradient within f32 noise of zero may move
    its weight by anything from −lr to lr)."""
    import torch

    ref, cpu, got = runs["cpu f64"], runs["cpu f32"], runs["cuda f32"]
    if sorted(got) != sorted(ref):
        fail(f"{label}: keys {sorted(got)} on the card, {sorted(ref)} on the CPU")

    def err(run):
        if kind == "metric":
            return max((abs(run[k] - r) / max(abs(r), 1e-30), k) for k, r in ref.items())
        if kind == "grad":
            scale = max(g.abs().max().item() for g in ref.values())
            return max(((run[k] - r).abs().max().item() / scale, k) for k, r in ref.items())
        diffs = [(run[k] - r).abs().flatten() for k, r in ref.items()]
        d = torch.cat(diffs)
        if d.max().item() > 2 * lr + 1e-6:
            fail(f"{label}: an entry moved {d.max().item():.3g} from the f64 step (lr {lr})")
        return (d > 1e-6).double().mean().item(), "share of entries"

    (e_cpu, k_cpu), (e_got, k_got) = err(cpu), err(got)
    floor = dict(metric=METRIC_FLOOR, grad=GRAD_FLOOR, param=1e-4)[kind]
    print(f"parity {label} against f64: cuda {e_got:.3g} ({k_got}), cpu f32 {e_cpu:.3g} "
          f"({k_cpu}); limit max({PARITY_SLACK} x cpu, {floor})")
    if not e_got <= max(PARITY_SLACK * e_cpu, floor):
        fail(f"{label}: the card's f32 step is {e_got:.3g} from f64 ({k_got}), the CPU's "
             f"{e_cpu:.3g}")


def phase_slac_parity() -> None:
    """One ELBO step and one IQL + SLAC ``train()`` at full width, on the
    card in f32 and on the CPU in f32 and f64, from the same seeded weights,
    windows and posterior noise."""
    import torch

    from s2p_tpu_torch.data.replay import window_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = slac_dataset(1, 40, seed=51)
    B, S = SLAC_PARITY_BATCH, SLAC_KW["num_sequences"]
    gen = torch.Generator().manual_seed(52)

    def noise():
        return [torch.randn(B, d, generator=gen, dtype=torch.float64)
                for _ in range(S + 1) for d in (SLAC_KW["z1_dim"], SLAC_KW["z2_dim"])]

    elbo_noise, prepare_noise, latent_noise = noise(), noise(), noise()
    idx_elbo, idx_batch, idx_latent = (torch.tensor(v) for v in
                                       ([0, 7, 19, 30], [3, 11, 20, 28], [5, 9, 14, 31]))
    names = ("loss_kld", "loss_image", "loss_reward")
    out = {}
    for name, device, dtype in (("cpu f64", "cpu", torch.float64), ("cpu f32", "cpu", torch.float32),
                                ("cuda f32", "cuda", torch.float32)):
        cast = lambda ts: [t.to(device, dtype) for t in ts]  # noqa: E731
        t0 = time.time()
        slac = make_slac(device, B, 64)
        slac.latent.to(dtype)
        slac.buffer.ingest_real(ds)
        losses = slac.latent_step(*slac.buffer.gather(idx_elbo), cast(elbo_noise))
        r = dict(elbo={k: v.item() for k, v in zip(names, losses)},
                 elbo_grad=_f64((k, p.grad) for k, p in slac.latent.named_parameters()))
        slac = make_slac(device, B, 64)
        slac.latent.to(dtype)
        slac.buffer.ingest_real(ds)
        tr = make_iql(slac, dtype)
        batch = window_batch(*slac.buffer.gather(idx_batch))
        metrics = tr.train(batch, prepare_noise=cast(prepare_noise),
                           latent_draws=(idx_latent, cast(latent_noise)))
        r["iql"] = {k: v.item() for k, v in metrics.items()}
        for mod, net in (("policy", tr.policy), ("critic", tr.critic), ("latent", slac.latent)):
            r[f"{mod}_grad"] = _f64((k, p.grad) for k, p in net.named_parameters())
            r[f"{mod}_param"] = _f64(net.named_parameters())
        r["target_param"] = _f64(tr.target_q.named_parameters())
        out[name] = r
        print(f"slac parity {name}: ELBO step and IQL + SLAC step in {time.time() - t0:.1f} s; "
              + ", ".join(f"{k} {v:.8g}" for k, v in sorted(r["elbo"].items())))
    pick = lambda key: {n: r[key] for n, r in out.items()}  # noqa: E731
    hold_to_f64("ELBO terms", pick("elbo"), "metric")
    hold_to_f64("ELBO gradients", pick("elbo_grad"), "grad")
    hold_to_f64("IQL + SLAC metrics", pick("iql"), "metric")
    lrs = dict(policy=IQL_KW["policy_lr"], critic=IQL_KW["qf_lr"], latent=SLAC_KW["lr_latent"],
               target=IQL_KW["qf_lr"])
    for mod in ("policy", "critic", "latent"):
        hold_to_f64(f"IQL + SLAC {mod} gradients", pick(f"{mod}_grad"), "grad")
    for mod in ("policy", "critic", "target", "latent"):
        hold_to_f64(f"IQL + SLAC {mod} parameters after the step", pick(f"{mod}_param"), "param",
                    lr=lrs[mod])


def phase_slac_pretrain(ck, card: str, profile_dir: str | None) -> dict:
    import numpy as np
    import torch

    from s2p_tpu_torch.slac import pretrain_latent

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 8
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    ds = slac_dataset(SLAC_EPISODES, SLAC_EPISODE_LEN, seed=61)
    algo = make_slac("cuda", SLAC_BATCH, len(ds["actions"]))
    added = algo.buffer.ingest_real(ds)
    algo.buffer.device_state()
    print(f"slac pretrain: {len(ds['actions'])} real 100px rows ({SLAC_EPISODES} episodes), "
          f"{added} windows, made, ingested and uploaded in {time.time() - t0:.1f} s")
    algo.update_latent_many(3)  # cuDNN's first calls
    torch.cuda.synchronize()

    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    first = algo.update_latent()
    last = pretrain_latent(algo, num_steps=PRETRAIN_STEPS - 1, log_every=100, scan_chunk=100,
                           log_fn=lambda s: print(f"slac pretrain {s}"))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(launches=ck.fused_mat_norm.launches, bwd_launches=ck.fused_mat_norm_bwd.launches)
    first = {k: float(v) for k, v in first.items()}
    sps = PRETRAIN_STEPS / elapsed
    print(f"slac pretrain ELBO (100px, batch {SLAC_BATCH} x 9 frames, feature 256, z 32 + 256, "
          f"f32 with cuDNN TF32): {PRETRAIN_STEPS} steps in {elapsed:.2f} s, {sps:.2f} steps/sec "
          f"on {card}; first step " + ", ".join(f"{k} {v:.2f}" for k, v in first.items())
          + "; last step " + ", ".join(f"{k} {v:.2f}" for k, v in last.items()))
    if not all(np.isfinite(v) for v in list(first.values()) + list(last.values())):
        fail("slac pretrain: non-finite losses")
    if not sum(last.values()) < sum(first.values()):
        fail(f"slac pretrain: the ELBO did not fall ({first} -> {last})")
    summary = profile_device(algo.update_latent, profile_dir, "elbo_step")
    real = {k: v[:SLAC_REAL_ROWS] for k, v in ds.items()}
    return dict(launches, sps=sps, step_launches=summary["launches"],
                idle=summary["device_idle_share"], latent=algo.latent.state_dict(), real=real)


def phase_slac_rl(ck, card: str, name: str, make_trainer, steps: int, pretrain: dict,
                  generated: dict, generated_frames, profile_dir: str | None) -> dict:
    """``steps`` timed ``train_many`` steps of ``make_trainer(slac)`` (name
    "iql" or "cql") over one buffer as ``run_{name}_image.sh`` fills it,
    from phase 14's latent."""
    import torch

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 14
    torch.backends.cuda.matmul.allow_tf32 = False
    slac = make_slac("cuda", SLAC_BATCH, int(1.05e5))  # the finetune CLI's buffer
    n_real, n_gen = fill_rl_buffer(slac, pretrain, generated, generated_frames)
    print(f"{name} buffer: {n_real} real windows ({SLAC_REAL_ROWS} rows) + {n_gen} generated "
          f"({SLAC_GEN_ROWS} rows of phase 11's augmented dataset, frames from its bridge, "
          f"{UNCERTAINTY_TYPE} penalty lambda {UNCERTAINTY_LAMBDA}), one buffer")
    tr = make_trainer(slac)
    tr.train_many(2, IQL_BATCH)  # cuDNN's first calls
    torch.cuda.synchronize()
    nets = dict(policy=tr.policy.fc0.weight, critic=tr.critic.qf1.fc0.weight,
                latent=slac.latent.encoder.net[0].weight)
    before = {k: v.detach().clone() for k, v in nets.items()}

    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    metrics = tr.train_many(steps, IQL_BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(launches=ck.fused_mat_norm.launches, bwd_launches=ck.fused_mat_norm_bwd.launches)
    sps = steps / elapsed
    print(f"{name} + slac train_many (batch {IQL_BATCH}, policy over feature_action 2090 -> "
          f"1024 x 2, critic over z 288, joint latent step at batch {SLAC_BATCH}): {steps} "
          f"steps in {elapsed:.2f} s, {sps:.2f} steps/sec on {card}; last step "
          + ", ".join(f"{k} {float(v):.4g}" for k, v in metrics.items()))
    if not all(torch.isfinite(v) for v in metrics.values()):
        fail(f"{name} + slac: non-finite metrics")
    still = [k for k, v in nets.items() if torch.equal(v, before[k])]
    if still:
        fail(f"{name} + slac: {still} did not move")
    if launches["launches"] or launches["bwd_launches"]:
        fail(f"{name} + slac launched the MAT-norm kernels: {launches}")
    summary = profile_device(lambda: tr.train_many(1, IQL_BATCH), profile_dir,
                             f"{name}_slac_step")
    return dict(launches, sps=sps, step_launches=summary["launches"],
                idle=summary["device_idle_share"])


def phase_cql_sac_parity() -> None:
    """One full-width CQL + SLAC ``train()`` per ``CQL_PARITY_CASES`` and
    one state SAC step, on the card in f32 and on the CPU in f32 and f64,
    from the same seeded weights, windows and draws."""
    import numpy as np
    import torch

    from s2p_tpu_torch.data.replay import window_batch
    from s2p_tpu_torch.rl import CriticSLAC, SACTrainer, TanhGaussianPolicy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = slac_dataset(1, 40, seed=71)
    B, S, N, A = SLAC_PARITY_BATCH, SLAC_KW["num_sequences"], CQL_KW["num_random"], ACT_DIM
    gen = torch.Generator().manual_seed(72)
    randn = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64)  # noqa: E731

    def noise():
        return [randn(B, d) for _ in range(S + 1) for d in (SLAC_KW["z1_dim"], SLAC_KW["z2_dim"])]

    idx_batch, idx_latent = torch.tensor([3, 11, 20, 28]), torch.tensor([5, 9, 14, 31])
    pick = lambda out, key: {n: r[key] for n, r in out.items()}  # noqa: E731
    lrs = dict(policy=CQL_KW["policy_lr"], critic=CQL_KW["qf_lr"], latent=SLAC_KW["lr_latent"],
               target=CQL_KW["qf_lr"])
    for lagrange, eval_start in CQL_PARITY_CASES:
        label = (f"CQL + SLAC ({'BC warm-up' if eval_start else 'SAC policy loss'}, "
                 f"Lagrange {'on' if lagrange else 'off'})")
        draws = dict(posterior=noise(), pi=randn(B, A), next=randn(B, A),
                     random=torch.rand(B * N, A, generator=gen, dtype=torch.float64) * 2 - 1,
                     pi_tiled=randn(B * N, A), next_tiled=randn(B * N, A))
        latent_noise = noise()
        out = {}
        for name, device, dtype in PARITY_RUNS:
            dtype = getattr(torch, dtype)
            t0 = time.time()
            slac = make_slac(device, B, 64)
            slac.latent.to(dtype)
            slac.buffer.ingest_real(ds)
            tr = make_cql(slac, dtype, with_lagrange=lagrange, policy_eval_start=eval_start)
            batch = window_batch(*slac.buffer.gather(idx_batch))
            batch["actions"][:, -1, 0], batch["actions"][0, -1, 1] = 1.0, -1.0  # the atanh clip
            metrics = tr.train(batch, draws=draws, latent_draws=(
                idx_latent, [t.to(device, dtype) for t in latent_noise]))
            r = dict(metrics={k: v.item() for k, v in metrics.items()})
            r["metrics"].update(log_alpha=tr.log_alpha.item(),
                                log_alpha_prime=tr.log_alpha_prime.item())
            for mod, net in (("policy", tr.policy), ("critic", tr.critic), ("latent", slac.latent)):
                r[f"{mod}_grad"] = _f64((k, p.grad) for k, p in net.named_parameters()
                                        if p.grad is not None)
                r[f"{mod}_param"] = _f64(net.named_parameters())
            r["target_param"] = _f64(tr.target_q.named_parameters())
            out[name] = r
            print(f"parity {label} {name}: train() in {time.time() - t0:.1f} s; "
                  + ", ".join(f"{k} {v:.8g}" for k, v in sorted(r["metrics"].items())))
        if ("alpha_prime" in out["cuda f32"]["metrics"]) != lagrange:
            fail(f"{label}: alpha_prime logged {not lagrange}")
        hold_to_f64(f"{label} metrics", pick(out, "metrics"), "metric")
        for mod in ("policy", "critic", "latent"):
            hold_to_f64(f"{label} {mod} gradients", pick(out, f"{mod}_grad"), "grad")
        for mod in ("policy", "critic", "target", "latent"):
            hold_to_f64(f"{label} {mod} parameters after the step", pick(out, f"{mod}_param"),
                        "param", lr=lrs[mod])

    rs = np.random.RandomState(73)
    n = SAC_BATCH
    batch = dict(observations=rs.randn(n, STATE_DIM), actions=rs.uniform(-1, 1, (n, ACT_DIM)),
                 rewards=rs.randn(n, 1), terminals=(rs.rand(n, 1) < 0.1).astype(np.float64),
                 next_observations=rs.randn(n, STATE_DIM))
    draws = dict(pi=rs.randn(n, ACT_DIM), next=rs.randn(n, ACT_DIM))
    out = {}
    for name, device, dtype in PARITY_RUNS:
        dtype = getattr(torch, dtype)
        policy = TanhGaussianPolicy(STATE_DIM, SAC_HIDDEN, ACT_DIM, seed=3).to(dtype)
        critic = CriticSLAC(STATE_DIM, ACT_DIM, SAC_HIDDEN, seed=4).to(dtype)
        tr = SACTrainer(policy, critic, seed=0, device=device)
        r = dict(metrics={k: v.item() for k, v in tr.train(batch, draws=draws).items()})
        for mod, net in (("policy", tr.policy), ("critic", tr.critic)):
            r[f"{mod}_grad"] = _f64((k, p.grad) for k, p in net.named_parameters()
                                    if p.grad is not None)
            r[f"{mod}_param"] = _f64(net.named_parameters())
        out[name] = r
    hold_to_f64("SAC (state, 256 x 2, batch 256) metrics", pick(out, "metrics"), "metric")
    for mod in ("policy", "critic"):
        hold_to_f64(f"SAC {mod} gradients", pick(out, f"{mod}_grad"), "grad")
        hold_to_f64(f"SAC {mod} parameters after the step", pick(out, f"{mod}_param"), "param",
                    lr=3e-4)


def phase_eval_metrics(ck, card: str, fake_frames, profile_dir: str | None) -> dict:
    """Card vs CPU for the three metric networks, then LPIPS pairs/sec and
    FID images/sec over ``fake_frames`` (one phase-5 rollout) against as
    many seeded frames."""
    import numpy as np
    import torch

    from s2p_tpu_torch.gan.inception import (
        InceptionV3Features,
        inception_fid_extractor,
        resize_bilinear,
    )
    from s2p_tpu_torch.gan.metrics import PerceptualMetric, compute_fid, evaluate_pairs
    from s2p_tpu_torch.gan.perceptual import LPIPSMetric

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(81)
    big = rs.uniform(-1, 1, (2, EVAL_PARITY_SIZE, EVAL_PARITY_SIZE, 3))
    a, b = (rs.uniform(-1, 1, (4, 64, 64, 3)) for _ in range(2))
    lin = [rs.rand(c).astype(np.float32) for c in LPIPS_CHANNELS]
    out = {}
    for name, device, dtype in PARITY_RUNS:
        dtype = getattr(torch, dtype)
        t0 = time.time()
        x = torch.from_numpy(big).to(device, dtype)
        if device == "cuda":
            feats = inception_fid_extractor(seed=0, device=device)(x)
        else:
            with torch.no_grad():
                feats = InceptionV3Features(seed=0, device=device).to(dtype)(resize_bilinear(x))
        lpips = LPIPSMetric(lin_weights=lin, seed=0, device=device)
        lpips.vgg.to(dtype)
        perceptual = PerceptualMetric(seed=0, device=device)
        perceptual.vgg.to(dtype)
        out[name] = dict(inception={"pool3": feats.double().cpu()},
                         lpips={"lpips": lpips(a, b).double().cpu()},
                         perceptual={"perceptual": perceptual(a, b).double().cpu()})
        print(f"parity eval metrics {name}: in {time.time() - t0:.1f} s; pool3 |max| "
              f"{feats.abs().max().item():.6g}, lpips {out[name]['lpips']['lpips'].tolist()}")
    for key, label in (("inception", f"Inception pool3 features ({EVAL_PARITY_SIZE}px -> 299px)"),
                       ("lpips", "LPIPS distances (calibrated, 64px)"),
                       ("perceptual", "perceptual distances (VGG19, 64px)")):
        hold_to_f64(label, {n: r[key] for n, r in out.items()}, "grad")

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 8
    fake = fake_frames.reshape(-1, 64, 64, 3)
    n = len(fake)
    g = torch.Generator(device="cuda").manual_seed(82)
    real = torch.rand(n, 64, 64, 3, device="cuda", generator=g) * 2 - 1
    lpips = LPIPSMetric(lin_weights=lin, seed=0, device="cuda")
    extract = inception_fid_extractor(seed=0, device="cuda")

    fake_b, real_b = ([t[i:i + EVAL_BATCH] for i in range(0, n, EVAL_BATCH)] for t in (fake, real))
    evaluate_pairs(fake_b[0], real_b[0], perceptual=lpips)  # cuDNN's first calls
    extract(real_b[0])
    torch.cuda.synchronize()
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    pairs = [evaluate_pairs(f, r, perceptual=lpips) for f, r in zip(fake_b, real_b)]
    torch.cuda.synchronize()
    lpips_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = [extract(x) for x in real_b + fake_b]
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid = compute_fid(extract, real_b, fake_b)
    fid_s = time.perf_counter() - t0
    launches = dict(launches=ck.fused_mat_norm.launches,
                    bwd_launches=ck.fused_mat_norm_bwd.launches)
    mean = {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
    pps, ips = n / lpips_s, 2 * n / extract_s
    print(f"eval evaluate_pairs(perceptual=LPIPSMetric) 64px batch {EVAL_BATCH}: {n} pairs in "
          f"{lpips_s:.3f} s, {pps:.1f} LPIPS pairs/sec on {card}; "
          + ", ".join(f"{k} {v:.6g}" for k, v in mean.items()))
    print(f"eval inception_fid_extractor 64px -> 299px batch {EVAL_BATCH}: {2 * n} images in "
          f"{extract_s:.3f} s, {ips:.1f} FID images/sec on {card}; compute_fid (extraction and "
          f"scipy sqrtm of 2048 x 2048) {fid_s:.2f} s, FID {fid:.6g} (seeded weights)")
    if not all(np.isfinite(v) for v in mean.values()) or not mean["lpips_vgg"] > 0:
        fail(f"eval metrics: bad pair metrics {mean}")
    if any(f.shape != (EVAL_BATCH, 2048) or not torch.isfinite(f).all() for f in feats):
        fail("eval metrics: bad pool3 features")
    if not (np.isfinite(fid) and fid >= 0):
        fail(f"eval metrics: FID {fid}")
    if launches["launches"] or launches["bwd_launches"]:
        fail(f"eval metrics launched the MAT-norm kernels: {launches}")
    lp = profile_device(lambda: evaluate_pairs(fake_b[0], real_b[0], perceptual=lpips),
                        profile_dir, "lpips_batch")
    ex = profile_device(lambda: extract(real_b[0]), profile_dir, "fid_extract_batch")
    return dict(launches, pps=pps, ips=ips, fid=fid, lpips_idle=lp["device_idle_share"],
                extract_idle=ex["device_idle_share"])


def phase_acting_parity() -> None:
    """One full-width acting step (``SlacAlgorithm.preprocess`` of an 8-frame
    100px window, then the deterministic ``PolicyAgent`` over the shipped
    policy) on the card in f32 and on the CPU in f32 and f64, from the same
    seeded weights and window."""
    import numpy as np
    import torch

    from s2p_tpu_torch.samplers import PolicyAgent

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    S = SLAC_KW["num_sequences"]
    rs = np.random.RandomState(81)
    frames = rs.randint(0, 256, (S, BRIDGE_SIZE, BRIDGE_SIZE, 3), dtype=np.uint8)
    actions = rs.uniform(-1, 1, (S - 1) * ACT_DIM).astype(np.float32)
    out = {}
    for name, device, dtype in PARITY_RUNS:
        dtype = getattr(torch, dtype)
        slac = make_slac(device, SLAC_BATCH, 16)
        slac.latent.to(dtype)
        policy, _ = slac_rl_nets(slac, dtype)
        agent = PolicyAgent(policy.to(device), deterministic=True)
        fa = slac.preprocess(frames, actions)
        action, _ = agent.get_action(fa.squeeze(0))
        out[name] = dict(feature={"feature_action": fa.detach().double().cpu()},
                         action={"action": torch.from_numpy(action).double()})
        print(f"acting parity {name}: feature_action {tuple(fa.shape)}, action "
              + " ".join(f"{v:.8f}" for v in action))
    for key in ("feature", "action"):
        hold_to_f64(f"acting step {key} (of the largest |value|)",
                    {n: r[key] for n, r in out.items()}, "grad")


def phase_rl_experiment(ck, card: str, pretrain: dict, generated: dict,
                        profile_dir: str | None) -> dict:
    """``run_iql_image.sh`` through the ``mujoco_finetune`` CLI's assembly on
    stub envs: on-device generation and ingestion of phase 11's rows, the IQL
    loop over epochs -2..0, then the CQL loop for one offline epoch."""
    import csv
    import pickle
    import shutil

    import numpy as np
    import torch

    from s2p_tpu_torch.cli.mujoco_finetune import (
        build_image_rl,
        build_parser,
        experiment_logger,
        ingest_generated_on_device,
        make_variant,
    )
    from s2p_tpu_torch.cli.mujoco_finetune import make_slac as cli_make_slac
    from s2p_tpu_torch.envs import StubEnv
    from s2p_tpu_torch.gan import S2PGenerator

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 15
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    log_root = os.path.join(root, "build", "chip_smoke_rl")
    shutil.rmtree(log_root, ignore_errors=True)
    with open(os.path.join(root, FROZEN_CSV), newline="") as f:
        frozen = set(next(csv.reader(f)))

    def variant(algo: str, start_epoch: int, num_epochs: int, steps: int):
        return make_variant(build_parser().parse_args([
            "--env_name", "cheetah-run", "--exp_name", f"{algo}_image", "--algo_type", algo,
            "--image_rl", "--slac_representation", "--slac_policy_input_type", "feature_action",
            "--data_mix_num_real", str(SLAC_REAL_ROWS), "--data_mix_num_gen", str(SLAC_GEN_ROWS),
            "--uncertainty_type", UNCERTAINTY_TYPE,
            "--uncertainty_penalty_lambda", str(UNCERTAINTY_LAMBDA), "--no_video",
            "--image_size", str(BRIDGE_SIZE), "--batch_size", str(IQL_BATCH),
            "--start_epoch", str(start_epoch), "--num_epochs", str(num_epochs),
            "--num_trains_per_train_loop", str(steps), "--log_dir", log_root, "--gpu_id", "0"]))

    def stub_env():
        return StubEnv(image_shape=(BRIDGE_SIZE, BRIDGE_SIZE, 3), action_dim=ACT_DIM,
                       max_episode_steps=CHEETAH_HORIZON)

    def run(v, slac, name):
        """Build and train one loop; (progress rows, the loop, seconds,
        MAT-norm launches), after the checks every run must pass."""
        log, log_dir = experiment_logger(v)
        algo = build_image_rl(v, slac, stub_env(), stub_env(), log, log_dir)
        nets = dict(policy=algo.trainer.policy.fc0.weight,
                    critic=algo.trainer.critic.qf1.fc0.weight,
                    latent=slac.latent.encoder.net[0].weight)
        before = {k: t.detach().clone() for k, t in nets.items()}
        ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
        t0 = time.perf_counter()
        algo.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = (ck.fused_mat_norm.launches, ck.fused_mat_norm_bwd.launches)
        log.close()
        with open(os.path.join(log_dir, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        epochs = list(range(v["start_epoch"], v["num_epochs"]))
        if [int(r["epoch"]) for r in rows] != epochs:
            fail(f"{name} loop: epochs {[r['epoch'] for r in rows]}, expected {epochs}")
        if set(rows[0]) != frozen and name == "iql":
            fail(f"{name} loop: progress.csv columns differ from {FROZEN_CSV}: "
                 f"{sorted(set(rows[0]) ^ frozen)}")
        bad = [k for r in rows for k, x in r.items()
               if k.startswith("trainer/") and not np.isfinite(float(x))]
        if bad:
            fail(f"{name} loop: non-finite trainer values {sorted(set(bad))}")
        still = [k for k, t in nets.items() if torch.equal(t, before[k])]
        if still:
            fail(f"{name} loop: {still} did not move")
        lengths = {(r["eval/path length Min"], r["eval/path length Max"], r["eval/is_fresh"])
                   for r in rows}
        if lengths != {(f"{CHEETAH_HORIZON}.0", f"{CHEETAH_HORIZON}.0", "1")}:
            fail(f"{name} loop: eval paths (min, max, fresh) {lengths}")
        snapshots = any(e % algo.snapshot_gap == 0 for e in epochs)  # epoch 0 saves
        for snap in ("rewards_list.pkl",) + (("params.pkl", "itr_0.pkl") if snapshots else ()):
            if not os.path.exists(os.path.join(log_dir, snap)):
                fail(f"{name} loop: no {snap}")
        with open(os.path.join(log_dir, "rewards_list.pkl"), "rb") as f:
            rewards = pickle.load(f)
        if [r.shape for r in rewards] != [(1, CHEETAH_HORIZON)] * len(rows):
            fail(f"{name} loop: rewards_list.pkl holds {[r.shape for r in rewards]}")
        if launches != (0, 0):
            fail(f"{name} loop launched the MAT-norm kernels {launches} times")
        return rows, algo, elapsed

    v = variant("iql", -2, 1, RL_LOOP_STEPS)
    slac = cli_make_slac(v, ACT_DIM, "cuda")
    slac.latent.load_state_dict(pretrain["latent"])
    n_real = slac.buffer.ingest_real(pretrain["real"])
    slac.buffer.mark_real()
    gen = S2PGenerator(STATE_DIM, image_size=BRIDGE_SIZE, ngf=64, seed=0, device="cuda")
    torch.cuda.synchronize()
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    n_gen, n_frames = ingest_generated_on_device(slac, generated, gen, UNCERTAINTY_TYPE,
                                                 UNCERTAINTY_LAMBDA)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = dict(launches=ck.fused_mat_norm.launches,
                        bwd_launches=ck.fused_mat_norm_bwd.launches)
    expected = sum(norm_shapes(gen).values()) * math.ceil(n_frames / BATCH)
    print(f"rl experiment: ingest_generated_on_device (100px ngf=64 bf16 batch {BATCH}): "
          f"{n_frames} frames rendered and {n_gen} generated windows ingested beside {n_real} "
          f"real in {gen_s:.3f} s, {n_frames / gen_s:.1f} generated frames/sec (bf16 copy of "
          f"the generator, rendering and ingestion); fused_mat_norm launches "
          f"{gen_launches['launches']} (expected {expected}), backward "
          f"{gen_launches['bwd_launches']} on {card}")
    if gen_launches != dict(launches=expected, bwd_launches=0):
        fail(f"rl experiment: generation launched {gen_launches}, expected {expected} forward")
    del gen

    rows, algo, elapsed = run(v, slac, "iql")
    horizon, steps = CHEETAH_HORIZON, RL_LOOP_STEPS
    eval_sps = [horizon / float(r["time/evaluation sampling (s)"]) for r in rows]
    train_sps = [steps / float(r["time/training (s)"]) for r in rows]
    print(f"rl experiment iql (batch {IQL_BATCH}, epochs -2..0 of {steps} steps, eval 1 path of "
          f"{horizon} steps per epoch on StubEnv 100px): loop {elapsed:.2f} s on {card}; eval "
          "env-steps/sec per epoch " + ", ".join(f"{x:.1f}" for x in eval_sps)
          + "; train steps/sec per epoch " + ", ".join(f"{x:.2f}" for x in train_sps))
    for r in rows:
        print(f"rl experiment iql epoch {r['epoch']}: "
              + ", ".join(f"{k[5:]} {float(x):.4f}" for k, x in r.items() if k.startswith("time/"))
              + f"; eval return {float(r['eval/Returns Mean']):.3f}, trainer/critic_loss "
              f"{float(r['trainer/critic_loss']):.4g}, loss_image {float(r['trainer/loss_image']):.1f}")
    col = algo.eval_data_collector
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col.collect_new_paths(horizon, horizon, discard_incomplete_paths=True)
    steady_sps = horizon / (time.perf_counter() - t0)
    print(f"rl experiment: one more eval path after training, {steady_sps:.1f} env-steps/sec "
          f"(MdpPathCollector on StubEnv 100px: window encode, policy, action to the host) "
          f"on {card}")
    window = np.random.RandomState(82).randint(
        0, 256, (SLAC_KW["num_sequences"], BRIDGE_SIZE, BRIDGE_SIZE, 3), dtype=np.uint8)
    acts = np.zeros((SLAC_KW["num_sequences"] - 1) * ACT_DIM, np.float32)
    agent = col.policy
    act_step = profile_device(lambda: agent.get_action(slac.preprocess(window, acts).squeeze(0)),
                              profile_dir, "acting_step")

    rows_cql, _, elapsed_cql = run(variant("cql", -1, 0, RL_CQL_STEPS), slac, "cql")
    r = rows_cql[0]
    print(f"rl experiment cql (batch {IQL_BATCH}, epoch -1 of {RL_CQL_STEPS} steps): loop "
          f"{elapsed_cql:.2f} s, {RL_CQL_STEPS / float(r['time/training (s)']):.2f} train "
          f"steps/sec, eval {horizon / float(r['time/evaluation sampling (s)']):.1f} "
          f"env-steps/sec; trainer/min_qf1_loss {float(r['trainer/min_qf1_loss']):.4g} on {card}")
    return dict(gen_launches, fps=n_frames / gen_s, eval_sps=eval_sps, train_sps=train_sps,
                steady_sps=steady_sps, act_launches=act_step["launches"],
                act_idle=act_step["device_idle_share"])


def hold_to_single(label: str, got: dict, ref: dict) -> None:
    """A data-parallel f32 step against the single-process one: metrics to
    METRIC_FLOOR relative, gradients to GRAD_FLOOR of the module's largest
    (phase 7's floors)."""
    e_m = max((abs(got["metrics"][k] - r) / max(abs(r), 1e-30), k)
              for k, r in ref["metrics"].items())
    print(f"{label}: largest metric difference {e_m[0]:.3g} ({e_m[1]}), relative")
    if not e_m[0] <= METRIC_FLOOR:
        fail(f"{label}: metric {e_m[1]} differs by {e_m[0]:.3g} from the single-process step")
    for mod, grads in ref["grads"].items():
        scale = max(g.abs().max().item() for g in grads.values())
        e_g = max(((got["grads"][mod][k] - g).abs().max().item() / scale, k)
                  for k, g in grads.items())
        print(f"{label}: largest {mod} gradient difference {e_g[0]:.3g} of the largest "
              f"|gradient| {scale:.3g} ({e_g[1]})")
        if not e_g[0] <= GRAD_FLOOR:
            fail(f"{label}: {mod} gradient {e_g[1]} differs by {e_g[0]:.3g}")


class SlopeMasks:
    """The slope each ReLU and leaky ReLU of a step takes (every one in G,
    D, VGG and the hinge losses is an ``F.relu`` or ``F.leaky_relu`` call):
    ``with masks.record():`` around one step keeps which pre-activations
    were positive, call by call; ``with masks.replay():`` around the same
    step on other inputs' precision gives each call those slopes instead
    of its own, and counts the entries whose own sign differs (``flips``).
    A pre-activation within float noise of zero takes one slope in f32 and
    the other in f64, and one such flip moves a weight gradient by up to
    ~1e-2 of the module's largest; against an f64 step that replays the
    f32 step's slopes, the f32 step differs by its arithmetic alone."""

    def __init__(self):
        self.masks: list = []
        self.flips = self._i = 0

    def shard(self, rank: int, world: int) -> "SlopeMasks":
        """The slopes of data-parallel rank ``rank`` of ``world``: each
        call's rows [rank·b/world, (rank + 1)·b/world) (every ReLU input of
        the step is batch-first)."""
        part = SlopeMasks()
        part.masks = [m[rank * len(m) // world:(rank + 1) * len(m) // world]
                      for m in self.masks]
        return part

    @contextlib.contextmanager
    def record(self):
        with self._patched(self._record):
            yield self

    @contextlib.contextmanager
    def replay(self):
        self.flips = self._i = 0
        with self._patched(self._replay):
            yield self
        if self._i != len(self.masks):
            fail(f"slope replay: {self._i} ReLU calls against {len(self.masks)} recorded")

    @contextlib.contextmanager
    def _patched(self, apply):
        import torch.nn.functional as F

        relu, leaky = F.relu, F.leaky_relu
        F.relu = lambda x, inplace=False: apply(x, 0.0, lambda: relu(x, inplace))
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: apply(
            x, negative_slope, lambda: leaky(x, negative_slope, inplace))
        try:
            yield
        finally:
            F.relu, F.leaky_relu = relu, leaky

    def _record(self, x, slope, original):
        self.masks.append((x > 0).detach().cpu())
        return original()

    def _replay(self, x, slope, original):
        import torch

        if self._i >= len(self.masks) or self.masks[self._i].shape != x.shape:
            fail(f"slope replay: call {self._i} on {tuple(x.shape)} does not match the record")
        mask = self.masks[self._i].to(x.device)
        self._i += 1
        self.flips += int((mask != (x > 0)).sum())
        return torch.where(mask, x, slope * x)


def step_record(trainer, metrics) -> dict:
    return dict(metrics={k: v.item() for k, v in metrics.items()},
                grads={mod: {k: p.grad.detach().clone() for k, p in
                             getattr(trainer, mod).named_parameters()}
                       for mod in ("generator", "discriminator")})


def phase_dp_nccl(ck, card: str, single_sps: float) -> dict:
    """Phase 20a: data parallelism at world 1 over NCCL (a TCP store on
    127.0.0.1, this card): the per-step path and ``train_many_dp`` held in
    f32 (TF32 off, cuDNN deterministic) to the single-process
    ``train_step``/``train_many`` with the same draws; DP_STEPS timed bf16
    DP steps in turns with a single-process trainer, beside phase 8's rate
    and the single-process rate before the group existed; the gradient
    sync alone in device ms. Returns the DP window's MAT-norm launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from s2p_tpu_torch.parallel import MeshSpec, make_mesh, shard_batch, sync_grads
    from s2p_tpu_torch.parallel.distributed import free_port, initialize_distributed

    ds = multi_env_pairs()
    batches = list(ds.batches(TRAIN_BATCH, np.random.RandomState(0)))
    host = dict(prev_image=ds.prev_images, state=ds.states, target_image=ds.target_images)

    def timed(tr, lo: int, seconds: dict, name: str) -> list:
        """DP_STEPS / 2 bf16 steps of ``tr`` on batches lo, lo + 1, ..."""
        with HostWindow() as window:
            out = [tr.train_step(shard_batch(mesh, batches[j % len(batches)]))
                   for j in range(lo, lo + DP_STEPS // 2)]
        seconds[name] = seconds.get(name, 0.0) + window.wall
        print(f"dp nccl window {name}, batches {lo}-{lo + DP_STEPS // 2 - 1}: "
              f"{DP_STEPS / 2 / window.wall:.3f} steps/sec; host: {window}")
        return out

    # the single-process step before any process group exists, to see what
    # the group's own threads cost the host
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as phase 8
    mesh = make_mesh(MeshSpec(data=1))
    single = make_trainer("cuda", torch.bfloat16, state_dim=WALKER_STATE_DIM)
    seconds: dict = {}
    for b in batches[:2]:  # warm-up
        single.train_step(b)
    metrics = timed(single, 0, seconds, "single, no group")
    # the same again once the caching allocator has returned the blocks that
    # earlier phases left cached: whether its state costs this late process
    # host time (one R1 step in each window)
    torch.cuda.empty_cache()
    single.g_step = single.d_step = 0
    metrics += timed(single, 0, seconds, "single, no group, cache emptied")

    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           device=torch.device("cuda", 0))
    try:
        mesh = make_mesh(MeshSpec(data=1))
        group = mesh.groups["data"]
        staged = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
        # deterministic cuDNN algorithms, so that the two runs differ only by
        # what data parallelism changes (at world 1: nothing)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        ref_tr = make_trainer("cuda", torch.float32, state_dim=WALKER_STATE_DIM)
        dp = copy.deepcopy(ref_tr)
        dp.dp_group = group
        # each step from the same state all the same: Adam's first steps turn
        # a gradient within noise of zero into a ±lr move
        for i, b in enumerate(batches[:2]):
            dp.load_state_dict(copy.deepcopy(ref_tr.state_dict()))  # Adam's load aliases
            ref = step_record(ref_tr, ref_tr.train_step(b))
            got = step_record(dp, dp.train_step(shard_batch(mesh, b)))
            hold_to_single(f"dp nccl world 1 per-step, step {i + 1}", got, ref)
        # train_many_dp with both learning rates 0, so every step of both
        # runs sees the same weights: the metrics averaged over the steps
        # and the last step's gradients
        dp.load_state_dict(copy.deepcopy(ref_tr.state_dict()))
        for opt in (ref_tr.g_opt, ref_tr.d_opt, dp.g_opt, dp.d_opt):
            for param_group in opt.param_groups:
                param_group["lr"] = 0.0
        gen = lambda: torch.Generator(device="cuda").manual_seed(7)
        ref = step_record(ref_tr, ref_tr.train_many(staged, 2, TRAIN_BATCH, gen()))
        got = step_record(dp, dp.train_many_dp(mesh, host, 2, TRAIN_BATCH, gen()))
        hold_to_single("dp nccl world 1 train_many_dp, 2 steps at lr 0", got, ref)
        del ref_tr, dp
        torch.backends.cudnn.deterministic = False

        # the rate: the DP trainer and the single-process one (a copy of the
        # same weights), in turns (single, dp, dp, single; DP_STEPS / 2 steps
        # a window), each from step 0 so that R1 fires at D steps 0 and 16
        torch.backends.cudnn.allow_tf32 = True
        trainer = copy.deepcopy(single)
        trainer.dp_group = group
        launches = dict(fwd=0, bwd=0)
        for b in batches[:2]:  # warm-up
            trainer.train_step(shard_batch(mesh, b))
        single.g_step = single.d_step = trainer.g_step = trainer.d_step = 0
        half = DP_STEPS // 2
        for tr, name, lo in ((single, "single", 0), (trainer, "dp", 0), (trainer, "dp", half),
                             (single, "single", half)):
            ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
            metrics += timed(tr, lo, seconds, name)
            if name == "dp":
                launches["fwd"] += ck.fused_mat_norm.launches
                launches["bwd"] += ck.fused_mat_norm_bwd.launches
        del single
        if not torch.isfinite(torch.stack([v for m in metrics for v in m.values()])).all():
            fail("dp nccl: non-finite losses")
        sps, single_here = DP_STEPS / seconds["dp"], DP_STEPS / seconds["single"]
        before = DP_STEPS / 2 / seconds["single, no group"]
        print(f"dp nccl world 1 (bf16, batch {TRAIN_BATCH}, cheetah + walker): {sps:.3f} "
              f"steps/sec, {sps * TRAIN_BATCH:.1f} images/sec ({1e3 / sps:.2f} ms per step, "
              f"{DP_STEPS} steps); the single-process trainer in turns with it: "
              f"{single_here:.3f} steps/sec ({1e3 / single_here:.2f} ms), DP / single "
              f"{sps / single_here:.3f}; the single-process trainer before the group existed: "
              f"{before:.3f} steps/sec ({DP_STEPS // 2} steps); phase 8's train_step in this "
              f"call: {single_sps:.3f} steps/sec on {card}")
        expected = dict(fwd=26 * DP_STEPS, bwd=13 * DP_STEPS)
        print(f"dp nccl launches: {launches} (expected {expected})")
        if launches != expected:
            fail(f"dp nccl launched the MAT-norm kernels {launches}, expected {expected}")
        g_grads = [p.grad for p in trainer.generator.parameters()]
        d_grads = [p.grad for p in trainer.discriminator.parameters()]
        sync = lambda: (sync_grads(d_grads, group), sync_grads(g_grads, group))
        stream_ms = time_ms(sync)
        prof = profile_device(sync, None, "dp_sync")
        sync_ms = prof["device_busy_ms"]
        n_bytes = 4 * sum(g.numel() for g in g_grads + d_grads)
        print(f"dp nccl gradient sync (the flatten, two all-reduces, the copies back; "
              f"{n_bytes / 1e6:.1f} MB of f32): {sync_ms:.4f} ms of device time per step "
              f"(profiler, {prof['launches']} launches), {100 * sync_ms * sps / 1e3:.2f}% of the "
              f"step; {stream_ms:.4f} ms between CUDA events around it (the stream's time, host "
              f"gaps between launches included) on {card}")
        del trainer
    finally:
        dist.destroy_process_group()
    return launches


def dp_gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of phase 20b (gloo, every rank on this card): the protocol's
    trainer broadcast from rank 0, one f32 DP step (TF32 off, D's learning
    rate 0, the ReLU slopes of its rows of the card's single-process step
    replayed; rank 0 saves it for the comparisons), then 2 bf16 per-step DP
    steps and 2 bf16 ``train_many_dp`` steps; after every step the ranks'
    state checksums
    must agree, and every step must launch 26 forward and 13 backward
    MAT-norm kernels."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from s2p_tpu_torch.gan import cuda_kernels as ck
    from s2p_tpu_torch.parallel import (MeshSpec, make_mesh, shard_batch, shard_pytree,
                                        state_checksum)
    from s2p_tpu_torch.parallel.distributed import initialize_distributed

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh(MeshSpec(data=world))
    ds = multi_env_pairs()
    batches = list(ds.batches(TRAIN_BATCH, np.random.RandomState(0)))
    parity = next(ds.batches(DP_PARITY_BATCH, np.random.RandomState(0)))
    host = dict(prev_image=ds.prev_images, state=ds.states, target_image=ds.target_images)
    trainer = make_trainer("cuda", torch.float32, d_lr=0.0, state_dim=WALKER_STATE_DIM,
                           dp_group=mesh.groups["data"])
    for obj in (trainer.generator, trainer.discriminator, trainer.g_opt, trainer.d_opt):
        shard_pytree(mesh, obj)
    sampler = torch.Generator(device="cuda").manual_seed(100 + rank)
    slopes = SlopeMasks()
    slopes.masks = torch.load(os.path.join(out_dir, f"slopes{rank}.pt"))

    def f32_step():
        with slopes.replay():
            return trainer.train_step(shard_batch(mesh, parity))

    steps = [("f32 per-step", f32_step)]
    steps += [("bf16 per-step", lambda i=i: trainer.train_step(shard_batch(mesh, batches[i])))
              for i in (1, 2)]
    steps += [("bf16 train_many_dp", lambda: trainer.train_many_dp(mesh, host, 1, TRAIN_BATCH,
                                                                   sampler))] * 2
    report = dict(rank=rank, steps=[])
    for i, (name, run) in enumerate(steps):
        if i == 1:  # the protocol: bf16 compute, cuDNN TF32 on (PyTorch's default), D's lr
            trainer.compute_dtype = torch.bfloat16
            torch.backends.cudnn.allow_tf32 = True
            for param_group in trainer.d_opt.param_groups:
                param_group["lr"] = D_LR
        before = (ck.fused_mat_norm.launches, ck.fused_mat_norm_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (ck.fused_mat_norm.launches - before[0],
                    ck.fused_mat_norm_bwd.launches - before[1])
        sums = [None] * world
        dist.all_gather_object(sums, state_checksum(trainer.generator, trainer.discriminator,
                                                    trainer.g_opt, trainer.d_opt))
        report["steps"].append(dict(name=name, seconds=seconds, launches=launches,
                                    checksums=sums,
                                    metrics={k: v.item() for k, v in metrics.items()}))
        if i == 0 and rank == 0:
            record = step_record(trainer, metrics)
            record["params"] = {mod: dict(getattr(trainer, mod).named_parameters())
                                for mod in ("generator", "discriminator")}
            for part in ("grads", "params"):
                record[part] = {mod: {k: v.detach().cpu() for k, v in named.items()}
                                for mod, named in record[part].items()}
            torch.save(record, os.path.join(out_dir, "step1.pt"))
        if len(set(sums)) != 1:
            raise RuntimeError(f"rank {rank}: state checksums differ after step {i + 1}: {sums}")
        if launches != (26, 13):
            raise RuntimeError(f"rank {rank}: step {i + 1} launched {launches} MAT-norm kernels")
    report["flips"] = slopes.flips
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def phase_dp_gloo(card: str) -> dict:
    """Phase 20b: DP_WORLD gloo ranks on this one card (spawned), each
    step's state bit-identical across the ranks; the f32 first step (D's
    learning rate 0, as phase 7's) held to the card's single-process f32
    step on the same global batch (phase 7's floors), and to that step in
    f64 on the CPU as phase 7 holds its step (within PARITY_SLACK times the
    CPU's f32 step's distance, or the floor), with every ReLU's slope in
    the CPU's f64 and f32 steps replayed from the card's single-process
    step (``SlopeMasks``); the MAT-norm launches per rank and step; and the
    rate: gloo through the host on one card, a correctness check and not a
    multi-card number."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_", dir="build") as out_dir:
        return _phase_dp_gloo(card, out_dir)


def _phase_dp_gloo(card: str, out_dir: str) -> dict:
    import numpy as np
    import torch

    from s2p_tpu_torch.parallel.distributed import spawn_ranks

    batch = next(multi_env_pairs().batches(DP_PARITY_BATCH, np.random.RandomState(0)))
    torch.backends.cudnn.allow_tf32 = False
    masks, runs, flips = SlopeMasks(), {}, {}

    def step(name, device, dtype, slopes):
        trainer = make_trainer(device, dtype, d_lr=0.0, state_dim=WALKER_STATE_DIM)
        with slopes():
            metrics = trainer.train_step(batch)
        if slopes == masks.replay:
            flips[name] = masks.flips
        rec = step_record(trainer, metrics)
        rec["params"] = {mod: dict(getattr(trainer, mod).named_parameters())
                         for mod in ("generator", "discriminator")}
        for part in ("grads", "params"):
            rec[part] = {mod: _f64(named.items()) for mod, named in rec[part].items()}
        runs[name] = rec

    step("cuda f32 single", "cuda", torch.float32, masks.record)
    for r in range(DP_WORLD):
        torch.save(masks.shard(r, DP_WORLD).masks, os.path.join(out_dir, f"slopes{r}.pt"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, dp_gloo_rank, DP_WORLD, (out_dir,), timeout=600)
        step("cpu f64", "cpu", torch.float64, masks.replay)
        step("cpu f32", "cpu", torch.float32, masks.replay)
        # the same steps with their own slopes, to show what the replay removes
        step("cpu f64, own slopes", "cpu", torch.float64, contextlib.nullcontext)
        step("cpu f32, own slopes", "cpu", torch.float32, contextlib.nullcontext)
        try:
            ranks.result()
        except RuntimeError as err:
            fail(f"dp gloo: {err}")
    reports = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    runs["cuda f32"] = dp = torch.load(os.path.join(out_dir, "step1.pt"), weights_only=False)
    for part in ("grads", "params"):
        dp[part] = {mod: _f64(named.items()) for mod, named in dp[part].items()}
    single = runs.pop("cuda f32 single")
    hold_to_single(f"dp gloo step 1 ({DP_WORLD} ranks) against the card's single-process step",
                   dp, single)
    ref, cpu = runs.pop("cpu f64, own slopes"), runs.pop("cpu f32, own slopes")
    for mod, grads in ref["grads"].items():
        scale = max(g.abs().max().item() for g in grads.values())
        e_card, e_cpu = (max(((r["grads"][mod][k] - g).abs().max().item() / scale, k)
                             for k, g in grads.items()) for r in (single, cpu))
        print(f"dp gloo step 1, each step with its own slopes: {mod} gradients of the card's "
              f"single-process f32 step {e_card[0]:.3g} ({e_card[1]}) from f64, the CPU's f32 "
              f"step {e_cpu[0]:.3g} ({e_cpu[1]}), of the largest |gradient| {scale:.3g}")
    print(f"dp gloo step 1: every ReLU's slope ({len(masks.masks)} calls) replayed from the "
          f"card's single-process f32 step; entries whose own sign differs: the ranks "
          f"{[rep['flips'] for rep in reports]}, the CPU's f64 step {flips['cpu f64']}, its f32 "
          f"step {flips['cpu f32']}")
    hold_to_f64("dp gloo step 1 metrics", {n: r["metrics"] for n, r in runs.items()}, "metric")
    for mod, lr in (("generator", 1e-4), ("discriminator", 0.0)):
        for part, kind in (("grads", "grad"), ("params", "param")):
            hold_to_f64(f"dp gloo step 1 {mod} {part}",
                        {n: r[part][mod] for n, r in runs.items()}, kind, lr=lr)
    protocol = reports[0]["steps"][1:]
    seconds = sum(s["seconds"] for s in protocol)
    for rep in reports:
        print(f"dp gloo rank {rep['rank']}: " + "; ".join(
            f"{s['name']} {s['seconds'] * 1e3:.1f} ms, launches {s['launches'][0]}/"
            f"{s['launches'][1]}, checksum {s['checksums'][0]}" for s in rep["steps"]))
    print(f"dp gloo ({DP_WORLD} ranks through the host on one card; a correctness check, not a "
          f"multi-card rate): {len(protocol) / seconds:.3f} steps/sec at the protocol (bf16, "
          f"global batch {TRAIN_BATCH}), {seconds / len(protocol) * 1e3:.1f} ms per step; every "
          f"step's state bit-identical across the ranks on {card}")
    launches = [sum(s["launches"][j] for rep in reports for s in rep["steps"]) for j in (0, 1)]
    return dict(fwd=launches[0], bwd=launches[1])


def phase_tp(gen_cpu, card: str) -> int:
    """Phase 20c: the serving generator (64px, ngf 64) tensor-parallel over
    a data=1 x model=DP_WORLD mesh of gloo ranks on this card
    (``model_shard_params``, min_features TP_MIN_FEATURES), each rank's
    forward held to the replicated forward on the card in f32 (TF32 off) to
    TP_TOL; returns the MAT-norm launches of the ranks' forwards."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_", dir="build") as out_dir:
        return _phase_tp(gen_cpu, card, out_dir)


def _phase_tp(gen_cpu, card: str, out_dir: str) -> int:
    import numpy as np
    import torch

    from s2p_tpu_torch.parallel.distributed import spawn_ranks
    from s2p_tpu_torch.testing import tp_worker

    rs = np.random.RandomState(30)
    spec = dict(state_dim=STATE_DIM, kwargs=FULL, g=gen_cpu.state_dict(),
                min_features=TP_MIN_FEATURES, device="cuda",
                state=rs.randn(TP_BATCH, STATE_DIM).astype(np.float32),
                prev_image=(rs.rand(TP_BATCH, 64, 64, 3) * 2 - 1).astype(np.float32))
    torch.save(spec, os.path.join(out_dir, "spec.pt"))
    try:
        spawn_ranks(tp_worker.run, DP_WORLD, (os.path.join(out_dir, "spec.pt"), out_dir),
                    timeout=300)
    except RuntimeError as err:
        fail(f"tp: {err}")
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        ref = copy.deepcopy(gen_cpu).to("cuda")(torch.as_tensor(spec["state"], device="cuda"),
                                               torch.as_tensor(spec["prev_image"],
                                                               device="cuda")).cpu()
    total = 0
    for r in range(DP_WORLD):
        res = torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
        err = (res["out"] - ref).abs().max().item()
        print(f"tp rank {r}: {len(res['sharded'])} layers sharded (e.g. "
              f"{next(iter(res['sharded'].items()), None)}), |sharded - replicated| {err:.3g} "
              f"(limit {TP_TOL} + {TP_TOL} x |replicated|), {res['launches']} MAT-norm launches "
              f"in one forward on {card}")
        if not res["sharded"]:
            fail("tp: no layer was sharded")
        if not torch.allclose(res["out"], ref, rtol=TP_TOL, atol=TP_TOL):
            fail(f"tp rank {r}: the sharded forward is {err:.3g} from the replicated one")
        if res["launches"] != 13:
            fail(f"tp rank {r}: {res['launches']} MAT-norm launches, expected 13")
        total += res["launches"]
    return total


# -- phase 21: data-parallel RL steps ------------------------------------------

DP_RL_KINDS = ("iql", "cql", "elbo")
DP_RL_NAMES = dict(iql="IQL + SLAC", cql="CQL + SLAC", elbo="SLAC ELBO")


def rl_draws(kind: str, batch: int, latent_batch: int, n_slots: int, seed: int) -> dict:
    """One step's draws (CPU f32) for ``batch`` RL rows and ``latent_batch``
    ELBO windows: the batch's slots, the posterior noise (with CQL's policy
    draws), and the ELBO step's slots and noise. Every draw splits over
    ranks by contiguous rows (CQL's tiled draws hold num_random rows per
    batch row in order)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    S, N, A = SLAC_KW["num_sequences"], CQL_KW["num_random"], ACT_DIM

    def noise(b):
        return [torch.randn(b, d, generator=g) for _ in range(S + 1)
                for d in (SLAC_KW["z1_dim"], SLAC_KW["z2_dim"])]

    def slots(b):
        return torch.randint(0, n_slots, (b,), generator=g)

    d = dict(slots=slots(batch), latent=(slots(latent_batch), noise(latent_batch)))
    if kind == "iql":
        d["draws"] = noise(batch)
    elif kind == "cql":
        randn = lambda n: torch.randn(n, A, generator=g)  # noqa: E731
        d["draws"] = dict(posterior=noise(batch), pi=randn(batch), next=randn(batch),
                          random=torch.rand(batch * N, A, generator=g) * 2 - 1,
                          pi_tiled=randn(batch * N), next_tiled=randn(batch * N))
    return d


def rl_step(kind: str, tr, slac, d: dict) -> dict:
    """One step of ``kind`` on the given draws ``d`` (``rl_draws``, or a
    rank's rows of them): an IQL or CQL ``train()`` on the windows of
    ``d["slots"]`` with its joint ELBO step, or the ELBO step alone."""
    from s2p_tpu_torch.data.replay import window_batch

    dev = slac.device
    latent = (d["latent"][0].to(dev), [t.to(dev) for t in d["latent"][1]])
    if kind == "elbo":
        return slac.update_latent(idx=latent[0], noise=latent[1])
    batch = window_batch(*slac.buffer.gather(d["slots"]))
    if kind == "iql":
        return tr.train(batch, prepare_noise=[t.to(dev) for t in d["draws"]],
                        latent_draws=latent)
    return tr.train(batch, draws=d["draws"], latent_draws=latent)


def rl_modules(kind: str, tr, slac) -> dict:
    nets = {} if kind == "elbo" else dict(policy=tr.policy, critic=tr.critic)
    nets["latent"] = slac.latent
    return nets


def rl_record(kind: str, tr, slac, metrics) -> dict:
    """The metrics, gradients and parameters after a step (on the CPU)."""
    nets = rl_modules(kind, tr, slac)
    grads = {m: {k: p.grad.detach().cpu() for k, p in net.named_parameters()
                 if p.grad is not None} for m, net in nets.items()}
    if kind == "cql":
        grads["temperatures"] = {k: getattr(tr, k).grad.detach().cpu().reshape(1)
                                 for k in ("log_alpha", "log_alpha_prime")
                                 if getattr(tr, k).grad is not None}
    return dict(metrics={k: v.item() for k, v in metrics.items()}, grads=grads,
                params={m: {k: v.detach().cpu() for k, v in net.state_dict().items()}
                        for m, net in nets.items()})


def rl_state(kind: str, tr, slac) -> list:
    """Everything a step changes (for ``state_checksum``)."""
    objs = [slac.latent, slac.opt]
    if kind != "elbo":
        objs += [tr.policy, tr.critic, tr.target_q, tr.policy_opt, tr.critic_opt]
    if kind == "cql":
        objs += [tr.log_alpha, tr.alpha_opt, tr.log_alpha_prime, tr.alpha_prime_opt]
    return objs


def rl_member(kind: str, group, latent: dict, buffer):
    """(trainer or None, SLAC) of ``kind`` over ``buffer`` from ``latent``,
    in data-parallel ``group`` (None: single-process)."""
    slac = make_slac("cuda", SLAC_BATCH, 8, dp_group=group)
    slac.latent.load_state_dict(latent)
    slac.buffer = buffer
    tr = None if kind == "elbo" else (make_iql if kind == "iql" else make_cql)(slac)
    return tr, slac


def rl_runner(kind: str, tr, slac, mesh=None):
    """``run(n)``: n steps drawn on the device (``train_many``, or
    ``train_many_dp`` over ``mesh``, at batch IQL_BATCH with the joint ELBO
    step; or ``update_latent_many``), the last step's metrics."""
    from s2p_tpu_torch.rl import train_many_dp

    if kind == "elbo":
        return slac.update_latent_many
    if mesh is None:
        return lambda n: tr.train_many(n, IQL_BATCH)
    return lambda n: train_many_dp(tr, mesh, n, IQL_BATCH)


def rl_sync(kind: str, tr, slac, metrics: dict, group):
    """The collectives one DP step of ``kind`` runs (on the gradients its
    last step left): ``(sync(), f32 bytes reduced, all-reduces)``. IQL: the
    critic's and policy's gradients, the metrics; CQL: α's, the policy's,
    the critic's with α′'s, the metrics; then the ELBO's gradients and
    losses."""
    from s2p_tpu_torch.parallel import all_reduce_mean, mean_metrics, sync_grads

    def grads(*objs):
        ps = [p for o in objs for p in (o.parameters() if hasattr(o, "parameters") else [o])]
        return [p.grad for p in ps if p.grad is not None]

    lists = []
    if kind == "iql":
        lists.append(grads(tr.critic, tr.policy))
    elif kind == "cql":
        lists += [grads(tr.log_alpha), grads(tr.policy),
                  grads(tr.critic, tr.log_alpha_prime)]
    lists.append(grads(slac.latent))
    losses = [metrics[k] for k in ("loss_kld", "loss_image", "loss_reward")]
    rl_metrics = {k: v for k, v in metrics.items() if not k.startswith("loss_")}

    def sync():
        for lst in lists:
            sync_grads(lst, group)
        if rl_metrics:
            mean_metrics(rl_metrics, group)
        all_reduce_mean(losses, group)

    n_bytes = 4 * (sum(g.numel() for lst in lists for g in lst) + len(metrics))
    return sync, n_bytes, len(lists) + 1 + bool(rl_metrics)


def hold_bitwise(label: str, got: dict, ref: dict) -> None:
    """A data-parallel step's record equal, bit for bit, to the
    single-process one: metrics, gradients and parameters."""
    import torch

    if got["metrics"] != ref["metrics"]:
        fail(f"{label}: metrics {got['metrics']} differ from {ref['metrics']}")
    for part in ("grads", "params"):
        for mod, tensors in ref[part].items():
            for k, v in tensors.items():
                if not torch.equal(got[part][mod][k], v):
                    fail(f"{label}: {part} {mod}.{k} differ")
    n = sum(len(t) for part in ("grads", "params") for t in ref[part].values())
    print(f"{label}: metrics and {n} gradient and parameter tensors bit-equal")


def rl_param_counts(kind: str, tr, slac) -> dict:
    return {m: sum(p.numel() for p in net.parameters())
            for m, net in rl_modules(kind, tr, slac).items()}


def phase_dp_rl_nccl(ck, card: str, pretrain: dict, generated: dict,
                     generated_frames) -> dict:
    """Phases 21a and 21c: data-parallel RL at world 1 over NCCL (a TCP
    store on 127.0.0.1, this card). 21a: phase 15's IQL + SLAC, phase 17's
    CQL + SLAC and phase 14's ELBO step on phase 15's buffer: one f32 DP step
    (TF32 off, cuDNN deterministic) bit-equal to the single-process step on
    the same draws; DP_RL_STEPS timed DP steps (``train_many_dp``) in turns
    with as many single-process ones (cuDNN TF32 on, as phases 14-17); the
    sync alone in device ms and launches; a profile of one DP step. 21c:
    ``state_loops``. Returns the MAT-norm launches of the DP windows."""
    import torch
    import torch.distributed as dist

    from s2p_tpu_torch.parallel import MeshSpec, make_mesh
    from s2p_tpu_torch.parallel.distributed import free_port, initialize_distributed

    filler = make_slac("cuda", SLAC_BATCH, 4000)
    n_real, n_gen = fill_rl_buffer(filler, pretrain, generated, generated_frames)
    buffer, latent = filler.buffer, pretrain["latent"]
    print(f"dp rl buffer: {n_real} real + {n_gen} generated windows (phase 15's)")
    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           device=torch.device("cuda", 0))
    launches = dict(fwd=0, bwd=0)
    out = {}
    try:
        mesh = make_mesh(MeshSpec(data=1))
        group = mesh.groups["data"]
        for i, kind in enumerate(DP_RL_KINDS):
            name = DP_RL_NAMES[kind]
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            d = rl_draws(kind, IQL_BATCH, SLAC_BATCH, len(buffer), seed=110 + i)
            records = []
            for g in (None, group):
                tr, slac = rl_member(kind, g, latent, buffer)
                records.append(rl_record(kind, tr, slac, rl_step(kind, tr, slac, d)))
            hold_bitwise(f"dp rl nccl world 1 {name}, one f32 step", records[1], records[0])
            torch.backends.cudnn.deterministic = False

            torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as phases 14-17
            single, dp = rl_member(kind, None, latent, buffer), rl_member(kind, group, latent,
                                                                          buffer)
            runs = dict(single=rl_runner(kind, *single), dp=rl_runner(kind, *dp, mesh))
            for run in runs.values():  # cuDNN's first calls
                run(2)
            seconds, metrics = dict(single=0.0, dp=0.0), []
            for who in ("single", "dp", "dp", "single"):
                ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
                with HostWindow() as window:
                    metrics.append(runs[who](DP_RL_STEPS))
                seconds[who] += window.wall
                if who == "dp":
                    launches["fwd"] += ck.fused_mat_norm.launches
                    launches["bwd"] += ck.fused_mat_norm_bwd.launches
                print(f"dp rl nccl {name} window {who}: {DP_RL_STEPS / window.wall:.2f} "
                      f"steps/sec; host: {window}")
            if not all(torch.isfinite(v) for m in metrics for v in m.values()):
                fail(f"dp rl nccl {name}: non-finite metrics")
            sps, single_sps = (2 * DP_RL_STEPS / seconds[w] for w in ("dp", "single"))
            counts = rl_param_counts(kind, *dp)
            sync, n_bytes, n_reduces = rl_sync(kind, *dp, metrics[-2], group)
            stream_ms = time_ms(sync)
            prof = profile_device(sync, None, f"dp_{kind}_sync")
            step = profile_device(lambda: runs["dp"](1), None, f"dp_{kind}_step")
            print(f"dp rl nccl world 1 {name} (f32, cuDNN TF32; batch "
                  f"{IQL_BATCH if kind != 'elbo' else SLAC_BATCH}, latent batch {SLAC_BATCH}): "
                  f"{sps:.2f} DP steps/sec, the single-process trainer in turns {single_sps:.2f}"
                  f", DP / single {sps / single_sps:.3f}; parameters {counts} "
                  f"({sum(counts.values()) / 1e6:.3f}M); the sync ({n_reduces} all-reduces, "
                  f"{n_bytes / 1e6:.2f} MB of f32): {prof['device_busy_ms']:.4f} ms of device "
                  f"time, {prof['launches']} launches, {stream_ms:.4f} ms between CUDA events; "
                  f"one DP step {step['device_busy_ms']:.3f} ms of device time (sync "
                  f"{100 * prof['device_busy_ms'] / step['device_busy_ms']:.2f}%), "
                  f"{step['launches']} launches, idle share {step['device_idle_share']:.3f} "
                  f"on {card}")
            out[kind] = dict(sps=sps, single_sps=single_sps, sync_ms=prof["device_busy_ms"],
                             sync_launches=prof["launches"], sync_bytes=n_bytes,
                             step_launches=step["launches"], idle=step["device_idle_share"])
        out["state"] = state_loops(ck, card, mesh, launches)
    finally:
        dist.destroy_process_group()
    if launches["fwd"] or launches["bwd"]:
        fail(f"dp rl nccl launched the MAT-norm kernels: {launches}")
    out["launches"] = launches
    return out


def state_rl_trainer(algo: str, group):
    """``mujoco_finetune``'s state branch: IQL or CQL over 256 x 2 networks
    on cheetah's observations."""
    from s2p_tpu_torch.rl import CQLTrainer, CriticSLAC, IQLTrainer, TanhGaussianPolicy

    policy = TanhGaussianPolicy(STATE_DIM, STATE_HIDDEN, ACT_DIM, seed=0)
    critic = CriticSLAC(STATE_DIM, ACT_DIM, STATE_HIDDEN, seed=1)
    common = dict(discount=0.99, policy_lr=1e-4, qf_lr=3e-4, seed=0, device="cuda",
                  dp_group=group)
    if algo == "iql":
        return IQLTrainer(policy, critic, beta=0.1, quantile=0.7, clip_score=100,
                          soft_target_tau=0.005, target_update_period=2, **common)
    return CQLTrainer(policy, critic, soft_target_tau=5e-3, policy_eval_start=40_000,
                      min_q_weight=5.0, with_lagrange=False, lagrange_thresh=-1.0, **common)


def state_loops(ck, card: str, mesh, launches: dict) -> dict:
    """Phase 21c: ``train_many_dp`` of the state IQL and CQL loops at world 1
    over NCCL against ``train_many`` on the same rows (STATE_PARITY_STEPS
    steps, bit-equal: metrics and every state tensor), then STATE_STEPS
    timed steps of each in turns, on STATE_ROWS seeded cheetah transitions
    at batch IQL_BATCH."""
    import numpy as np
    import torch

    from s2p_tpu_torch.data.replay import SimpleReplayBuffer
    from s2p_tpu_torch.parallel import state_checksum
    from s2p_tpu_torch.rl import train_many_dp
    from s2p_tpu_torch.rl.scan_utils import train_many

    rs = np.random.RandomState(81)
    buf = SimpleReplayBuffer(STATE_ROWS, STATE_DIM, ACT_DIM, device="cuda")
    for o, a, r, d, no in zip(rs.randn(STATE_ROWS, STATE_DIM), rs.uniform(-1, 1, (STATE_ROWS,
                                                                                   ACT_DIM)),
                              rs.randn(STATE_ROWS), np.zeros(STATE_ROWS),
                              rs.randn(STATE_ROWS, STATE_DIM)):
        buf.add_sample(o, a, r, d, no)
    group = mesh.groups["data"]
    out = {}
    for algo in ("iql", "cql"):
        idx = rs.randint(0, STATE_ROWS, (STATE_PARITY_STEPS, IQL_BATCH))
        pair = [state_rl_trainer(algo, g) for g in (None, group)]
        ref = train_many(pair[0], STATE_PARITY_STEPS, IQL_BATCH, buf, indices=idx)
        got = train_many_dp(pair[1], mesh, STATE_PARITY_STEPS, IQL_BATCH, buf, indices=idx)
        objs = [[t.policy, t.critic, t.target_q, t.policy_opt, t.critic_opt]
                + ([t.log_alpha, t.alpha_opt] if algo == "cql" else []) for t in pair]
        same = ({k: v.item() for k, v in got.items()} == {k: v.item() for k, v in ref.items()}
                and state_checksum(*objs[0]) == state_checksum(*objs[1]))
        print(f"dp rl nccl state {algo}: train_many_dp and train_many, {STATE_PARITY_STEPS} "
              f"steps on the same rows: {'bit-equal' if same else 'DIFFER'}")
        if not same:
            fail(f"dp rl nccl state {algo}: train_many_dp differs from train_many")
        pair = [state_rl_trainer(algo, g) for g in (None, group)]
        runs = dict(single=lambda n, t=pair[0]: train_many(t, n, IQL_BATCH, buf),
                    dp=lambda n, t=pair[1]: train_many_dp(t, mesh, n, IQL_BATCH, buf))
        for run in runs.values():
            run(2)
        seconds = dict(single=0.0, dp=0.0)
        for who in ("single", "dp", "dp", "single"):
            ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
            with HostWindow() as window:
                m = runs[who](STATE_STEPS)
            seconds[who] += window.wall
            if who == "dp":
                launches["fwd"] += ck.fused_mat_norm.launches
                launches["bwd"] += ck.fused_mat_norm_bwd.launches
            if not all(torch.isfinite(v) for v in m.values()):
                fail(f"dp rl nccl state {algo}: non-finite metrics")
        sps, single_sps = (2 * STATE_STEPS / seconds[w] for w in ("dp", "single"))
        print(f"dp rl nccl world 1 state {algo} (256 x 2, batch {IQL_BATCH}, {STATE_ROWS} rows):"
              f" {sps:.2f} DP steps/sec, the single-process loop in turns {single_sps:.2f}, "
              f"DP / single {sps / single_sps:.3f} on {card}")
        out[algo] = dict(sps=sps, single_sps=single_sps)
    return out


def gloo_rl_buffer(latent: dict):
    """The SLAC buffer of phase 21b: DP_RL_ROWS seeded real 100px rows."""
    slac = make_slac("cuda", SLAC_BATCH, 4000)
    slac.buffer.ingest_real(slac_dataset(DP_RL_ROWS // 1000, 1000, seed=91))
    return slac.buffer


def dp_rl_gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of phase 21b (gloo, every rank on this card): per
    configuration, one f32 step (TF32 off) on its rows of the global parity
    draws, the latent model's leaky-ReLU slopes of its rows of the card's
    single-process step replayed (rank 0 saves its record), then one warm-up
    and DP_RL_GLOO_STEPS timed ``train_many_dp`` (or ELBO) steps at the
    shipped batches with cuDNN TF32; the ranks' state checksums must agree
    after every step."""
    import torch
    import torch.distributed as dist

    from s2p_tpu_torch.gan import cuda_kernels as ck
    from s2p_tpu_torch.parallel import MeshSpec, make_mesh, shard_batch, state_checksum
    from s2p_tpu_torch.parallel.distributed import initialize_distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh(MeshSpec(data=world))
    spec = torch.load(os.path.join(out_dir, "spec.pt"), weights_only=False)
    buffer = gloo_rl_buffer(spec["latent"])
    report = dict(rank=rank, steps={})
    for kind in DP_RL_KINDS:
        torch.backends.cudnn.allow_tf32 = False
        tr, slac = rl_member(kind, mesh.groups["data"], spec["latent"], buffer)
        run = rl_runner(kind, tr, slac, mesh)
        slopes = SlopeMasks()
        slopes.masks = torch.load(os.path.join(out_dir, f"slopes_{kind}{rank}.pt"))

        def f32_step():
            with slopes.replay():
                return rl_step(kind, tr, slac, shard_batch(mesh, spec["draws"][kind]))

        steps = [("f32 parity", f32_step), ("warm-up", lambda: run(1))]
        steps += [("timed", lambda: run(1))] * DP_RL_GLOO_STEPS
        rows = []
        for i, (name, fn) in enumerate(steps):
            if i == 1:
                torch.backends.cudnn.allow_tf32 = True
            ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            sums = [None] * world
            dist.all_gather_object(sums, state_checksum(*rl_state(kind, tr, slac)))
            if i == 0 and rank == 0:
                torch.save(rl_record(kind, tr, slac, metrics),
                           os.path.join(out_dir, f"{kind}.pt"))
            if len(set(sums)) != 1:
                raise RuntimeError(f"rank {rank}: {kind} state checksums differ after step "
                                   f"{i + 1}: {sums}")
            rows.append(dict(name=name, seconds=seconds, checksum=sums[0],
                             launches=[ck.fused_mat_norm.launches,
                                       ck.fused_mat_norm_bwd.launches]))
        report["steps"][kind] = rows
        report.setdefault("flips", {})[kind] = slopes.flips
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def phase_dp_rl_gloo(card: str, latent: dict) -> dict:
    """Phase 21b: DP_WORLD gloo ranks on this one card (spawned), on phase
    21a's three configurations over DP_RL_ROWS seeded real rows: each rank's
    f32 step on its rows of a global batch of DP_RL_PARITY_BATCH rows and
    windows, held to the card's single-process f32 step on the whole batch
    (phase 7's floors), with the latent model's leaky-ReLU slopes of the
    single-process step replayed in the ranks (``SlopeMasks``: a
    pre-activation within f32 noise of zero takes the other slope at
    another batch size, and one such flip in the decoder moved a weight
    gradient by 2e-4 of the largest; the flips are counted); every step's
    state bit-identical across the ranks; the rate: gloo through the host
    on one card, a correctness check and not a multi-card number."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_rl_", dir="build") as out_dir:
        return _phase_dp_rl_gloo(card, latent, out_dir)


def _phase_dp_rl_gloo(card: str, latent: dict, out_dir: str) -> dict:
    import torch

    from s2p_tpu_torch.parallel.distributed import spawn_ranks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    buffer = gloo_rl_buffer(latent)
    draws, single = {}, {}
    for i, kind in enumerate(DP_RL_KINDS):
        draws[kind] = rl_draws(kind, DP_RL_PARITY_BATCH, DP_RL_PARITY_BATCH, len(buffer),
                               seed=120 + i)
        tr, slac = rl_member(kind, None, latent, buffer)
        masks = SlopeMasks()
        with masks.record():
            single[kind] = rl_record(kind, tr, slac, rl_step(kind, tr, slac, draws[kind]))
        for r in range(DP_WORLD):
            torch.save(masks.shard(r, DP_WORLD).masks,
                       os.path.join(out_dir, f"slopes_{kind}{r}.pt"))
    del buffer, tr, slac
    torch.save(dict(latent=latent, draws=draws), os.path.join(out_dir, "spec.pt"))
    try:
        spawn_ranks(dp_rl_gloo_rank, DP_WORLD, (out_dir,), timeout=600)
    except RuntimeError as err:
        fail(f"dp rl gloo: {err}")
    reports = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    out = dict(launches=[0, 0])
    for kind in DP_RL_KINDS:
        name = DP_RL_NAMES[kind]
        got = torch.load(os.path.join(out_dir, f"{kind}.pt"), weights_only=False)
        hold_to_single(f"dp rl gloo {name}: the f32 step of {DP_WORLD} ranks (global batch "
                       f"{DP_RL_PARITY_BATCH}) against the card's single-process step", got,
                       single[kind])
        timed = [s for s in reports[0]["steps"][kind] if s["name"] == "timed"]
        seconds = sum(s["seconds"] for s in timed)
        for rep in reports:
            for s in rep["steps"][kind]:
                out["launches"] = [a + b for a, b in zip(out["launches"], s["launches"])]
        print(f"dp rl gloo {name}: the latent model's leaky-ReLU slopes replayed from the "
              f"single-process step; entries whose own sign differs, by rank: "
              f"{[rep['flips'][kind] for rep in reports]}")
        print(f"dp rl gloo {name} ({DP_WORLD} ranks through the host on one card; gloo's host "
              f"staging, not a multi-card rate): {len(timed) / seconds:.3f} steps/sec, "
              f"{seconds / len(timed) * 1e3:.1f} ms per step; checksums "
              f"{[s['checksum'] for s in reports[0]['steps'][kind]]} the same on every rank "
              f"after every step on {card}")
        out[kind] = len(timed) / seconds
    if any(out["launches"]):
        fail(f"dp rl gloo launched the MAT-norm kernels: {out['launches']}")
    return out


# -- phase 22: the collection loop -----------------------------------------------

class CollectStubEnv:
    """What ``collect_dataset.collect`` needs of cheetah-run without MuJoCo:
    a 17-dim state (qpos[1:] and qvel), 6 actions in [-1, 1] from a seeded
    action space, ``physics.data.qpos``/``qvel`` (9 + 9) and
    ``physics.model.nq``, seeded linear dynamics and cheetah's 250-step
    horizon. ``stamps`` holds the host time of every step."""

    def __init__(self, seed: int) -> None:
        from types import SimpleNamespace

        import numpy as np

        from s2p_tpu_torch.envs import Box

        self.observation_space = Box(-np.inf, np.inf, shape=(STATE_DIM,))
        self.action_space = Box(-np.ones(ACT_DIM), np.ones(ACT_DIM))
        self.action_space.seed(seed)
        self._max_episode_steps = CHEETAH_HORIZON
        self._rs = np.random.RandomState(seed)
        self._mix = 0.1 * self._rs.randn(9, ACT_DIM)
        self.physics = SimpleNamespace(data=SimpleNamespace(qpos=np.zeros(9), qvel=np.zeros(9)),
                                       model=SimpleNamespace(nq=9))
        self.stamps: list = []

    def _obs(self):
        import numpy as np

        d = self.physics.data
        return np.concatenate([d.qpos[1:], d.qvel]).astype(np.float32)

    def reset(self):
        d = self.physics.data
        d.qpos[:] = 0.1 * self._rs.randn(9)
        d.qvel[:] = 0.1 * self._rs.randn(9)
        self._t = 0
        return self._obs()

    def step(self, action):
        import numpy as np

        d = self.physics.data
        d.qvel[:] = 0.95 * d.qvel + self._mix @ np.clip(action, -1.0, 1.0)
        d.qpos[:] += 0.05 * d.qvel
        self._t += 1
        self.stamps.append(time.perf_counter())
        truncated = self._t >= self._max_episode_steps
        return self._obs(), float(d.qvel[0]), truncated, {"TimeLimit.truncated": truncated}


def phase_collect(ck, card: str, profile_dir: str | None) -> dict:
    """Phase 22: ``collect_dataset.collect`` (SAC 256 x 2, batch 256, one
    train step per env step after COLLECT_RANDOM random steps) for
    COLLECT_STEPS steps of ``CollectStubEnv`` on the card: the JAX script's
    keys, dtypes and shapes, finite values, the env steps/sec of the random
    and of the training phase, no MAT-norm launch (counts reset just before
    and read just after), and a profile of one SAC step."""
    import numpy as np
    import torch

    from s2p_tpu_torch.cli.collect_dataset import RECORD_KEYS, build_parser, collect
    from s2p_tpu_torch.rl import CriticSLAC, SACTrainer, TanhGaussianPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    args = build_parser().parse_args(["--num_steps", str(COLLECT_STEPS), "--start_random_steps",
                                      str(COLLECT_RANDOM), "--log_interval", "1000"])
    env = CollectStubEnv(seed=0)
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    t0 = time.perf_counter()
    ds = collect(env, args, torch.device("cuda", 0))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(launches=ck.fused_mat_norm.launches, bwd_launches=ck.fused_mat_norm_bwd.launches)
    n, R = COLLECT_STEPS, COLLECT_RANDOM
    shapes = dict(observations=(n, STATE_DIM), actions=(n, ACT_DIM), rewards=(n,),
                  next_observations=(n, STATE_DIM), terminals=(n,), timeouts=(n,),
                  qpos_qvel=(n, 18))
    if tuple(ds) != RECORD_KEYS or any(ds[k].shape != s or ds[k].dtype != np.float32
                                       for k, s in shapes.items()):
        fail(f"collect: {[(k, v.shape, v.dtype) for k, v in ds.items()]}, expected {shapes} "
             "in float32")
    if not all(np.isfinite(v).all() for v in ds.values()):
        fail("collect: non-finite values")
    if ds["timeouts"].sum() != n // CHEETAH_HORIZON or ds["terminals"].any():
        fail(f"collect: {ds['timeouts'].sum()} timeouts, {ds['terminals'].sum()} terminals")
    if launches["launches"] or launches["bwd_launches"]:
        fail(f"collect launched the MAT-norm kernels: {launches}")
    st = env.stamps
    random_sps = (R - 1) / (st[R - 1] - st[0])
    train_sps = (n - R - 1) / (st[n - 1] - st[R])
    sac = SACTrainer(TanhGaussianPolicy(STATE_DIM, SAC_HIDDEN, ACT_DIM, seed=0),
                     CriticSLAC(STATE_DIM, ACT_DIM, SAC_HIDDEN, seed=1), seed=0, device="cuda")
    rows = np.random.RandomState(0).randint(0, n, SAC_BATCH)
    batch = {k: ds[k][rows] for k in ("observations", "actions", "rewards", "terminals",
                                       "next_observations")}
    sac.train(batch)
    summary = profile_device(lambda: sac.train(batch), profile_dir, "sac_step")
    print(f"collect (SAC 256 x 2, batch {SAC_BATCH}, stub env, state 17, qpos/qvel 9 + 9): "
          f"{n} env steps in {elapsed:.2f} s ({n / elapsed:.1f} env steps/sec overall); "
          f"{R} random steps at {random_sps:.1f} env steps/sec, then one SAC step per env step "
          f"at {train_sps:.1f} env steps/sec; one SAC step {summary['launches']} launches, "
          f"idle share {summary['device_idle_share']:.3f}; return of the last episode "
          f"{ds['rewards'][-CHEETAH_HORIZON:].sum():.2f}; keys, dtypes and shapes those of "
          f"collect_dataset.py on {card}")
    return dict(launches, sps=n / elapsed, random_sps=random_sps, train_sps=train_sps,
                step_launches=summary["launches"], idle=summary["device_idle_share"])


# -- phase 23: the CURL/RAD pixel path ------------------------------------------------

def stacked_frames(frames):
    """[N, H, W, 3] uint8 frames → (obs, next_obs) [N − PIXEL_STACK, H, W,
    3·PIXEL_STACK] stacks of consecutive frames on the last axis, as
    ``envs.FrameStack`` stacks them."""
    import numpy as np

    n = len(frames) - PIXEL_STACK
    stack = lambda lo: np.concatenate([frames[lo + i:lo + i + n]  # noqa: E731
                                       for i in range(PIXEL_STACK)], axis=-1)
    return stack(0), stack(1)


def aug_cases(x):
    """(name, positional arguments, CPU draws) of every augmentation at the
    path's sizes, the draws from one seeded CPU generator."""
    import torch

    from s2p_tpu_torch.nn import augmentations as aug

    g = torch.Generator().manual_seed(230)
    B, H, W, C = x.shape
    lo, hi = PIXEL_CUTOUT
    ri = lambda a, b, shape: torch.randint(a, b, shape, generator=g)  # noqa: E731
    mask = lambda p: torch.rand(B, generator=g) < p  # noqa: E731
    cut = lambda: dict(sizes=ri(lo, hi, (B,)), h0=ri(0, H - hi, (B,)),  # noqa: E731
                       w0=ri(0, W - hi, (B,)))
    u = lambda a, b, shape: aug._uniform(g, a, b, shape, "cpu")  # noqa: E731
    return [
        ("crop", (PIXEL_CROP,), dict(h=ri(0, H - PIXEL_CROP + 1, (B,)),
                                     w=ri(0, W - PIXEL_CROP + 1, (B,)))),
        ("translate", (PIXEL_TRANSLATE,), dict(h=ri(0, PIXEL_TRANSLATE - H + 1, (B,)),
                                               w=ri(0, PIXEL_TRANSLATE - W + 1, (B,)))),
        ("grayscale", (0.3,), dict(mask=mask(0.3))),
        ("cutout", PIXEL_CUTOUT, cut()),
        ("cutout_color", PIXEL_CUTOUT, dict(color=ri(0, 255, (B, C)), **cut())),
        ("flip", (0.2,), dict(mask=mask(0.2))),
        ("rotation", (0.3,), dict(mask=mask(0.3), rot=ri(1, 4, (B,)))),
        ("convolution", (), dict(weights=u(-1.0, 1.0, (B, 3, 3, C, C)))),
        ("color_jitter", (), dict(b=u(0.6, 1.4, (B, 1, 1, 1)), c=u(0.6, 1.4, (B, 1, 1, 1)))),
        ("no_aug", (), {}),
    ]


def pixel_nets(device, dtype, seed=0):
    """The critic, its target copy, the policy with an encoder and CURL over
    the critic's encoder, seeded, in ``dtype`` on ``device``."""
    from s2p_tpu_torch.rl import CURL, EncoderCritic, PixelEncoder, TanhGaussianPolicyWithEncoder

    shape = (PIXEL_CROP, PIXEL_CROP, 3 * PIXEL_STACK)
    critic = EncoderCritic(PixelEncoder(shape, seed=seed, device=device, **PIXEL_ENC), ACT_DIM,
                           PIXEL_HIDDEN, seed=seed + 1).to(dtype)
    policy = TanhGaussianPolicyWithEncoder(
        PixelEncoder(shape, seed=seed + 2, device=device, **PIXEL_ENC), ACT_DIM, PIXEL_HIDDEN,
        seed=seed + 3).to(dtype)
    curl = CURL(critic.encoder, seed=seed + 4).to(dtype)
    return critic, copy.deepcopy(critic).requires_grad_(False), policy, curl


def pixel_losses(critic, target, curl, b):
    """The critic's twin-Q TD loss against the target copy (discount 0.99)
    and CURL's loss on (anchor, positive) crops."""
    import torch

    from s2p_tpu_torch.rl import curl_loss

    with torch.no_grad():
        nq1, nq2 = target(b["next_obs"], b["next_actions"])
        q_target = b["rewards"] + 0.99 * (1.0 - b["terminals"]) * torch.minimum(nq1, nq2)
    q1, q2 = critic(b["obs"], b["actions"])
    critic_loss = ((q1 - q_target) ** 2).mean() + ((q2 - q_target) ** 2).mean()
    return critic_loss, curl_loss(curl(b["anchor"], b["positive"])), q1


def pixel_parity_step(critic, target, policy, curl, b, eps_pi) -> dict:
    """One f32/f64 step's record: the losses, the policy's sample and
    log-prob (its encoder detached, as by default), the gradients of the
    critic (+ CURL's W) from critic + CURL loss, and of the policy from
    mean(0.1·log π − min Q) with the critic's encoder detached."""
    import torch

    critic_loss, c_loss, q1 = pixel_losses(critic, target, curl, b)
    (critic_loss + c_loss).backward()
    a, log_pi = policy(b["obs"]).sample_and_log_prob(eps=eps_pi)
    q1_pi, q2_pi = critic(b["obs"], a, detach_encoder=True)
    policy_loss = (0.1 * log_pi - torch.minimum(q1_pi, q2_pi).squeeze(-1)).mean()
    names, params = zip(*policy.named_parameters())
    grads = torch.autograd.grad(policy_loss, params, allow_unused=True)
    metrics = dict(critic_loss=critic_loss.item(), curl_loss=c_loss.item(),
                   policy_loss=policy_loss.item(), log_pi=log_pi.mean().item(),
                   q1=q1.mean().item(), action_abs=a.abs().mean().item())
    return dict(metrics=metrics,
                critic_grad=_f64((k, p.grad) for k, p in critic.named_parameters()),
                curl_w_grad=_f64([("W", curl.W.grad)]),
                policy_grad=_f64((k, g) for k, g in zip(names, grads) if g is not None),
                actions=_f64([("a", a), ("log_pi", log_pi)]))


def phase_pixel_rl(ck, card: str, frames, profile_dir: str | None) -> dict:
    """Phase 23: the CURL/RAD pixel path at full width on stacks of phase
    11's bridge frames. (a) every augmentation on the card against the CPU
    on the same draws; (b) one f32 step, TF32 off, on the card and on the
    CPU in f32 and f64 (the CPU's ReLU slopes in the encoders replayed from
    the card's step), held as phase 7 holds its step; (c) pixel updates/sec
    (crop → critic + CURL loss → backward → Adam), with one update's
    launches, device ms and idle share, and no MAT-norm launch."""
    import numpy as np
    import torch

    from s2p_tpu_torch.nn import augmentations as aug

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    obs_np, next_np = stacked_frames(frames)
    n = len(obs_np)
    print(f"pixel rl: {n} stacks of {PIXEL_STACK} {frames.shape[1]}px frames (phase 11's bridge), "
          f"{obs_np.shape[-1]} channels")
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0

    # (a) the augmentations, card vs CPU on one batch
    x_cpu = torch.from_numpy(obs_np[:PIXEL_BATCH])
    x_gpu = x_cpu.cuda()
    for name, args, draws in aug_cases(x_cpu):
        xc, xg = (x_cpu[..., :3], x_gpu[..., :3]) if name == "grayscale" else (x_cpu, x_gpu)
        fn = aug.AUGMENTATIONS[name]
        ref = fn(None, xc, *args, **draws)
        got = fn(None, xg, *args, **draws)
        ms = time_ms(lambda: fn(None, xg, *args, **draws), iters=10, warmup=2)
        diff = (got.cpu().int() - ref.int()).abs()
        share = (diff > 0).double().mean().item()
        exact = name not in ("grayscale", "convolution", "color_jitter")
        limit = ("bit-equal required" if exact
                 else f"limit {BRIDGE_MAX_DIFF} step on <= {BRIDGE_DIFF_SHARE} of them")
        print(f"pixel aug {name}: {tuple(got.shape)} {got.dtype}, max |card - cpu| "
              f"{diff.max().item()} uint8 steps on {share:.3g} of the values ({limit}); "
              f"{ms:.4f} ms a call on {card}")
        if got.shape != ref.shape or got.dtype != torch.uint8:
            fail(f"pixel aug {name}: {tuple(got.shape)} {got.dtype}, CPU {tuple(ref.shape)}")
        if exact and share > 0:
            fail(f"pixel aug {name}: the card differs from the CPU on {share:.3g} of the values")
        if diff.max().item() > BRIDGE_MAX_DIFF or share > BRIDGE_DIFF_SHARE:
            fail(f"pixel aug {name}: {diff.max().item()} steps on {share:.3g} of the values")
    # grayscale takes RGB only: the whole stack raises on the card as on the CPU
    # (JAX's contraction with three weights raises on it)
    raised = {}
    for where, x in (("cpu", x_cpu), ("card", x_gpu)):
        try:
            aug.random_grayscale(None, x, 0.3)
        except ValueError as err:
            raised[where] = str(err)
    print(f"pixel aug grayscale on the {x_cpu.shape[-1]}-channel stack: raises ValueError on "
          f"{sorted(raised) or 'neither'} ({raised.get('card')})")
    if set(raised) != {"cpu", "card"}:
        fail(f"pixel aug grayscale: the {x_cpu.shape[-1]}-channel stack must raise ValueError "
             f"on the card and the CPU; raised on {sorted(raised)}")

    # (b) one step in f32 on the card, f32 and f64 on the CPU
    g = torch.Generator().manual_seed(231)
    P, A = PIXEL_PARITY_BATCH, ACT_DIM
    crop = lambda x, s: aug.random_crop(torch.Generator().manual_seed(s),  # noqa: E731
                                        torch.from_numpy(x[:P]), PIXEL_CROP)
    unit = lambda t: t.double() * (1.0 / 255.0)  # noqa: E731
    host = dict(obs=unit(crop(obs_np, 1)), next_obs=unit(crop(next_np, 2)),
                anchor=unit(crop(obs_np, 3)), positive=unit(crop(obs_np, 4)),
                actions=torch.rand(P, A, generator=g, dtype=torch.float64) * 2 - 1,
                next_actions=torch.rand(P, A, generator=g, dtype=torch.float64) * 2 - 1,
                rewards=torch.randn(P, 1, generator=g, dtype=torch.float64),
                terminals=(torch.rand(P, 1, generator=g) < 0.1).double())
    eps_pi = torch.randn(P, A, generator=g, dtype=torch.float64)
    masks, runs = SlopeMasks(), {}
    for i, (name, device, dtype) in enumerate((PARITY_RUNS[2], PARITY_RUNS[0], PARITY_RUNS[1])):
        dtype = getattr(torch, dtype)
        nets = pixel_nets(device, dtype)
        b = {k: v.to(device, dtype) for k, v in host.items()}
        t0 = time.time()
        on_card = i == 0  # the card's step first: its slopes are replayed on the CPU
        with (masks.record() if on_card else masks.replay()):
            runs[name] = pixel_parity_step(*nets, b, eps_pi.to(device, dtype))
        flips = "" if on_card else f", {masks.flips} encoder ReLU slopes flipped from the card's"
        print(f"parity pixel step {name}: {time.time() - t0:.1f} s{flips}; "
              + ", ".join(f"{k} {v:.8g}" for k, v in runs[name]["metrics"].items()))
    pick = lambda key: {k: r[key] for k, r in runs.items()}  # noqa: E731
    hold_to_f64("pixel step metrics", pick("metrics"), "metric")
    hold_to_f64("pixel policy sample and log-prob", pick("actions"), "grad")
    for part in ("critic_grad", "curl_w_grad", "policy_grad"):
        hold_to_f64(f"pixel {part.replace('_', ' ')}ients", pick(part), "grad")
    fc_in = runs["cuda f32"]["critic_grad"]["encoder.fc.weight"].shape[1]
    if fc_in != 35 * 35 * PIXEL_ENC["num_filters"]:
        fail(f"pixel encoder fc fan-in {fc_in}, expected OUT_DIM_84[4]^2 x 32")
    conv_pol = runs["cuda f32"]["policy_grad"]
    if any(k.startswith("encoder.conv") for k in conv_pol):
        fail("pixel policy: its encoder's convs got a gradient (it detaches by default)")

    # (c) the rate: crop -> critic + CURL loss -> backward -> Adam
    critic, target, _, curl = pixel_nets("cuda", torch.float32)
    params = list(critic.parameters()) + [curl.W]
    opt = torch.optim.Adam(params, lr=PIXEL_LR)
    obs_gpu, next_gpu = torch.from_numpy(obs_np).cuda(), torch.from_numpy(next_np).cuda()
    gen = torch.Generator(device="cuda").manual_seed(232)
    inv255 = torch.tensor(np.float32(1) / np.float32(255), device="cuda")
    rs = np.random.RandomState(233)
    rows = torch.from_numpy(rs.randint(0, n, (PIXEL_STEPS + 3, PIXEL_BATCH))).cuda()
    act = torch.from_numpy(rs.uniform(-1, 1, (n, ACT_DIM)).astype(np.float32)).cuda()
    rew = torch.from_numpy(rs.randn(n, 1).astype(np.float32)).cuda()

    def update(i):
        idx = rows[i]
        o, no = obs_gpu[idx], next_gpu[idx]
        c = lambda x: aug.random_crop(gen, x, PIXEL_CROP).float() * inv255  # noqa: E731
        b = dict(obs=c(o), next_obs=c(no), anchor=c(o), positive=c(o), actions=act[idx],
                 next_actions=act[idx], rewards=rew[idx], terminals=torch.zeros_like(rew[idx]))
        critic_loss, c_loss, _ = pixel_losses(critic, target, curl, b)
        opt.zero_grad(set_to_none=True)
        (critic_loss + c_loss).backward()
        opt.step()
        return critic_loss, c_loss

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 15
    torch.backends.cuda.matmul.allow_tf32 = False
    first = [v.item() for v in update(0)]
    update(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PIXEL_STEPS):
        losses = update(2 + i)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    last = [v.item() for v in losses]
    summary = profile_device(lambda: update(2 + PIXEL_STEPS), profile_dir, "pixel_update")
    launches = dict(launches=ck.fused_mat_norm.launches, bwd_launches=ck.fused_mat_norm_bwd.launches)
    if not all(np.isfinite(first + last)):
        fail(f"pixel updates: non-finite losses {first} -> {last}")
    if launches["launches"] or launches["bwd_launches"]:
        fail(f"the pixel path launched the MAT-norm kernels: {launches}")
    print(f"pixel rl (encoder 50 / 4 x 32, heads 1024 x 2, 9 x 84 x 84 crops of 100px stacks, "
          f"batch {PIXEL_BATCH}, f32 with cuDNN TF32): {PIXEL_STEPS} updates in {elapsed:.2f} s, "
          f"{PIXEL_STEPS / elapsed:.2f} pixel updates/sec; one update {summary['launches']} "
          f"launches, {summary['device_busy_ms']:.3f} ms of device time, idle share "
          f"{summary['device_idle_share']:.3f}; critic + CURL loss {first[0]:.4f} + {first[1]:.4f} "
          f"-> {last[0]:.4f} + {last[1]:.4f} on {card}")
    return dict(launches, ups=PIXEL_STEPS / elapsed, step_launches=summary["launches"],
                device_ms=summary["device_busy_ms"], idle=summary["device_idle_share"])


# -- phase 24: the goal-conditioned and multitask path -------------------------------------

def phase_goal_multitask(ck, card: str) -> dict:
    """Phase 24: ``GoalConditionedPathCollector`` with a port
    ``TanhGaussianPolicy`` on the card fills ``ObsDictRelabelingBuffer`` from
    ``testing.goal_env.PointRobotGoalEnv``; its relabelled batches (rewards
    recomputed on the host and checked) train ``SACTrainer`` on the card,
    after one such step is held to f64 as phase 16 holds its SAC step; then
    ``MetaRLAlgorithm`` over ``MultiTaskReplayBuffer`` on the point robot,
    SAC on the flattened [tasks, batch] batches. Env steps/sec and SAC
    steps/sec; no MAT-norm launch."""
    import numpy as np
    import torch

    from s2p_tpu_torch.data import MetaRLAlgorithm, MultiTaskReplayBuffer, ObsDictRelabelingBuffer
    from s2p_tpu_torch.envs import PointRobotEnv
    from s2p_tpu_torch.rl import CriticSLAC, SACTrainer, TanhGaussianPolicy
    from s2p_tpu_torch.samplers import GoalConditionedPathCollector, MdpPathCollector, PolicyAgent
    from s2p_tpu_torch.testing.goal_env import PointRobotGoalEnv, TaskBatchTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    env = PointRobotGoalEnv(num_tasks=10, max_episode_steps=20, seed=0)
    obs_dim, A = 4, 2
    policy = TanhGaussianPolicy(obs_dim, SAC_HIDDEN, A, seed=0).cuda()
    sac = SACTrainer(policy, CriticSLAC(obs_dim, A, SAC_HIDDEN, seed=1), seed=0, device="cuda")
    collector = GoalConditionedPathCollector(env, PolicyAgent(policy, seed=0))
    her = ObsDictRelabelingBuffer(GOAL_BUFFER, env, fraction_goals_rollout_goals=0.2)
    collector.collect_new_paths(20, 20, discard_incomplete_paths=False)  # warm-up
    t0 = time.perf_counter()
    for path in collector.collect_new_paths(20, GOAL_ENV_STEPS, discard_incomplete_paths=False):
        her.add_path(path)
    env_s = time.perf_counter() - t0
    if len(her) != GOAL_ENV_STEPS:
        fail(f"goal: the HER buffer holds {len(her)} rows, expected {GOAL_ENV_STEPS}")
    rs = np.random.RandomState(240)
    batch = her.random_batch(SAC_BATCH, rs)
    achieved = batch["next_observations"][:, :2]  # the next position is the achieved goal
    want = env.compute_rewards(achieved, batch["resampled_goals"]).reshape(-1, 1)
    if batch["observations"].shape != (SAC_BATCH, obs_dim) or not np.array_equal(
            batch["rewards"], want):
        fail("goal: the relabelled batch's rewards are not the env's for its goals")

    pick = lambda out, key: {n: r[key] for n, r in out.items()}  # noqa: E731
    draws = dict(pi=rs.randn(SAC_BATCH, A), next=rs.randn(SAC_BATCH, A))
    out = {}
    for name, device, dtype in PARITY_RUNS:
        dtype = getattr(torch, dtype)
        tr = SACTrainer(TanhGaussianPolicy(obs_dim, SAC_HIDDEN, A, seed=3).to(dtype),
                        CriticSLAC(obs_dim, A, SAC_HIDDEN, seed=4).to(dtype), seed=0, device=device)
        r = dict(metrics={k: v.item() for k, v in tr.train(batch, draws=draws).items()})
        r["critic_grad"] = _f64((k, p.grad) for k, p in tr.critic.named_parameters()
                                if p.grad is not None)
        out[name] = r
    hold_to_f64("goal SAC step on a HER batch, metrics", pick(out, "metrics"), "metric")
    hold_to_f64("goal SAC step on a HER batch, critic gradients", pick(out, "critic_grad"), "grad")

    batches = [her.random_batch(SAC_BATCH, rs) for _ in range(GOAL_SAC_STEPS + 2)]
    for b in batches[:2]:
        sac.train(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:]:
        metrics = sac.train(b)
    torch.cuda.synchronize()
    sac_s = time.perf_counter() - t0
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        fail(f"goal SAC: non-finite metrics {metrics}")

    point = PointRobotEnv(num_tasks=10, max_episode_steps=20, seed=1)
    flat = TanhGaussianPolicy(2, SAC_HIDDEN, A, seed=5).cuda()
    meta_sac = SACTrainer(flat, CriticSLAC(2, A, SAC_HIDDEN, seed=6), seed=1, device="cuda")
    mtb = MultiTaskReplayBuffer(GOAL_BUFFER, point, point.get_all_task_idx(), device="cuda")
    meta_collector = MdpPathCollector(point, PolicyAgent(flat, seed=1))
    trainer = TaskBatchTrainer(meta_sac)
    algo = MetaRLAlgorithm(point, trainer, mtb,
                           lambda task: meta_collector.collect_new_paths(20, 20, False),
                           point.get_all_task_idx(), num_iterations=META_ITERS,
                           num_tasks_per_itr=10, num_train_steps_per_itr=META_TRAIN_STEPS,
                           meta_batch=META_TASKS, batch_size=META_BATCH, seed=2)
    t0 = time.perf_counter()
    algo.train()
    torch.cuda.synchronize()
    meta_s = time.perf_counter() - t0
    meta_env = sum(mtb.num_steps_can_sample(t) for t in point.get_all_task_idx())
    launches = dict(launches=ck.fused_mat_norm.launches, bwd_launches=ck.fused_mat_norm_bwd.launches)
    if meta_env != META_ITERS * 10 * 20 or trainer.n_train_calls != META_ITERS * META_TRAIN_STEPS:
        fail(f"meta loop: {meta_env} env steps, {trainer.n_train_calls} SAC steps")
    if not np.isfinite(list(meta_sac.get_diagnostics().values())).all():
        fail(f"meta loop: non-finite diagnostics {meta_sac.get_diagnostics()}")
    if launches["launches"] or launches["bwd_launches"]:
        fail(f"the goal/multitask path launched the MAT-norm kernels: {launches}")
    res = dict(launches, env_sps=GOAL_ENV_STEPS / env_s, sac_sps=GOAL_SAC_STEPS / sac_s,
               meta_s=meta_s)
    print(f"goal (point robot, goal-conditioned collection, TanhGaussianPolicy 256 x 2 on the "
          f"card): {GOAL_ENV_STEPS} env steps in {env_s:.2f} s, {res['env_sps']:.1f} env steps/sec; "
          f"SAC 256 x 2 on relabelled HER batches of {SAC_BATCH}: {GOAL_SAC_STEPS} steps in "
          f"{sac_s:.2f} s, {res['sac_sps']:.1f} SAC steps/sec; meta loop: {META_ITERS} iterations "
          f"of 10 tasks x 20 env steps then {META_TRAIN_STEPS} SAC steps on {META_TASKS} tasks x "
          f"{META_BATCH} rows ({meta_env} env steps, {trainer.n_train_calls} SAC steps) in "
          f"{meta_s:.2f} s; policy loss {meta_sac.get_diagnostics()['policy_loss']:.4f} on {card}")
    return res


# -- phase 25: the dry run (cli.dryrun, the port of __graft_entry__.py) ------

DRYRUN_SEED = 250


@contextlib.contextmanager
def generator_norm(fn):
    """The generator's MAT norm replaced by ``fn`` (the plain version, or a
    recorder) inside the block."""
    from s2p_tpu_torch.gan import generator as gen_module

    kernel = gen_module.fused_mat_norm
    gen_module.fused_mat_norm = fn
    try:
        yield
    finally:
        gen_module.fused_mat_norm = kernel


def phase_dryrun(ck, card: str, norms_per_step: int) -> dict:
    """Phase 25: ``cli.dryrun``. (a) ``entry()`` on the card (the full-width
    forward, f32, TF32 off) on seeded inputs: its launches in one call
    (counts reset just before), each of its norms' kernel output against
    the plain version on the same inputs (F32_TOL), and the whole forward
    against the same forward with the plain norm on the card and on the
    CPU (``entry(device="cpu")``, the same seed's weights) within
    ROLLOUT_TOL; ms a call with the kernel and with the plain norm.
    (b) ``dryrun_multichip(2)`` and (c) ``dryrun_multichip(4)``: gloo ranks
    sharing this card (NCCL with a card a rank), every leg; (d) with another
    count of cards (≥ 2), ``dryrun_multichip(device_count)`` over NCCL.
    Each rank's launches per
    leg come back in its record and must be the legs' norms: 2 forward and
    1 backward a G step (GAN legs), 2 forwards (the TP leg's unsharded and
    sharded ones), none in the RL legs. Every trained leg must leave the
    ranks' parameters bit-equal (``dryrun_multichip`` raises otherwise) and
    the state legs within ``dw.STATE_TOL`` of one process's ``train_many``
    (the ranks raise otherwise). Phases 3 and 6 hold both kernels against
    their plain versions at the ranks' shapes (``parallel_norm_cases``)."""
    import numpy as np
    import torch

    from s2p_tpu_torch.cli import dryrun
    from s2p_tpu_torch.testing import dryrun_worker as dw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    fn, (state0, prev0) = dryrun.entry()
    rs = np.random.RandomState(DRYRUN_SEED)
    state = torch.from_numpy(rs.randn(*state0.shape).astype(np.float32))
    prev = torch.from_numpy((rs.rand(*prev0.shape) * 2 - 1).astype(np.float32))
    state_gpu, prev_gpu = state.cuda(), prev.cuda()
    if not torch.isfinite(fn(state0, prev0)).all():  # JAX's example arguments
        fail("dryrun entry: non-finite output on the zero example arguments")
    torch.cuda.synchronize()
    ck.fused_mat_norm.launches = ck.fused_mat_norm_bwd.launches = 0
    out = fn(state_gpu, prev_gpu)
    torch.cuda.synchronize()
    entry_launches = ck.fused_mat_norm.launches
    if entry_launches != norms_per_step or ck.fused_mat_norm_bwd.launches:
        fail(f"dryrun entry: {entry_launches} forward and {ck.fused_mat_norm_bwd.launches} "
             f"backward MAT-norm launches a call, expected {norms_per_step} and 0")
    # the comparisons (their launches are not the path's)
    seen = []

    def record(x, g, b, *rest):
        seen.append((x.clone(), g.clone(), b.clone()))
        return ck.fused_mat_norm(x, g, b, *rest)

    with generator_norm(record):
        fn(state_gpu, prev_gpu)
    norm_err = 0.0
    for x, g, b in seen:
        err = (ck.fused_mat_norm(x, g, b) - ck.fused_mat_norm_plain(x, g, b)).abs().max().item()
        norm_err = max(norm_err, err)
    with generator_norm(ck.fused_mat_norm_plain):
        out_plain = fn(state_gpu, prev_gpu)
        plain_ms = time_ms(lambda: fn(state_gpu, prev_gpu))
    ms = time_ms(lambda: fn(state_gpu, prev_gpu))
    fn_cpu, _ = dryrun.entry(device="cpu")
    out_cpu = fn_cpu(state, prev)
    vs_plain = (out - out_plain).abs().max().item()
    vs_cpu = (out.cpu() - out_cpu).abs().max().item()
    print(f"dryrun entry: S2PGenerator(64px, ngf 64) f32 forward at batch {state0.shape[0]}, "
          f"{entry_launches} fused_mat_norm launches a call; its {len(seen)} norms kernel vs "
          f"plain max |err| {norm_err:.3g} (limit {F32_TOL}); forward vs the plain norm on the "
          f"card {vs_plain:.3g}, vs the CPU {vs_cpu:.3g} (limit {ROLLOUT_TOL}); {ms:.3f} ms a "
          f"call, {plain_ms:.3f} ms with the plain norm, on {card}")
    if len(seen) != norms_per_step or norm_err > F32_TOL:
        fail(f"dryrun entry: {len(seen)} norms, kernel vs plain {norm_err:.3g}")
    if out.shape != prev0.shape or not torch.isfinite(out).all():
        fail(f"dryrun entry: bad output {tuple(out.shape)}")
    if vs_plain > ROLLOUT_TOL or vs_cpu > ROLLOUT_TOL:
        fail(f"dryrun entry: the forward is {vs_plain:.3g} from the plain norm's on the card "
             f"and {vs_cpu:.3g} from the CPU's")

    k_gan, k_tp = (sum(v.values()) for v in dryrun_norm_shapes().values())
    expected = dict(gan=(2 * k_gan, k_gan), gan_dp_scan=(2 * k_gan * dw.GAN_DP_STEPS,
                                                           k_gan * dw.GAN_DP_STEPS),
                    tp=(2 * k_tp, 0))
    worlds = dryrun_worlds()
    launches = [entry_launches, 0]
    runs = {}
    for label, world in worlds:
        t0 = time.time()
        try:
            res = dryrun.dryrun_multichip(world)
        except RuntimeError as err:
            fail(f"dryrun {label}: {err}")
        wall = time.time() - t0
        legs = dw.leg_names(world)
        if [rec["name"] for rec in res["ranks"][0]["legs"]] != legs or len(res["lines"]) != len(
                legs):
            fail(f"dryrun {label}: legs {[rec['name'] for rec in res['ranks'][0]['legs']]}")
        per_leg = {}
        for rank in res["ranks"]:
            for rec in rank["legs"]:
                got, want = tuple(rec["launches"]), expected.get(rec["name"], (0, 0))
                if got != want:
                    fail(f"dryrun {label} rank {rank['rank']} {rec['name']}: MAT-norm launches "
                         f"{got}, expected {want}")
                launches[0] += got[0]
                launches[1] += got[1]
                per_leg[rec["name"]] = max(per_leg.get(rec["name"], 0.0), rec["seconds"])
        if "tp" in legs:
            err = max(leg["metrics"]["max_abs_err"] for rank in res["ranks"]
                      for leg in rank["legs"] if leg["name"] == "tp")
            if not err < dw.TP_TOL:
                fail(f"dryrun {label}: TP max |err| {err}")
        state = next(rec["metrics"] for rec in res["ranks"][0]["legs"]
                     if rec["name"] == "state_rl")
        state_err = max(state["err_iql"], state["err_cql"])
        if not state_err <= dw.STATE_TOL:
            fail(f"dryrun {label}: the state legs are {state_err} from one process's")
        runs[label] = dict(world=world, backend=res["ranks"][0]["backend"], wall_s=wall,
                           leg_s=per_leg, state_err=state_err)
        trained = sum(rec["digest"] is not None for rec in res["ranks"][0]["legs"])
        print(f"phase {label}: dryrun_multichip({world}) over {runs[label]['backend']}, "
              f"{len(legs)} legs ok in {wall:.1f} s wall (spawn included); slowest rank per leg "
              + ", ".join(f"{k} {v:.2f} s" for k, v in per_leg.items())
              + f"; parameters bit-equal on every rank after its {trained} trained legs; state "
              f"legs vs one process max |Δ| {state_err:.3g} (limit {dw.STATE_TOL}); on {card}")
    print(f"dryrun launches: entry {entry_launches}, the dry runs {launches[0] - entry_launches} "
          f"forward and {launches[1]} backward over their ranks")
    return dict(fwd=launches[0], bwd=launches[1], entry_ms=ms, entry_plain_ms=plain_ms,
                runs=runs)


SPADE_CELL = "spade-ade256-b32"  # the benchmark cell whose shapes, weights, maps and limits are used
SPADE_BATCH = 32  # its batch
SPADE_CHUNK = 8  # rows a module-path call renders in f32
SPADE_F32_TOL = 1e-5  # rtol and atol: the kernel's FMA against the plain version's two roundings


def phase_spade_norm(ck, card: str) -> dict:
    """``spade_norm`` against ``spade_norm_plain`` at every shape of a GauGAN
    pass, with its device time beside its bound (4 arrays at the HBM rate)."""
    import torch
    from portbench import harness
    from portbench.counts import spade as spade_counts

    t0 = time.time()
    ck.load_spade_library()
    print(f"build: spade_norm ({ck.SPADE_SOURCE.name}) built and loaded in "
          f"{time.time() - t0:.1f} s")
    shapes = spade_counts.norm_shapes(harness.load_cell(SPADE_CELL).config["opt"])
    if sum(shapes.values()) != 18:
        fail(f"spade_norm: {sum(shapes.values())} norms a pass, not 18")
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per_pass = {}
    before = ck.spade_norm.launches
    cases = [((h, w, c), n, strided) for (h, w, c), n in sorted(shapes.items())
             for strided in (True, False)] + [((16, 16, 30), 0, True)]  # scalar: 30 % 4 != 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        pass_ms = pass_bias = pass_bound = pass_plain = 0.0
        for (h, w, c), n, strided in cases:
            B = SPADE_BATCH if n else 2
            x = (torch.randn(B, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
            gb = torch.randn(B, h, w, 2 * c, generator=g, device="cuda").to(dtype)
            gamma, beta = (gb[..., :c], gb[..., c:]) if strided else (
                gb[..., :c].contiguous(), gb[..., c:].contiguous())
            a = torch.rand(c, generator=g, device="cuda") + 0.5
            b = torch.randn(c, generator=g, device="cuda")
            bias = gb_bias_like(x, seed=c)
            for gb_bias in (None, bias):  # without and with the folded γ‖β bias
                counted = ck.spade_norm.bias_launches
                with torch.no_grad():
                    out = ck.spade_norm(x, gamma, beta, a, b, gb_bias=gb_bias)
                    ref = ck.spade_norm_plain(x, gamma, beta, a, b, gb_bias=gb_bias)
                torch.cuda.synchronize()
                if ck.spade_norm.bias_launches - counted != (gb_bias is not None):
                    fail(f"spade_norm.bias_launches miscounted a launch at {(B, h, w, c)}")
                err = (out.float() - ref.float()).abs()
                tol = SPADE_F32_TOL if dtype == torch.float32 else BF16_TOL
                max_err[dtype] = max(max_err[dtype], err.max().item())
                if not torch.isfinite(out).all() or (err > tol + tol * ref.float().abs()).any():
                    fail(f"spade_norm vs plain at {name} {(B, h, w, c)} strided={strided}, "
                         f"gb_bias {'folded' if gb_bias is not None else 'none'}: max |err| "
                         f"{err.max().item():.3g}")
            bits = x.data_ptr() | gamma.data_ptr() | beta.data_ptr() | (2 * c * x.element_size())
            plan = ck.spade_norm_plan(B * h * w, c, dtype, bits % 16 == 0,
                                      ck._sm_count(x.device.index))
            if n == 0:
                if plan.vec:
                    fail(f"spade_norm: C={c} took the vector path")
                print(f"spade_norm {name} {(B, h, w, c)} scalar path: max |err| "
                      f"{err.max().item():.3g}")
                continue
            if not plan.vec:
                fail(f"spade_norm: {name} {(B, h, w, c)} fell to the scalar path")
            with torch.no_grad():
                ms = device_ms(lambda: ck.spade_norm(x, gamma, beta, a, b))
                bias_ms = device_ms(lambda: ck.spade_norm(x, gamma, beta, a, b, gb_bias=bias))
                plain = device_ms(lambda: ck.spade_norm_plain(x, gamma, beta, a, b), iters=5)
            elems = B * h * w * c
            bound = max(4 * elems * x.element_size() / HBM_BYTES_PER_S,
                        5 * elems / 67e12) * 1e3
            print(f"spade_norm {name} {(B, h, w, c)} strided={strided} x{n}/pass: "
                  f"{ms:.4f} ms (bound {bound:.4f}, {100 * bound / ms:.1f}%; gb_bias folded "
                  f"{bias_ms:.4f} ms, {100 * (bias_ms / ms - 1):+.2f}%), plain "
                  f"{plain:.4f} ms; plan lanes {plan.lanes} threads {plan.threads} "
                  f"grid {plan.grid}x{plan.c_tiles}; max |err| {err.max().item():.3g}")
            if strided:  # the fast path's layout
                pass_ms += n * ms
                pass_bias += n * bias_ms
                pass_bound += n * bound
                pass_plain += n * plain
        per_pass[name] = dict(ms=pass_ms, bias_ms=pass_bias, bound_ms=pass_bound,
                              plain_ms=pass_plain, roofline_pct=100 * pass_bound / pass_ms)
        print(f"spade_norm {name}, one pass at batch {SPADE_BATCH} (18 launches): "
              f"{pass_ms:.4f} ms against a bound of {pass_bound:.4f} ms "
              f"({100 * pass_bound / pass_ms:.1f}%; gb_bias folded {pass_bias:.4f} ms, "
              f"{100 * (pass_bias / pass_ms - 1):+.2f}%), plain {pass_plain:.4f} ms")
    print(f"spade_norm vs plain: max |err| f32 {max_err[torch.float32]:.3g}, bf16 "
          f"{max_err[torch.bfloat16]:.3g} (tolerance f32 rtol=atol {SPADE_F32_TOL}, bf16 "
          f"rtol=atol {BF16_TOL}); {ck.spade_norm.launches - before} launches; {card}")
    return dict(per_pass=per_pass, max_err={str(k).split(".")[-1]: v
                                            for k, v in max_err.items()})



def phase_spade_path(ck, card: str) -> dict:
    """GauGAN's main path, ``synthesize_fast``, at the ``spade-ade256-b32``
    cell's shapes and weights (ADE20K 256², ngf 64, batch 32, bf16): the
    SPADE-norm launches of one pass (18, counted from 0 just before it), its
    device time, and its frames against the module path (``gen(onehot)``) in
    f32 with TF32 off, held to the cell's limits."""
    import torch
    from portbench import harness
    from s2p_tpu_torch.gan import fuse_fast_params, label_onehot, synthesize_fast

    cell = harness.load_cell(SPADE_CELL)
    ctx = harness.Ctx(cell, 0, torch.device("cuda"))
    drv, opt, tr = cell.driver, cell.config["opt"], cell.traffic
    weights = drv.seeded_weights(ctx)
    gen = drv.build_generator(opt, weights, ctx.device, torch.bfloat16)
    params = fuse_fast_params(gen)
    ids = drv.label_maps(tr["batch"], gen.image_hw, gen.semantic_nc, tr["regions"],
                         tr["zipf_s"], ctx.generator("traffic"), ctx.device)
    with torch.no_grad():
        synthesize_fast(gen, ids, params)  # builds the kernel and warms every shape
        torch.cuda.synchronize()
        ck.spade_norm.launches = ck.spade_norm.bias_launches = 0
        frames = synthesize_fast(gen, ids, params)
        torch.cuda.synchronize()
        launches, bias_launches = ck.spade_norm.launches, ck.spade_norm.bias_launches
        if launches != 18 or bias_launches != 18:
            fail(f"synthesize_fast: {launches} spade_norm launches a pass, {bias_launches} "
                 "with the γ‖β bias folded; not 18 and 18")
        ms = time_ms(lambda: synthesize_fast(gen, ids, params), iters=10)
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        gen32 = drv.build_generator(opt, weights, ctx.device, torch.float32)
        ck.spade_norm.launches = ck.spade_norm.bias_launches = 0
        module = torch.cat([gen32(label_onehot(ids[lo:lo + SPADE_CHUNK], gen32.semantic_nc))
                            for lo in range(0, len(ids), SPADE_CHUNK)])
        if ck.spade_norm.launches == 0 or ck.spade_norm.bias_launches:
            fail(f"the module path launched spade_norm {ck.spade_norm.launches} times, "
                 f"{ck.spade_norm.bias_launches} with a folded bias; the module path folds none")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del gen32, params
    err = frames.float() - module
    gaps = dict(frame_max_gap=err.abs().max().item(),
                frame_rms_gap=err.square().mean().sqrt().item())
    saturated = (frames.float().abs() > drv.SATURATED).float().mean().item()
    print(f"GauGAN synthesize_fast, batch {len(ids)} at {gen.image_hw} bf16: {launches} "
          f"spade_norm launches a pass ({bias_launches} with the γ‖β bias folded); {ms:.3f} ms a pass ({1e3 * len(ids) / ms:.1f} "
          f"frames/s, events, host included); against the module path in f32: " +
          ", ".join(f"{k} {v:.4g} (limit {cell.limits[k]})" for k, v in gaps.items()) +
          f"; saturated share {saturated:.4f}; {card}")
    if not all(torch.isfinite(frames.float()).all().item() and v <= cell.limits[k]
               for k, v in gaps.items()):
        fail(f"synthesize_fast vs the module path: {gaps} beyond {cell.limits}")
    return dict(launches=launches, bias_launches=bias_launches, ms=ms, gaps=gaps,
                saturated_share=saturated)


STYLEGAN_CELL = "stylegan-ffhq1024-b32"  # the benchmark cell whose shapes, weights and limits are used
STYLEGAN_EPS = 1e-8  # instance_norm's epsilon in networks_stylegan.py


def phase_style_adain(ck, card: str) -> dict:
    """``fused_mat_norm`` as StyleGAN's AdaIN against ``fused_mat_norm_plain``
    at every shape of a pass, with γ and β the two halves of one ``[B, 2C]``
    style tensor broadcast over the pixels (pixel stride 0), ε 1e-8; each
    launch must count in ``style_launches``; device time beside the bound
    (read x, write out, the 2·B·C style values, at the HBM rate)."""
    import torch
    from portbench import harness
    from portbench.counts import stylegan as style_counts

    cell = harness.load_cell(STYLEGAN_CELL)
    G, B = cell.config["G"], cell.traffic["batch"]
    shapes = style_counts.norm_shapes(G)
    if sum(shapes.values()) != 18:
        fail(f"StyleGAN: {sum(shapes.values())} AdaIN layers a pass, not 18")
    g = torch.Generator(device="cuda").manual_seed(0)
    per_pass, max_err = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        pass_ms = pass_bound = pass_plain = 0.0
        max_err[name] = 0.0
        for (r, c), n in sorted(shapes.items()):
            x = (torch.randn(B, r, r, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
            style = torch.randn(B, 2 * c, generator=g, device="cuda").to(dtype)
            gamma = style[:, :c].view(B, 1, 1, c).expand(B, r, r, c)
            beta = style[:, c:].view(B, 1, 1, c).expand(B, r, r, c)
            before = ck.fused_mat_norm.launches, ck.fused_mat_norm.style_launches
            with torch.no_grad():
                out = ck.fused_mat_norm(x, gamma, beta, eps=STYLEGAN_EPS)
                ref = ck.fused_mat_norm_plain(x, gamma, beta, eps=STYLEGAN_EPS)
            torch.cuda.synchronize()
            counted = (ck.fused_mat_norm.launches - before[0],
                       ck.fused_mat_norm.style_launches - before[1])
            if counted != (1, 1):
                fail(f"fused_mat_norm at {(B, r, r, c)} with styles counted {counted} "
                     "(launches, style_launches), not (1, 1)")
            err = (out.float() - ref.float()).abs()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            max_err[name] = max(max_err[name], err.max().item())
            if not torch.isfinite(out).all() or (err > tol + tol * ref.float().abs()).any():
                fail(f"fused_mat_norm as AdaIN vs plain at {name} {(B, r, r, c)}: max |err| "
                     f"{err.max().item():.3g}")
            del ref
            plan = ck.forward_plan(x, gamma, beta)
            with torch.no_grad():
                ms = device_ms(lambda: ck.fused_mat_norm(x, gamma, beta, eps=STYLEGAN_EPS))
                plain = time_ms(lambda: ck.fused_mat_norm_plain(x, gamma, beta,
                                                                eps=STYLEGAN_EPS),
                                iters=2, warmup=1)
            elems = B * r * r * c
            bound = 1e3 * max(style_counts.launch_bytes(B, r, c, x.element_size())
                              / HBM_BYTES_PER_S, 9 * elems / 67e12)
            print(f"fused_mat_norm AdaIN {name} {(B, r, r, c)} x{n}/pass: {ms:.4f} ms (bound "
                  f"{bound:.4f}, {100 * bound / ms:.1f}%), plain {plain:.4f} ms (events); "
                  f"{plan_label(plan)}; max |err| {err.max().item():.3g}")
            pass_ms += n * ms
            pass_bound += n * bound
            pass_plain += n * plain
            del x, out, err
            torch.cuda.empty_cache()
        per_pass[name] = dict(ms=pass_ms, bound_ms=pass_bound, plain_ms=pass_plain,
                              roofline_pct=100 * pass_bound / pass_ms)
        print(f"fused_mat_norm AdaIN {name}, one StyleGAN pass at batch {B} (18 launches): "
              f"{pass_ms:.4f} ms against a bound of {pass_bound:.4f} ms "
              f"({100 * pass_bound / pass_ms:.1f}%), plain {pass_plain:.4f} ms")
    print(f"fused_mat_norm as AdaIN vs plain: max |err| f32 {max_err['float32']:.3g}, bf16 "
          f"{max_err['bfloat16']:.3g} (tolerance f32 rtol=atol {F32_TOL}, bf16 rtol=atol "
          f"{BF16_TOL}); {card}")
    return dict(per_pass=per_pass, max_err=max_err)


def phase_style_epilogue(ck, card: str) -> dict:
    """``style_epilogue`` against ``style_epilogue_plain`` at every (r, C)
    of a StyleGAN pass at the cell's batch, in bf16 and f32: x N(0, 2²),
    noise, strength and bias N(0, 1), so that the plain version without the
    noise, without the bias, with slope 0 or with slope 1 must each break
    the tolerance somewhere (checked here, so the comparison can catch
    them); each call one launch; device time beside the bound (x read and
    written, the noise read, at the HBM rate), the plain version's time and
    that of the eager ops it replaced (``addcmul_``, ``add_``,
    ``leaky_relu_`` over the NCHW view)."""
    import torch
    import torch.nn.functional as F
    from portbench import harness
    from portbench.counts import stylegan as style_counts
    from s2p_tpu_torch.gan.stylegan import LRELU

    cell = harness.load_cell(STYLEGAN_CELL)
    G, B = cell.config["G"], cell.traffic["batch"]
    shapes = style_counts.norm_shapes(G)  # one epilogue a layer, at its AdaIN's shape
    g = torch.Generator(device="cuda").manual_seed(1)
    per_pass, max_err = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        totals = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, eager_ms=0.0)
        max_err[name] = 0.0
        for (r, c), n in sorted(shapes.items()):
            x = (torch.randn(B, r, r, c, generator=g, device="cuda") * 2).to(dtype)
            noise = torch.randn(B, r, r, generator=g, device="cuda")
            strength, bias = (torch.randn(c, generator=g, device="cuda").to(dtype)
                              for _ in range(2))
            args = lambda x, s=strength, b=bias, slope=LRELU: (x, noise, s, b, slope)  # noqa: E731
            ref = ck.style_epilogue_plain(*args(x)).float()
            off = lambda y: ((y.float() - ref).abs() > tol + tol * ref.abs()).any().item()  # noqa: E731
            zero = torch.zeros_like(bias)
            for what, y in (("no noise", ck.style_epilogue_plain(*args(x, s=zero))),
                            ("no bias", ck.style_epilogue_plain(*args(x, b=zero))),
                            ("slope 0", ck.style_epilogue_plain(*args(x, slope=0.0))),
                            ("slope 1", ck.style_epilogue_plain(*args(x, slope=1.0)))):
                if not off(y):
                    fail(f"style_epilogue check at {name} {(B, r, r, c)}: the plain version "
                         f"with {what} passes the tolerance, so the comparison cannot catch it")
                del y
            before = ck.style_epilogue.launches
            with torch.no_grad():
                out = ck.style_epilogue(*args(x.clone()))
            torch.cuda.synchronize()
            if ck.style_epilogue.launches - before != 1:
                fail(f"style_epilogue at {(B, r, r, c)} counted "
                     f"{ck.style_epilogue.launches - before} launches, not 1")
            err = (out.float() - ref).abs()
            max_err[name] = max(max_err[name], err.max().item())
            if not torch.isfinite(out).all() or off(out):
                fail(f"style_epilogue vs plain at {name} {(B, r, r, c)}: max |err| "
                     f"{err.max().item():.3g}")
            del out, err, ref
            vec, grid = ck.style_epilogue_plan(x.numel(), c, dtype, True, ck._sm_count(0))
            xn, n4 = x.permute(0, 3, 1, 2), noise[:, None]

            def eager():
                xn.addcmul_(n4.to(dtype), strength.view(1, -1, 1, 1))
                F.leaky_relu_(xn.add_(bias.view(1, -1, 1, 1)), LRELU)

            with torch.no_grad():
                ms = device_ms(lambda: ck.style_epilogue(*args(x)))
                plain = time_ms(lambda: ck.style_epilogue_plain(*args(x)), iters=2, warmup=1)
                eager_ms = time_ms(eager, iters=3, warmup=1)
            bound = 1e3 * max(style_counts.epilogue_bytes(B, r, c, x.element_size())
                              / HBM_BYTES_PER_S,
                              style_counts.EPILOGUE_FLOPS_PER_ELEMENT * x.numel() / 67e12)
            print(f"style_epilogue {name} {(B, r, r, c)} x{n}/pass: {ms:.4f} ms (bound "
                  f"{bound:.4f}, {100 * bound / ms:.1f}%), plain {plain:.4f} ms, eager ops "
                  f"{eager_ms:.4f} ms (events); {'vec16' if vec else 'scalar'} grid={grid}")
            for k, v in (("ms", ms), ("bound_ms", bound), ("plain_ms", plain),
                         ("eager_ms", eager_ms)):
                totals[k] += n * v
            del x, xn, noise
            torch.cuda.empty_cache()
        per_pass[name] = dict(totals, roofline_pct=100 * totals["bound_ms"] / totals["ms"])
        print(f"style_epilogue {name}, one StyleGAN pass at batch {B} (18 launches): "
              f"{totals['ms']:.4f} ms against a bound of {totals['bound_ms']:.4f} ms "
              f"({per_pass[name]['roofline_pct']:.1f}%), plain {totals['plain_ms']:.4f} ms, "
              f"eager ops {totals['eager_ms']:.4f} ms")
    print(f"style_epilogue vs plain: max |err| f32 {max_err['float32']:.3g}, bf16 "
          f"{max_err['bfloat16']:.3g} (tolerance f32 rtol=atol {F32_TOL}, bf16 rtol=atol "
          f"{BF16_TOL}); {card}")
    return dict(per_pass=per_pass, max_err=max_err)


def phase_style_path(ck, card: str) -> dict:
    """StyleGAN's main path, ``synthesize_style_fast``, at the
    ``stylegan-ffhq1024-b32`` cell's shapes and weights (FFHQ 1024², batch
    32, bf16): 18 MAT-norm launches a pass, all style launches (counted
    from 0 just before it), its time, its peak memory, and its frames
    against the module path in f32 with TF32 off and the same noise, held to
    the cell's limits (gaps ÷ the module frames' range); then one pass of
    the S2P fast and module paths (the cheetah cell's generator at batch 8)
    must launch the kernel with no style launch."""
    import torch
    from portbench import harness, program
    from s2p_tpu_torch.gan import (S2PGenerator, fast_apply, fuse_fast_params,
                                   synthesize_style_fast)

    cell = harness.load_cell(STYLEGAN_CELL)
    ctx = harness.Ctx(cell, 0, torch.device("cuda"))
    drv, G, tr = cell.driver, cell.config["G"], cell.traffic
    weights = drv.seeded_weights(ctx)
    gen = drv.build_generator(G, weights, ctx.device, torch.bfloat16)
    params = fuse_fast_params(gen)
    z = torch.randn(tr["batch"], G["latent_size"], generator=ctx.generator("traffic"),
                    device=ctx.device)
    noise_gen = torch.Generator(device="cuda")
    run = lambda: synthesize_style_fast(gen, z, noise_gen.manual_seed(7), params)  # noqa: E731
    with torch.no_grad():
        run()  # warms every shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.fused_mat_norm.launches = ck.fused_mat_norm.style_launches = 0
        ck.style_epilogue.launches = 0
        frames = run()
        torch.cuda.synchronize()
        launches, style = ck.fused_mat_norm.launches, ck.fused_mat_norm.style_launches
        epilogues = ck.style_epilogue.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if (launches, style, epilogues) != (18, 18, 18):
            fail(f"synthesize_style_fast: {launches} fused_mat_norm launches a pass, {style} "
                 f"with styles at pixel stride 0, {epilogues} style_epilogue launches; not 18, "
                 "18 and 18")
        ms = time_ms(run, iters=10)
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        gen32 = drv.build_generator(G, weights, ctx.device, torch.float32)
        ck.fused_mat_norm.launches = ck.fused_mat_norm.style_launches = 0
        ck.style_epilogue.launches = 0
        module = gen32(z, noise_gen.manual_seed(7)).float()
        torch.cuda.synchronize()
        module_launches = (ck.fused_mat_norm.launches, ck.fused_mat_norm.style_launches,
                           ck.style_epilogue.launches)
        if module_launches != (18, 18, 18):
            fail(f"the module path launched fused_mat_norm {module_launches[0]} times, "
                 f"{module_launches[1]} with styles, style_epilogue {module_launches[2]} "
                 "times; not 18, 18 and 18")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del gen32, params, gen
    err = frames.float() - module
    span = (module.max() - module.min()).item()
    gaps = dict(frame_max_gap=err.abs().max().item() / span,
                frame_rms_gap=err.square().mean().sqrt().item() / span)
    del err, module
    torch.cuda.empty_cache()
    print(f"StyleGAN synthesize_style_fast, batch {len(z)} at {G['resolution']}² bf16: "
          f"{launches} fused_mat_norm launches a pass ({style} with styles at pixel stride 0), "
          f"{epilogues} style_epilogue launches; "
          f"{ms:.3f} ms a pass ({1e3 * len(z) / ms:.1f} frames/s, events, host included); peak "
          f"{peak_gb:.2f} GB; against the module path in f32 (range {span:.4g}): " +
          ", ".join(f"{k} {v:.4g} (limit {cell.limits[k]})" for k, v in gaps.items()) +
          f"; {card}")
    if not all(torch.isfinite(frames.float()).all().item() and v <= cell.limits[k]
               for k, v in gaps.items()):
        fail(f"synthesize_style_fast vs the module path: {gaps} beyond {cell.limits}")
    s2p = harness.load_cell("cheetah64-rollout-b256").config
    g = torch.Generator(device="cuda").manual_seed(0)
    s2p_gen = S2PGenerator(s2p["state_dim"], device="cuda", **program.generator_kwargs(s2p))
    s2p_gen = s2p_gen.to(torch.bfloat16).requires_grad_(False)
    state = torch.randn(8, s2p["state_dim"], generator=g, device="cuda").bfloat16()
    H = s2p["image_size"]
    prev = (torch.rand(8, H, H, 3, generator=g, device="cuda") * 2 - 1).bfloat16()
    ck.fused_mat_norm.launches = ck.fused_mat_norm.style_launches = 0
    ck.style_epilogue.launches = 0
    with torch.no_grad():
        fast_apply(s2p_gen, fuse_fast_params(s2p_gen), state, prev)
        s2p_gen(state, prev)
    torch.cuda.synchronize()
    s2p_launches = (ck.fused_mat_norm.launches, ck.fused_mat_norm.style_launches,
                    ck.style_epilogue.launches)
    if s2p_launches != (26, 0, 0):
        fail(f"the S2P fast and module paths: {s2p_launches[0]} launches, {s2p_launches[1]} "
             f"style launches, {s2p_launches[2]} style_epilogue launches; not 26, 0 and 0")
    print(f"S2P fast + module path (64px, batch 8): {s2p_launches[0]} launches, "
          f"{s2p_launches[1]} style launches, {s2p_launches[2]} style_epilogue launches")
    return dict(launches=launches, style_launches=style, epilogue_launches=epilogues,
                module_epilogue_launches=module_launches[2], s2p_epilogue_launches=s2p_launches[2],
                ms=ms, peak_gb=peak_gb, gaps=gaps)


def style_epilogue_record(epilogue: dict, path: dict) -> dict:
    """The ``kernels`` line's record of the style-epilogue kernel (phase 28)."""
    one = epilogue["per_pass"]["bfloat16"]
    return dict(
        name="style_epilogue", route="cuda", source="s2p_tpu_torch/csrc/style_epilogue.cu",
        replaces=None, launches=path["epilogue_launches"],
        launches_by_path=dict(stylegan_fast=path["epilogue_launches"],
                              stylegan_module=path["module_epilogue_launches"],
                              s2p_fast_and_module=path["s2p_epilogue_launches"]),
        max_abs_err=epilogue["max_err"]["float32"],
        max_abs_err_bf16=epilogue["max_err"]["bfloat16"],
        ms=one["ms"], plain_ms=one["plain_ms"], bound_ms=one["bound_ms"], bound_by="bytes",
        library_ms=None, eager_ms=one["eager_ms"], f32_pass=epilogue["per_pass"]["float32"],
        per="ms/plain_ms/bound_ms/eager_ms: the 18 epilogues of one StyleGAN FFHQ 1024² pass "
            "at batch 32 in bf16 (f32_pass: the same in f32); ms device time (CUDA graph "
            "replay), plain_ms and eager_ms events; bound: x read and written and the f32 "
            "noise read at the HBM rate; eager_ms: addcmul_, add_ and leaky_relu_ over the "
            "NCHW view, the ops it replaced (library_ms None: no library kernel does the "
            "three); the JAX package has no StyleGAN (replaces None)")


HIDDEN_CELLS = ("cheetah64-rollout-b256", "walker100-bridge-b256", SPADE_CELL)
HIDDEN_F32_TOL = 1e-5  # rtol and atol, as the norm kernels' (the plain version adds in one order)


def hidden_map_calls(ck, cell_name: str) -> tuple:
    """One fast-path pass of the cell's generator (full width, its batch,
    bf16, seeded weights) on the card: every ``hidden_maps`` call's shapes,
    recorded by a wrapper, with the launches counted from 0 just before the
    pass; and the module path's launches over one pass. The S2P cells run
    ``fast_apply``, the GauGAN cell ``synthesize_fast``."""
    import torch
    from portbench import harness, program
    from s2p_tpu_torch.gan import S2PGenerator, fast_apply, fuse_fast_params, label_onehot
    from s2p_tpu_torch.gan import fast_inference as fi

    cell = harness.load_cell(cell_name)
    cfg, B, dev = cell.config, cell.traffic["batch"], torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    if cell_name == SPADE_CELL:
        from s2p_tpu_torch.gan import SPADEGenerator, synthesize_fast

        gen = SPADEGenerator(**cfg["opt"], device=dev).to(torch.bfloat16).eval()
        gen.requires_grad_(False)
        ids = torch.randint(0, gen.semantic_nc, (B, *gen.image_hw), generator=g, device=dev,
                            dtype=torch.uint8)
        params = fuse_fast_params(gen)
        fast = lambda: synthesize_fast(gen, ids, params)  # noqa: E731
        module = lambda: gen(label_onehot(ids, gen.semantic_nc, torch.bfloat16))  # noqa: E731
    else:
        gen = S2PGenerator(cfg["state_dim"], device=dev, **program.generator_kwargs(cfg))
        gen = gen.to(torch.bfloat16).requires_grad_(False)
        H = cfg["image_size"]
        state = torch.randn(B, cfg["state_dim"], generator=g, device=dev).bfloat16()
        prev = (torch.rand(B, H, H, 3, generator=g, device=dev) * 2 - 1).bfloat16()
        params = fuse_fast_params(gen)
        fast = lambda: fast_apply(gen, params, state, prev)  # noqa: E731
        module = lambda: gen(state, prev)  # noqa: E731
    calls = []
    kernel = fi.hidden_maps

    def spy(h, bias, widths, terms=None):
        calls.append(dict(shape=tuple(h.shape), widths=tuple(widths), terms=None if terms is None
                          else dict(stride=terms.stride(), offset=terms.storage_offset())))
        return kernel(h, bias, widths, terms)

    with torch.no_grad():
        fast()  # builds the kernel and warms every shape
        torch.cuda.synchronize()
        ck.hidden_maps.launches = ck.hidden_maps.cmap_launches = 0
        fi.hidden_maps = spy
        try:
            fast()
        finally:
            fi.hidden_maps = kernel
        torch.cuda.synchronize()
        counts = (ck.hidden_maps.launches, ck.hidden_maps.cmap_launches)
        ck.hidden_maps.launches = 0
        module()
        torch.cuda.synchronize()
        module_launches = ck.hidden_maps.launches
    del gen, params
    torch.cuda.empty_cache()
    return calls, counts, module_launches


def hidden_map_inputs(call: dict, dtype, seed: int) -> tuple:
    """Seeded operands of a recorded call's shapes on the card: h in
    channels_last memory, the bias, and the terms as the same strided slice
    of a wider tensor as the fast path passes (``t_all[:, :, off:off + C]``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, C, H, W = call["shape"]
    h = torch.randn(B, H, W, C, generator=g, device="cuda").to(dtype).permute(0, 3, 1, 2)
    bias = (torch.randn(C, generator=g, device="cuda") * 0.5).to(dtype)
    terms = None
    if call["terms"] is not None:
        total = call["terms"]["stride"][1]  # t_all [B, 9, total] is contiguous
        t_all = torch.randn(B, 9, total, generator=g, device="cuda").to(dtype)
        off = call["terms"]["offset"] % total
        terms = t_all[:, :, off:off + C]
        if terms.stride() != call["terms"]["stride"]:
            fail(f"hidden_maps: rebuilt terms strides {terms.stride()} != {call['terms']}")
    return h, bias, terms


def parent_glue(h, bias, widths, terms):
    """What the fast path ran before the kernel, after the bias-free conv:
    the bias (and for S2P the constant-map terms: a broadcast add and 8
    border updates) in place, the ReLU, the split and each norm's copy into
    a channels_last map (``_modulate``'s ``_cl``); the yardstick."""
    import torch

    from s2p_tpu_torch.gan.fast_inference import _add_const_map, _cl

    if terms is None:
        h = h + bias[None, :, None, None]
    else:
        _add_const_map(h, terms, bias)
    return [_cl(m) for m in torch.split(h.relu_(), list(widths), dim=1)]


def phase_hidden_maps(ck, card: str) -> dict:
    """``hidden_maps`` on the three cells' main paths: its launches over one
    fast-path pass (5 with the constant-map terms for each S2P cell, 7
    without for GauGAN) and over one module-path pass (0); the kernel
    against ``hidden_maps_plain`` at every block shape of those passes in
    bf16 and f32; its device time beside its bound (read h, write the maps
    at the HBM rate), the plain version's and the glue's it replaced."""
    import torch

    t0 = time.time()
    ck.load_hidden_maps_library()
    print(f"build: hidden_maps ({ck.HIDDEN_SOURCE.name}) built and loaded in "
          f"{time.time() - t0:.1f} s")
    expected = {SPADE_CELL: (7, 0)}
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per_cell = {}
    for cell in HIDDEN_CELLS:
        calls, counts, module_launches = hidden_map_calls(ck, cell)
        want = expected.get(cell, (5, 5))
        print(f"hidden_maps {cell}: {counts[0]} launches a fast-path pass ({counts[1]} with the "
              f"constant-map terms; expected {want[0]} and {want[1]}), {module_launches} on the "
              f"module path; {card}")
        if counts != want or len(calls) != want[0]:
            fail(f"hidden_maps on {cell}: {counts} launches a pass and {len(calls)} calls, "
                 f"expected {want}")
        if module_launches:
            fail(f"hidden_maps on {cell}'s module path: {module_launches} launches, expected 0")
        totals = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, glue_ms=0.0)
        for i, call in enumerate(calls):
            for dtype in (torch.bfloat16, torch.float32):
                h, bias, terms = hidden_map_inputs(call, dtype, seed=i)
                with torch.no_grad():
                    out = ck.hidden_maps(h, bias, call["widths"], terms)
                    ref = ck.hidden_maps_plain(h, bias, call["widths"], terms)
                torch.cuda.synchronize()
                tol = HIDDEN_F32_TOL if dtype == torch.float32 else BF16_TOL
                for o, r in zip(out, ref):
                    if not o.is_contiguous(memory_format=torch.channels_last):
                        fail(f"hidden_maps: a map of {call} is not channels_last-contiguous")
                    err = (o.float() - r.float()).abs()
                    max_err[dtype] = max(max_err[dtype], err.max().item())
                    if (err > tol + tol * r.float().abs()).any():
                        fail(f"hidden_maps vs plain at {cell} {call['shape']} {dtype}: max "
                             f"|err| {err.max().item():.3g}")
                if dtype != torch.bfloat16:
                    continue
                bits = h.data_ptr() | bias.data_ptr() | out[0].data_ptr()
                if terms is not None:
                    bits |= terms.data_ptr() | (terms.stride(0) * 2) | (terms.stride(1) * 2)
                B, C, H, W = call["shape"]
                plan = ck.hidden_maps_plan(B, H * W, call["widths"], dtype, bits % 16 == 0,
                                           ck._sm_count(0))
                if not plan.vec:
                    fail(f"hidden_maps: {cell} {call['shape']} fell to the scalar path")
                with torch.no_grad():
                    ms = device_ms(lambda: ck.hidden_maps(h, bias, call["widths"], terms))
                    plain = device_ms(lambda: ck.hidden_maps_plain(h, bias, call["widths"], terms),
                                      iters=5)
                    glue = device_ms(lambda: parent_glue(h, bias, call["widths"], terms), iters=5)
                bound = 2 * B * C * H * W * h.element_size() / HBM_BYTES_PER_S * 1e3
                print(f"hidden_maps bf16 {cell} {call['shape']} widths {call['widths']} "
                      f"{'terms' if terms is not None else 'no terms'}: {ms:.4f} ms (bound "
                      f"{bound:.4f}, {100 * bound / ms:.1f}%), plain {plain:.4f} ms, the glue it "
                      f"replaced {glue:.4f} ms; plan lanes {plan.lanes} threads {plan.threads} "
                      f"grid {plan.grid}x{plan.c_tiles}x{B}")
                for k, v in (("ms", ms), ("bound_ms", bound), ("plain_ms", plain),
                             ("glue_ms", glue)):
                    totals[k] += v
                del h, bias, terms, out, ref
        totals["roofline_pct"] = 100 * totals["bound_ms"] / totals["ms"]
        per_cell[cell] = dict(totals, launches=counts[0], cmap_launches=counts[1],
                              module_launches=module_launches)
        print(f"hidden_maps {cell}, one pass in bf16 ({counts[0]} launches): {totals['ms']:.4f} "
              f"ms against a bound of {totals['bound_ms']:.4f} ms "
              f"({totals['roofline_pct']:.1f}%), plain {totals['plain_ms']:.4f} ms, the glue it "
              f"replaced {totals['glue_ms']:.4f} ms; {card}")
        torch.cuda.empty_cache()
    print(f"hidden_maps vs plain: max |err| f32 {max_err[torch.float32]:.3g}, bf16 "
          f"{max_err[torch.bfloat16]:.3g} (tolerance f32 rtol=atol {HIDDEN_F32_TOL}, bf16 "
          f"rtol=atol {BF16_TOL})")
    return dict(per_cell=per_cell, max_err={str(k).split(".")[-1]: v
                                            for k, v in max_err.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also write torch.profiler summaries of each main path to DIR")
    ap.add_argument("--ab", default=None, metavar="DIR",
                    help="only build and time the MAT-norm kernels against those of the "
                         "checkout in DIR, in turns, and stop (no result line)")
    ap.add_argument("--sweep", action="store_true",
                    help="only build and time every launch plan of the MAT-norm kernels at "
                         "the main-path shapes, and stop (no result line)")
    ap.add_argument("--spade", action="store_true",
                    help="only run phase 26 (the SPADE-norm kernel at the 18 shapes of a "
                         "GauGAN pass, then GauGAN's fast path against its module path), "
                         "and stop")
    ap.add_argument("--hidden", action="store_true",
                    help="only run phase 27 (the hidden-map kernel on the three cells' main "
                         "paths), and stop")
    ap.add_argument("--stylegan", action="store_true",
                    help="only run phase 28 (the MAT-norm kernel as StyleGAN's AdaIN and the "
                         "style-epilogue kernel at the 18 shapes of a pass, then StyleGAN's "
                         "fast path against its module path), and stop")
    ap.add_argument("--time-paths", default=None, metavar="ROOT",
                    help="only time the two main paths end to end with the s2p_tpu_torch "
                         "of the checkout in ROOT and print them as JSON (one side of --ab)")
    args = ap.parse_args()

    if args.time_paths:
        sys.path.insert(0, os.path.abspath(args.time_paths))
        print(json.dumps(time_paths()))
        return

    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from s2p_tpu_torch.gan import S2PGenerator
    from s2p_tpu_torch.gan import cuda_kernels as ck

    # phase 2: build
    t0 = time.time()
    ck.load_library()
    print(f"build: fused_mat_norm ({ck.SOURCE.name}) built and loaded in {time.time() - t0:.1f} s")

    if args.spade:
        print(json.dumps(dict(kernel=phase_spade_norm(ck, card),
                              path=phase_spade_path(ck, card))))
        return
    if args.hidden:
        print(json.dumps(phase_hidden_maps(ck, card)))
        return
    if args.stylegan:
        adain, epilogue = phase_style_adain(ck, card), phase_style_epilogue(ck, card)
        path = phase_style_path(ck, card)
        print(json.dumps(dict(kernel=adain, path=path)))
        print(json.dumps({"kernels": [style_epilogue_record(epilogue, path)]}))
        return
    if args.ab:
        phase_ab(ck, args.ab, card)
    if args.sweep:
        phase_sweep(ck, card)
    if args.ab or args.sweep:
        return

    # phase 3: kernels vs plain (the shapes come from the full-width generator)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen_cpu = S2PGenerator(STATE_DIM, seed=0, device="cpu", **FULL)
    gen100 = S2PGenerator(STATE_DIM, image_size=TRAIN_SIZE, ngf=64, device="cpu")
    stats = phase_kernels(ck, norm_shapes(gen_cpu), norm_shapes(gen100))

    # phase 4: slice parity, card vs CPU
    gen_gpu = copy.deepcopy(gen_cpu).to("cuda")
    phase_parity(ck, gen_cpu, gen_gpu)

    # phase 5: serving throughput, a main path (its bf16 generator serves phase 12)
    serving_gen = gen_gpu.to(torch.bfloat16)
    serving = phase_throughput(ck, serving_gen, card, args.profile)

    # phase 6: backward kernel vs plain at the 100px training shapes
    bwd = phase_backward(ck, norm_shapes(gen100))

    # phase 7: one full-width train step, card vs CPU
    torch.backends.cudnn.allow_tf32 = False
    phase_train_parity(ck)

    # phase 8: training throughput, a main path
    training = phase_train_throughput(ck, card, args.profile)

    # phase 9: world model, card vs CPU
    phase_world_model()

    # phase 10: image bridge, card vs CPU (the full-width 100px generator)
    gen100_gpu = copy.deepcopy(gen100).to("cuda")
    phase_bridge_parity(ck, gen100, gen100_gpu)

    # phase 11: the augmentation pipeline, a main path
    bridge, generated, generated_frames = phase_pipeline(ck, gen100_gpu, card, args.profile)
    del gen100_gpu

    # phase 12: gb_int8 on the serving generator
    gb_int8 = phase_gb_int8(ck, serving_gen, card, serving["fps"], args.profile)
    del serving_gen, gen_gpu
    torch.cuda.empty_cache()

    # phase 13: one SLAC ELBO step and one IQL + SLAC step, card vs CPU
    phase_slac_parity()

    # phase 14: SLAC pretraining, a main path
    pretrain = phase_slac_pretrain(ck, card, args.profile)

    # phase 15: S2P-augmented IQL + SLAC, a main path
    iql = phase_slac_rl(ck, card, "iql", make_iql, IQL_STEPS, pretrain, generated,
                        generated_frames, args.profile)

    # phase 16: one CQL + SLAC step (two configurations) and one SAC step, card vs CPU
    phase_cql_sac_parity()

    # phase 17: S2P-augmented CQL + SLAC, a main path
    cql = phase_slac_rl(ck, card, "cql", make_cql, CQL_STEPS, pretrain, generated,
                        generated_frames, args.profile)

    # phase 18: the evaluation metrics, card vs CPU, then LPIPS and FID rates (a main path)
    evals = phase_eval_metrics(ck, card, serving["frames"], args.profile)

    # phase 19: the S2P-augmented RL experiment: one acting step card vs CPU, then
    # IQL and CQL through the mujoco_finetune CLI's assembly (a main path)
    phase_acting_parity()
    rl = phase_rl_experiment(ck, card, pretrain, generated, args.profile)

    # phase 20: data-parallel GAN training on the multi-env configuration (a
    # main path each: world 1 over NCCL, 2 gloo ranks on this card) and the
    # tensor-parallel generator
    t0 = time.time()
    dp_nccl = phase_dp_nccl(ck, card, training["steps_per_s"])
    print(f"phase 20a: {time.time() - t0:.1f} s")
    t0 = time.time()
    dp_gloo = phase_dp_gloo(card)
    print(f"phase 20b: {time.time() - t0:.1f} s")
    t0 = time.time()
    tp = phase_tp(gen_cpu, card)
    print(f"phase 20c: {time.time() - t0:.1f} s")

    # phase 21: data-parallel IQL, CQL and SLAC steps (a main path each: world 1
    # over NCCL with the state loops, 2 gloo ranks on this card)
    t0 = time.time()
    dp_rl = phase_dp_rl_nccl(ck, card, pretrain, generated, generated_frames)
    print(f"phase 21a, 21c: {time.time() - t0:.1f} s")
    t0 = time.time()
    dp_rl_gloo = phase_dp_rl_gloo(card, pretrain["latent"])
    print(f"phase 21b: {time.time() - t0:.1f} s")

    # phase 22: the collection loop, a main path
    t0 = time.time()
    collection = phase_collect(ck, card, args.profile)
    print(f"phase 22: {time.time() - t0:.1f} s")

    # phase 23: the CURL/RAD pixel path on phase 11's frames, a main path
    t0 = time.time()
    pixel = phase_pixel_rl(ck, card, generated_frames, args.profile)
    print(f"phase 23: {time.time() - t0:.1f} s")

    # phase 24: the goal-conditioned and multitask path, a main path
    t0 = time.time()
    goal = phase_goal_multitask(ck, card)
    print(f"phase 24: {time.time() - t0:.1f} s")

    # phase 25: the dry run (the port of __graft_entry__.py): entry() on the
    # card, dryrun_multichip(2) and (4) on gloo ranks sharing it (NCCL, a card a rank)
    t0 = time.time()
    dry = phase_dryrun(ck, card, sum(norm_shapes(gen_cpu).values()))
    print(f"phase 25: {time.time() - t0:.1f} s")

    # phase 26: the SPADE-norm kernel at every shape of a GauGAN pass, then
    # GauGAN's fast path (a main path) against its module path
    t0 = time.time()
    spade_kernel = phase_spade_norm(ck, card)
    spade_path = phase_spade_path(ck, card)
    print(f"phase 26: {time.time() - t0:.1f} s")

    # phase 27: the hidden-map kernel on the three cells' main paths
    t0 = time.time()
    hidden = phase_hidden_maps(ck, card)
    print(f"phase 27: {time.time() - t0:.1f} s")

    # phase 28: the MAT-norm kernel as StyleGAN's AdaIN, then StyleGAN's fast path
    t0 = time.time()
    style_kernel = phase_style_adain(ck, card)
    style_epilogue = phase_style_epilogue(ck, card)
    style_path = phase_style_path(ck, card)
    print(f"phase 28: {time.time() - t0:.1f} s")

    by_path = dict(serving=serving["launches"], training=training["fwd"], bridge=bridge,
                   gb_int8=gb_int8, slac_pretrain=pretrain["launches"], slac_iql=iql["launches"],
                   cql_slac=cql["launches"], eval_metrics=evals["launches"],
                   rl_loop=rl["launches"], dp_nccl=dp_nccl["fwd"], dp_gloo=dp_gloo["fwd"],
                   tp=tp, dp_rl_nccl=dp_rl["launches"]["fwd"],
                   dp_rl_gloo=dp_rl_gloo["launches"][0], collection=collection["launches"],
                   pixel_rl=pixel["launches"], goal_multitask=goal["launches"],
                   dryrun=dry["fwd"], stylegan=style_path["launches"])
    bwd_by_path = dict(serving=0, training=training["bwd"], bridge=0, gb_int8=0,
                       slac_pretrain=pretrain["bwd_launches"], slac_iql=iql["bwd_launches"],
                       cql_slac=cql["bwd_launches"], eval_metrics=evals["bwd_launches"],
                       rl_loop=rl["bwd_launches"], dp_nccl=dp_nccl["bwd"],
                       dp_gloo=dp_gloo["bwd"], tp=0, dp_rl_nccl=dp_rl["launches"]["bwd"],
                       dp_rl_gloo=dp_rl_gloo["launches"][1],
                       collection=collection["bwd_launches"], pixel_rl=pixel["bwd_launches"],
                       goal_multitask=goal["bwd_launches"], dryrun=dry["bwd"])
    fwd_record = dict(
        name="fused_mat_norm", route="cuda", source="s2p_tpu_torch/csrc/fused_mat_norm.cu",
        replaces="s2p_tpu/gan/pallas_kernels.py:49", launches=sum(by_path.values()),
        launches_by_path=by_path,
        max_abs_err=stats["max_abs_err"], max_abs_err_bf16=stats["max_abs_err_bf16"],
        ms=stats["ms"], bias_ms=stats["bias_ms"], plain_ms=stats["plain_ms"],
        bound_ms=stats["bound_ms"], bound_by="bytes", library_ms=None,
        wall_ms=stats["wall_ms"], instance_norm_ms=stats["instance_norm_ms"],
        train_step_ms=bwd["fwd_ms"], train_step_wall_ms=bwd["fwd_wall_ms"],
        train_step_plain_ms=bwd["fwd_plain_ms"], train_step_bound_ms=bwd["fwd_bound_ms"],
        bridge_batch_ms=stats["bridge"]["ms"], bridge_batch_bias_ms=stats["bridge"]["bias_ms"],
        bridge_batch_plain_ms=stats["bridge"]["plain_ms"],
        bridge_batch_bound_ms=stats["bridge"]["bound_ms"],
        stylegan_pass=style_kernel["per_pass"]["bfloat16"],
        per="ms/plain_ms/bound_ms: one 64px/ngf=64 generator step at batch 256 in bf16 "
            "(13 norms); bias_ms: the same with the gamma||beta bias folded (gb_bias), as "
            "the fast path runs it; train_step_*: the 13 norms of a 100px/ngf=64 train step at batch "
            "16 in bf16; bridge_batch_*: the 13 norms of one 100px/ngf=64 bridge batch of "
            "256 in bf16 (gamma and beta contiguous); ms, plain_ms: device time (CUDA graph "
            "replay), where the records of PR 1 and PR 2 gave wall time per call as ms, so "
            "ms is not comparable with theirs; wall_ms: wall time per wrapper call in a "
            "loop, host included, as they timed ms; instance_norm_ms is F.instance_norm "
            "alone, a partial yardstick; stylegan_pass: the 18 AdaIN launches of one "
            "StyleGAN FFHQ 1024² pass at batch 32 in bf16 (styles at pixel stride 0)",
    )
    bwd_record = dict(
        name="fused_mat_norm_bwd", route="cuda", source="s2p_tpu_torch/csrc/fused_mat_norm.cu",
        replaces="s2p_tpu/gan/pallas_kernels.py:49", launches=sum(bwd_by_path.values()),
        launches_by_path=bwd_by_path,
        max_abs_err=bwd["max_abs_err"], max_abs_err_bf16=bwd["max_abs_err_bf16"],
        ms=bwd["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"], bound_by="bytes",
        library_ms=None, wall_ms=bwd["wall_ms"],
        instance_norm_bwd_ms=bwd["instance_norm_bwd_ms"],
        per="the gradient of fused_mat_norm (the JAX package has no backward kernel: XLA "
            "differentiates the plain norm); one 100px/ngf=64 train step at batch 16 in "
            "bf16 (13 norms); ms, plain_ms: device time (CUDA graph replay), where PR 2's "
            "record gave wall time per call as ms, so ms is not comparable with it; "
            "wall_ms: wall time per call, as PR 2 timed ms; instance_norm_bwd_ms is the "
            "autograd backward of F.instance_norm alone (wall per call), a partial yardstick",
    )
    spade_pass = spade_kernel["per_pass"]["bfloat16"]
    spade_record = dict(
        name="spade_norm", route="cuda", source="s2p_tpu_torch/csrc/spade_norm.cu",
        replaces=None, launches=spade_path["launches"],
        launches_by_path=dict(spade_synth=spade_path["launches"]),
        max_abs_err=spade_kernel["max_err"]["float32"],
        max_abs_err_bf16=spade_kernel["max_err"]["bfloat16"],
        ms=spade_pass["ms"], bias_ms=spade_pass["bias_ms"], plain_ms=spade_pass["plain_ms"],
        bound_ms=spade_pass["bound_ms"], bound_by="bytes", library_ms=None,
        path_ms=spade_path["ms"],
        path_gaps=spade_path["gaps"],
        per="ms/plain_ms/bound_ms: the 18 SPADE norms of one GauGAN pass (ADE20K 256², "
            "ngf 64) at batch 32 in bf16, gamma and beta the halves of one gamma||beta "
            "tensor; bias_ms: the same with the gamma||beta bias folded (gb_bias), as the "
            "fast path runs it; device time (CUDA graph replay); bound: 4 arrays at the HBM "
            "rate; no "
            "library kernel computes the modulation with given statistics (library_ms "
            "None); the JAX package has no such kernel (replaces None); path_ms: one "
            "synthesize_fast pass at batch 32 (events, host included); path_gaps: its "
            "frames against the module path in f32",
    )
    hidden_record = dict(
        name="hidden_maps", route="cuda", source="s2p_tpu_torch/csrc/hidden_maps.cu",
        replaces=None, launches=sum(c["launches"] for c in hidden["per_cell"].values()),
        launches_by_path={cell: c["launches"] for cell, c in hidden["per_cell"].items()},
        max_abs_err=hidden["max_err"]["float32"], max_abs_err_bf16=hidden["max_err"]["bfloat16"],
        per_cell=hidden["per_cell"], bound_by="bytes", library_ms=None,
        per="per_cell: one fast-path pass of each cell's generator at its batch in bf16 (S2P: "
            "5 launches with the constant-map terms; GauGAN: 7 without); ms, plain_ms, "
            "glue_ms: device time (CUDA graph replay) of the kernel, its plain version and "
            "the op sequence it replaced (bias and constant-map adds, ReLU, split, copies); "
            "bound: read h and write the maps once at the HBM rate; the JAX package has no "
            "such kernel (XLA fuses the arithmetic; replaces None)",
    )
    print(json.dumps({"kernels": [fwd_record, bwd_record, spade_record, hidden_record,
                                  style_epilogue_record(style_epilogue, style_path)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
