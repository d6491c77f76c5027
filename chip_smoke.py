#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with one CUDA device, the
CUDA toolkit (nvcc) and PyTorch.  It imports no JAX.  Phases:

1. the card: its name and power limit;
2. the build of every CUDA kernel from ``csrc/`` (one nvcc per source, all
   started together), with nvcc's register, shared-memory and spill report;
3. each kernel against its plain PyTorch version at its main path's
   shapes, both timed with CUDA events: the rollout at the serving path's
   and at B=256 (bulk sampling), on prepared operands (two launches
   bit-equal: the kernel sums in a fixed order), beside the
   ``decoder_rollout_kernel`` call with cached operands (the route), T and
   2T grid barriers alone on the kernel's grid (the floors of a serial
   rollout of one and of two barriers a step), its bound, launch
   configuration and nvcc's registers and spills;
   the ELU+dropout forward and backward at the VUNet's largest dropout
   site (12, 256, 256, 32) bf16 and at a ragged f32 size, over every bf16
   bit pattern and a sweep of f32 patterns with the ELU's edge values
   (non-finite values as the plain version's), at element offsets 0-7, n
   and n + 1 (keep decisions those of the plain version's bits), with
   ``F.dropout(F.elu(x))`` timed beside them as a yardstick, each half of
   a batch at its element offset bit-equal to the rows of one launch over
   the batch (``pallas_sharded``), the launch timed at two offsets against
   its bound (bytes, Philox's integer multiplies), and both kernels timed
   at every dropout site of [7]'s cvbae step with its launches a step;
   the fused RNB checked at the VUNet's 125-frame chunk sites
   (256/128/64/32/4 px) and a ragged shape, its nvcc report (registers, spills) and launch plan
   (shared memory, blocks an SM) for each instantiation, and timed at
   every site of an org request (7 chunk sites, 5 ``encode_means`` sites)
   on prepared operands, beside the ``VunetRNB`` call under ``fused`` (the
   route) and the default eval forward (cuDNN conv and eager elementwise
   ops), with the request's sum of launches x time against launches x
   bound;
   the conv epilogue (``y + b' [+ residual]`` in place) bit-equal to its
   plain version at the VUNet's 125-frame chunk conv outputs (256/128/64/4
   px and the 3-channel RGB head), with and without a residual, a strided
   output refused, timed beside its byte bound, its plain version and the
   eager passes it replaces (the conv's bias, gamma, beta, the residual);
   its activated store (ELU into a channel half of a residual block's 2C
   conv input) bit-equal to its plain version at the 125-frame chunk's
   residual blocks (256/128/64/4 px), without a bias (ELU(x)), with one
   (the nin conv) and with a residual, timed beside its byte bound, its
   plain version and the passes it replaces (F.elu and the half of
   ``torch.cat``);
   the stickman raster (one launch a ``render_stickman`` call on the card)
   bit-equal to its eager version on the card in both outputs (f32 on
   0..255, the VUNet's normalized bf16) at a bulk request's 1,000 frames of
   256 px, thickness 4, the detailed H36M joint model, with edge cases;
   timed beside the eager version on the card and the plain version on the
   CPU, against its bound (the bytes it writes, or the instruction issue
   of the tests its cull leaves for these joints);
4. the full-width serving slice at ``bench.py``'s shapes (B=20, T=50,
   256 px, HID 1024, 48 of 51 keypoints, a 15-flow LatentFlow of mid width
   2048 in f32, VUNet-alter nf 32->128 in bf16) on seeded random weights
   made on the device: generate (sample mode, with the flow), reenact, and
   generate at B=3; every request must launch the rollout kernel once;
   the warm-up request must launch the conv epilogue once a
   ``NormConv2d`` call and make two activated stores a residual block call
   with aux input, and the timed ones build no prepared kernel weights
   (``ops/nn.py:prepared_builds``, every slot); every request must launch
   the stickman raster once;
   one B=20 request on the concatenation-free residual blocks bit-equal
   to the same request on the concatenating route;
   then one B=20 request with ``rnb_impl="fused"`` (126 fused RNB
   launches);
5. the serving CLI in-process at a small width, from .npz parameter files
   and a request file written here from a numpy seed; also an org
   synthesis run (experiment "vunet") with ``--rnb_impl fused``;
6. the port at small width against ``tests/golden/torch_port_slice_small.npz``
   (outputs of the JAX package), in f32 with TF32 off, and the small org
   VUNet against ``tests/golden/torch_port_org_small.npz``;
7. cvbae VUNet training at full width through ``bdvs-train-torch``'s
   ``main`` in-process: ``configs/shape_and_pose_net.yaml`` (256 px, B=12,
   nf 32->128, regressor on, dropout 0.05, bf16) with
   ``dropout_impl: pallas`` and 6 steps; every step must be finite and
   launch each ELU+dropout kernel once per dropout site; the written
   ``synth.npz`` then serves one ``transfer_cached`` call (the run's
   checkpoint is resumed in phase [14]);
8. the port's cvbae step at small width against
   ``tests/golden/torch_port_train_small.npz`` (two JAX steps), in f32 with
   TF32 off;
9. org-VUNet serving at full width: ``configs/vunet.yaml``'s VUNet (256 px,
   nf 32->128, a 30-channel 64x64 part-stack appearance, box_factor 2,
   bf16) behind phase 4's behavior net and flow, B=20, T=50, a warm-up and
   two timed requests under each ``rnb_impl``; the fused route must launch
   the fused RNB kernel 122 times a request and stay within a relative L2
   of 2e-2 of the same request through the kernel's plain version; one
   org ``test_forward`` chunk (the autoregressive prior);
10. behavior_net training at full width through ``bdvs-train-torch``'s
    ``main`` in-process with ``--debug``: ``configs/behavior_net.yaml``
    otherwise unchanged (B=64, T=50, 51 keypoints, ``dim_hidden_b`` 1024,
    LSTM decoder, 15 flows of mid width 2048, f32), 16 cVAE steps over 2
    epochs and 8 flow steps, each between two synchronizations; every
    metric finite, ``metrics.jsonl`` with train/, eval/ and flow/ lines;
    one profiled step of each stage; a second ``main`` with ``-r`` runs no
    step; then the written ``behavior.npz`` behind phase 4's alter VUNet
    serves one B=20, T=50 sample request, which must launch the rollout
    kernel once and match the decoder's plain loop;
11. the port's behavior cVAE and flow steps at small width against
    ``tests/golden/torch_port_behavior_small.npz`` (two JAX steps of
    each, with their draws), in f32 with TF32 off;
12. the rest of the behavior experiment at full width through ``main``,
    ``configs/behavior_net.yaml`` with ``--debug``: (a) ``-m infer`` on
    phase [10]'s run (both stages restored; 2 batches of 64 x 50 prior
    and 64 x 50 flow rollouts through the decoder's f32 loop, which must
    launch no rollout kernel; the post-hoc protocol on 64 cached
    sequences, 50 iterations, 4 sources x 6 start frames), every summary
    key present and finite, with the run's and each stage's wall time and
    peak memory; (b) ``-f`` in a sibling project, which must train the
    flow alone (8 steps) over phase [10]'s cVAE; (c) the cVAE with
    ``training.bf16``, its median step and sequences/s beside phase
    [10]'s f32 step; (d) ``dataset: h36m_synthetic`` trained and
    inferred;
13. the port's ``-m infer`` at small width against
    ``tests/golden/torch_port_infer_small.npz`` (the JAX run's summary
    and draws; weights rebuilt from its numpy seed), in f32 with TF32
    off;
14. the VUNet experiments at full width through ``main`` in-process:
    (a) ``configs/vunet.yaml`` as published (256 px, B=8, nf 32->128, a
    30-channel 64x64 part stack, bf16, Laplacian perceptual, dropout 0),
    6 org steps, every metric finite, the median step, img/s, one
    profiled step's busy share, peak memory and the part stacks' render
    time; a second ``main`` with ``-r`` restores step 6 and runs no
    step; the written ``synth.npz`` serves one org ``transfer_cached``
    chunk; (b) 2 org steps with ``dropout_prob: 0.05, dropout_impl:
    pallas``, which must launch the ELU+dropout forward kernel at all 76
    dropout sites and the backward at the 72 that reach the loss, and
    whose next step's loss must equal the same step through the kernels'
    plain Philox versions to 1e-5; (c) phase [7]'s cvbae run resumed with
    ``-r`` to step 8 (it must restore step 6), then ``-m infer`` with
    ``general.debug``: SSIM, the post-hoc regressor's loss and the wall
    time by stage; (d) ``-m infer`` on (a)'s run with
    ``metrics.posthoc_regressor: false`` (ROADMAP C6); (e) the device
    part-stack warp of (a)'s dataset against its plain numpy version:
    within 1 uint8 level at >= 99.9 % of values, none more than 8 apart;
15. the port's org training step at small width against
    ``tests/golden/torch_port_org_train_small.npz`` (three JAX steps;
    weights, batch and noise rebuilt from its numpy seed), in f32 with
    TF32 off: the metrics at rtol 1e-4 and every leaf's update within 5 %
    of the JAX update;
16. the MT-VAE experiment at full width through ``main`` in-process:
    ``configs/mt_vae.yaml`` as published (B=256, T=61 with n_cond 10 and
    51 predicted frames, 51 keypoints, dim 1024, z 512, f32) with
    ``general.debug`` (2 epochs of 8 batches), every metric finite, the
    median step, sequences/s, one profiled step's busy share, launches
    and top kernels, peak memory; ``-r`` runs no step; ``-m infer`` (2
    batches x 50 prior samples, 50 post-hoc iterations) with its wall time
    by stage, its summary keys the JAX experiment's and all finite; ``-p`` of
    the run with ``-d`` restores the copied save in the "debug" project
    and runs no step; the same training with ``training.bf16`` beside the
    f32 step.  No hand-written kernel is on this path;
17. the port's MT-VAE step at small width against
    ``tests/golden/torch_port_mtvae_small.npz`` (two JAX steps; weights,
    batch and draws rebuilt from its numpy seed), in f32 with TF32 off:
    the metrics at rtol 1e-4 and every leaf's update within 5 % of the
    JAX update;
18. the VUNet experiments on image files at full width, trees written
    here from numpy seeds: cvbae through ``main`` on a Human3.6M tree (2
    subjects x 2 actions x 2 cameras x 40 frames of 1000 x 1000 JPEG, an
    ``annot_export.h5`` written by ``data/h5lite.py``) with
    ``configs/shape_and_pose_net.yaml`` as published (256 px, B=12, nf
    32->128, ``keypoints_3d_world`` stickmen from 3D, the regressor on its
    probe images, dropout 0.05 with ``dropout_impl: pallas``, bf16), 6
    steps, each of which must launch each ELU+dropout kernel once per
    dropout site and report a loss that is its terms recomposed, with the
    likelihood and the KL each ending below their first step's value and
    never reaching 10x it, then ``-r`` to step 8 and ``-m infer`` twice with
    ``metrics.compute_is`` and ``compute_fid`` (``general.debug``): every
    summary value finite, and the second must read the targets' Inception
    features from the FID cache; the same for org-VUNet on a DeepFashion
    ``index.p`` tree (192 images of 256 px) with ``configs/vunet.yaml`` as
    published (B=8, in-plane part stacks made on the device).  Printed:
    the JPEG decoder route (libjpeg through ``data/native.py`` where it
    builds, which it must wherever libjpeg's headers exist; else cv2), the
    median step, the host data time a step (the stall between steps, and
    an item's fetch time), the last batch's step replayed with the loader
    stopped and while as many threads as the loader's fetch items, a
    profiled step's busy share beside phase [7]'s,
    peak memory and ``-m infer``'s wall time by stage with the Inception
    forward alone;
19. the port's image datasets (DeepFashion, its part stacks made on the
    device, and Human3.6M with stickmen from 3D), Inception (seeded
    weights, 2 x 256 px resized to 128), IS, FID and the keypoint crop
    against ``tests/golden/torch_port_image_data_small.npz`` (the JAX
    package's, with the JPEGs it decoded): every image within 1 uint8
    level (the card's libjpeg or cv2 may differ from the golden's), the
    augmented pose image within 4 (OpenCV 4.13's and 5.0's warpAffine
    differ by that much on one input), the network's outputs within rtol
    1e-4 (atol 1e-4 of their largest magnitude), IS 1e-4 and FID 1e-5
    relative, the crop within 1e-5;
20. cvbae training with the GAN branch at full width through ``main``:
    phase [7]'s configuration with ``use_gan`` and ``grad_pen`` at the
    JAX defaults (a PatchGAN of ndf 64 and 3 layers in bf16, gan_weight
    1, lambda_gp 10, Adam 2e-4 with betas (0.5, 0.9)), 6 steps, each of
    which must be finite, launch each ELU+dropout kernel at all 70 / 66
    sites, move the discriminator and log a loss and a discriminator loss
    that are their terms recomposed; ``-r`` to step 8 must start from the
    saved discriminator and Adam moments, bit for bit; ``-m infer``.
    Printed: the median step beside phase [7]'s (the same configuration
    without the GAN), the discriminator's share of the step (its update
    and the generator's pass through it, replayed alone), peak memory and
    the bf16 PatchGAN's logits against f32;
21. the port's cvbae GAN step at small width against
    ``tests/golden/torch_port_gan_small.npz`` (two JAX steps with the R1
    penalty), in f32 with TF32 off;
22. serving the new paths: one B=20, T=50, 256 px alter request through a
    VUNet with ``subpixel_upsampling: false`` behind phase [4]'s behavior
    net and flow, timed beside the subpixel VUNet's request of the same
    call; ``bdvs-generate-torch --from_dataset`` in-process behind phase
    [20]'s synth.npz for a behavior run trained here on a Human3.6M tree
    (phase [18]'s writer at 256 px; real appearances and cameras) and for
    the same net under an ``h36m_synthetic`` data config (the synthetic
    fallback).  Each request must launch the rollout kernel once, and a
    ``--from_dataset`` request's arrays must equal the port's data path's
    for the same items;
23. the figures and videos at full width: ``bdvs-train-torch`` for
    behavior_net (``configs/behavior_net.yaml``: B=64, T=50,
    ``dim_hidden_b`` 1024, 15 flows of mid width 2048, f32) with ``--debug
    -v -s`` and phase [20]'s run as the synthesis run (its 256 px alter
    VUNet), on a Human3.6M tree written here (2 subjects x 2 actions x 100
    frames of 256 px JPEG, 2 cameras), then ``-m infer --debug -v -s``
    (the post-hoc probes 5 iterations); the MT-VAE
    (``configs/mt_vae.yaml``, one debug epoch) with ``-v``, then ``-m infer
    -v``; ``bdvs-data-smoke-torch`` in its three modes on the Human3.6M
    tree and once on phase [18]'s DeepFashion tree.  Every file the JAX
    hooks name for these calls must exist and decode, the RGB videos must
    hold 50 frames of the synthesis run's size (stickman beside frame) that
    are finite and not constant, the rollout kernel must launch once per
    pipeline call, and the first call's rollout must agree with its plain
    version on the kernel's bf16 operands (phase [3]'s tolerance; the gap
    to the decoder's f32 loop is reported).  Printed: each hook's wall
    time, split into its device work and the host's drawing and encoding;
24. quantized, transposed and l2/ln serving at full width: (a) the int8
    conv kernel (``csrc/conv_int8.cu``), one launch for a whole int8
    NormConv2d call (bias, aux, gamma and beta), against its plain version
    at the sites of a 125-frame chunk (128 px x 64 -> 64, 128 and stride
    2; 64 px x 128 -> 128 and 256; 256 px x 32 -> 32 and stride 2; the
    aux calls 128 px x (64 + 64) -> 64 and 64 px x (128 + 128) -> 128;
    32 px x 128 -> 512; 8 px x (128 + 128) -> 128): the int32 sums equal
    and the bf16 outputs within one ulp, each site timed beside its bound
    (aux's bytes counted), x's conv and bias alone, the plain version,
    ``F.unfold`` + ``torch._int_mm`` (with its peak memory) and the cuDNN
    bf16 conv, with the kernel's launch plan and its registers and spills
    from ``build.log``; (b) B=20, T=50 requests behind phase [4]'s
    behavior net and flow through VUNets with the weights of a bf16
    reference VUNet: the ``tpu-serving`` preset (int8_static,
    quant_max_hw 128; its int8 calls by shape, and under
    ``torch.profiler`` the kernel's summed device time and the device-busy
    share of ``generate`` and of ``transfer_cached``), int8_static,
    dynamic int8 (each within a relative L2 of 5e-2 of the reference's
    frames, launching the kernel once for every int8 NormConv2d call its
    VUNet's hooks count, two servings bit-equal), the
    transposed upsample (within 1e-2 of the subpixel request's frames,
    the stickmen equal), and an org
    request at phase [9]'s shape, twice bit-equal, then under int8_static;
    each with its wall
    time, frames/s, ``transfer_cached`` stage and peak memory, the static
    ones calibrating on the request first; the scales of 125-frame chunks
    against one calibration call, and of two calls on two servings (0);
    the bf16 request served twice, bit-equal, and twice with the
    rollout's plain version in place of the kernel, bit-equal (the VUNet
    adds no run-to-run difference); (c) ``bdvs-generate-torch --preset
    tpu-serving`` and ``--upsample transpose`` in-process on a synth.npz
    of (b)'s VUNet; (d) an ``l2`` and an ``ln`` VUNet, each serving one
    (b) request and training two cvbae steps at phase [7]'s configuration
    (finite losses, step times);
25. quantized NormConv2d of kernel 5x5 padding 2, 7x7 padding 3 and 3x3
    padding 0 at 20 x 64 px x 64 -> 64 (bf16): through the library route
    (``F.unfold`` + ``torch._int_mm``), its int32 sums and outputs equal to
    the plain version's, timed beside it and the cuDNN bf16 conv;
26. multi-device training: phase [7]'s cvbae config with ``dropout_impl:
    pallas_sharded`` and ``configs/behavior_net.yaml`` (3 flows, ``--debug``
    on 192 sequences) with ``training.fsdp``, 3 steps each through
    ``main``, without a process group and on a group of one rank (NCCL, a
    ``file://`` store, in this process: the gradient, KL and metric
    all-reduces and the FSDP flow stage run): the checkpoints equal within
    tests/test_torch_parallel.py's tolerances, the step times of both;
27. offline Human3.6M preparation: synthetic views through
    ``data/prep/process.py``'s ``view_annotation_rows`` and
    ``write_annot_export`` (``data/h5lite.py``, no h5py), read back
    through ``Human36mDataset`` without h5py;
28. the modules no config reaches, at full width on seeded weights made
    on the card (f32, TF32 off): ``UnconditionalFlow`` with the ``gin``,
    ``nice`` and ``rqs`` (8 bins) couplings, ``ConditionalFlow``
    (sequential) and ``ConditionalTransformer`` over a ``DenseEmbedder``
    of a 15-way one-hot and over an ``Embedder`` of 256 px RGB (B=20,
    n_down 4) at the behavior flow's width (1024 channels, mid width
    2048, hidden depth 2, 15 flows, B=256, the coupling MLPs' output
    layers scaled by 0.1); ``ARFullyConnectedNet`` (1024 -> 2048, 2048 ->
    2048, with and without a 1024-d condition); ``RIM`` (153 inputs, 8
    units of 128, k 4, B=64, T=50) as a 2-layer bidirectional LSTM and a
    GRU; ``SequenceDisc`` (hidden 256, each input type) at the MT-VAE's
    B=256, T=61, 153 inputs; ``SequenceDiscConv`` (153 keypoints, T=50,
    B=64); ``MIDisc`` and ``MIDiscConv`` over a 1024-d latent at B=256;
    ``ResnetBlock2D`` and ``SelfAttention2D`` (beta 0.5) at 20 x 64^2 x
    128; ``BasicUnConnectedNet`` (1024, depth 2, hidden 256, B=64).  Each
    against the same state dict on the CPU (4 rows of its batch) and each
    flow's reverse(forward(x)) within rel-L2 1e-4, with its median ms by
    CUDA events and peak memory; then a ``ConditionalTransformer``
    placed by ``parallel/sharding_rules.py:shard_module_state`` on a
    1-rank NCCL group's ("data", "model") mesh: its forward and one Adam
    step bit-equal to the unplaced module's under deterministic
    algorithms.  No hand-written kernel is on this path.

The last two lines are a JSON object of kernel results and
``{"ok": true, "device": {...}}``; any failure exits non-zero before them.
All measured values also go to a JSON file, ``build/chip_smoke.json`` unless
``--out PATH`` names another.
"""
import argparse
import collections
import contextlib
import copy
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
import yaml

# the script's directory, the checkout's root, is first on sys.path
from behavior_driven_video_synthesis_tpu_torch import generate as cli
from behavior_driven_video_synthesis_tpu_torch import main as train_cli
from behavior_driven_video_synthesis_tpu_torch import pipeline as pipeline_mod
from behavior_driven_video_synthesis_tpu_torch.core.checkpoint import (
    CheckpointManager)
from behavior_driven_video_synthesis_tpu_torch.core.config import (
    deep_merge, load_config)
from behavior_driven_video_synthesis_tpu_torch.core.precision import (
    disable_tf32)
from behavior_driven_video_synthesis_tpu_torch.experiments import (
    behavior_net, mt_vae, shape_and_pose_net)
from behavior_driven_video_synthesis_tpu_torch.experiments.data_factory import (
    build_sequence_data)
from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
    flatten_tree, unflatten_tree)
from behavior_driven_video_synthesis_tpu_torch.data import parts
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    Human36mDataset, detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.data.synthetic_images import (
    SyntheticImageDataset)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman, render_stickman_plain)
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet, ResidualDecoder, decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.flows import LatentFlow
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.discriminators import (
    SequenceDiscMichael)
from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
    LaplacianPyramidFeatures)
from behavior_driven_video_synthesis_tpu_torch.models.probes import (
    ClassifierAction, ClassifierActionBeta, RegressorFly)
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
    VUNet, VunetRegressor, latent_widths, vunet_from_config)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as ops_nn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import conv_epilogue
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import conv_int8
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import elu_dropout
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import fused_rnb
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import stickman
from behavior_driven_video_synthesis_tpu_torch.ops.cuda.build import (
    build_log, load_library)
from behavior_driven_video_synthesis_tpu_torch.pipeline import (
    BehaviorTransferPipeline)
from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
    BehaviorTrainState, StepDraws, make_behavior_train_step)
from behavior_driven_video_synthesis_tpu_torch.train.flow import (
    FlowTrainState, make_flow_train_step)
from behavior_driven_video_synthesis_tpu_torch.train.state import (
    make_behavior_optimizers, make_flow_optimizer, make_vunet_optimizers)
from behavior_driven_video_synthesis_tpu_torch.train.vunet_exp import (
    VunetTrainState, make_cvbae_train_step)
from benchmark.yardstick import (HBM_BYTES_PER_S, fused_rnb_bound_ms,
                                 rollout_bound_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
# the serving slice of bench.py:202-236
SLICE = dict(B=20, T=50, S=256, HID=1024, K_FULL=51, K_USE=48, NF_START=32,
             NF_MAX=128, N_FLOWS=15)
ROLLOUT_SHAPES = [(20, 48, 1024, 50), (1, 48, 1024, 50), (3, 51, 1024, 7),
                  (256, 48, 1024, 50)]
# the rollout timed: the serving request's shape and bulk sampling's batch
ROLLOUT_TIMED = [(20, 48, 1024, 50), (256, 48, 1024, 50)]
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_slice_small.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_port_train_small.npz")
ORG_GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_org_small.npz")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "shape_and_pose_net.yaml")
ORG_CONFIG = os.path.join(ROOT, "configs", "vunet.yaml")
BEHAVIOR_CONFIG = os.path.join(ROOT, "configs", "behavior_net.yaml")
BEHAVIOR_GOLDEN = os.path.join(ROOT, "tests", "golden",
                               "torch_port_behavior_small.npz")
INFER_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_port_infer_small.npz")
# --debug: 2 epochs and 1 flow epoch of 8 batches of 64 sequences
BEHAVIOR_STEPS, BEHAVIOR_FLOW_STEPS = 16, 8
TRAIN_STEPS = 6
# the VUNet's dropout sites at 256 px, 7 scales, 2 latent scales: 14 RNBs
# in each EncUp (one site each), 5 residual RNBs in EncDown and 16 in
# DecDown (two sites each)
DROPOUT_SITES = 14 + 14 + 2 * 5 + 2 * 16
# sites whose output reaches no loss term, so autograd never runs their
# backward (nor does XLA, which drops them as dead code): EncDown's last
# two residual blocks (the second block of the last latent scale and
# fin_block) feed only EncDown's returned features
DEAD_BACKWARD_SITES = 2 * 2
ELU_DROPOUT_SHAPES = [((12, 256, 256, 32), torch.bfloat16),
                      ((1000003,), torch.float32)]
ELU_DROPOUT_RATES = (0.05, 0.5)
# the sweeps' rates: 1e-12 keeps every element but one in 2**32 (thresh
# 2**32 - 1), so every input value meets the ELU
ELU_DROPOUT_SWEEP_RATES = (1e-12, 0.05, 0.5)
# the cvbae step's dropout sites ([7]: configs/shape_and_pose_net.yaml at
# 256 px, B=12, nf 32->128), each with its forward and backward launches a
# step (DROPOUT_SITES and DROPOUT_SITES - DEAD_BACKWARD_SITES in all; [7]
# checks them against the step's own launches)
CVBAE_DROPOUT_SITES = {(12, 256, 256, 32): (8, 8), (12, 128, 128, 64): (8, 8),
                       (12, 64, 64, 128): (8, 8), (12, 32, 32, 128): (8, 8),
                       (12, 16, 16, 128): (10, 8), (12, 8, 8, 128): (14, 12),
                       (12, 4, 4, 128): (14, 14)}
# the fused RNB kernel held against its plain version: sites of a
# 125-frame chunk (B=20, T=50 is 8 chunks of 125) and a ragged shape
FUSED_RNB_SHAPES = [(125, 256, 256, 32), (125, 128, 128, 64),
                    (125, 64, 64, 128), (125, 32, 32, 128),
                    (125, 4, 4, 128), (3, 37, 53, 64)]
# the fused RNB's sites in one org B=20, T=50 request and its launches at
# each: the two RNBs of each EncUp scale, once a 125-frame chunk in du (7
# scales from 256 px at nf 32 to 4 px at 128, 8 chunks) and once a video in
# eu (5 scales of the 64x64 part stack)
CHUNK_RNB_SITES = [(125, s, s, min(32 * 256 // s, 128))
                   for s in (256, 128, 64, 32, 16, 8, 4)]
ORG_RNB_SITES = {**{site: 2 * 8 for site in CHUNK_RNB_SITES},
                 **{(20, s, s, min(32 * 64 // s, 128)): 2
                    for s in (64, 32, 16, 8, 4)}}
ORG_RNB_LAUNCHES = sum(ORG_RNB_SITES.values())      # 2 * 5 + 2 * 7 * 8
ALTER_RNB_LAUNCHES = 2 * 7 + 2 * 7 * 8
# the conv epilogue's sites: conv outputs of a 125-frame chunk
EPILOGUE_SITES = [(125, 256, 256, 32), (125, 128, 128, 64),
                  (125, 64, 64, 128), (125, 4, 4, 128), (125, 256, 256, 3)]
# the stickman raster's check: one bulk request's frames (B*T = 1,000) at
# 256 px, thickness 4, the detailed H36M joint model in world coordinates
# (as the benchmark's cells serve it)
STICK = dict(frames=1000, S=256, thickness=4.0)
# one org test_forward chunk: du's 14 and the prior's two pre blocks
ORG_PRIOR_RNB_LAUNCHES = 2 * 7 + 2
# NVIDIA's H100 SXM data sheet: the f32 peak outside the tensor cores, at
# 700 W (the HBM rate and the bf16 tensor-core peak are the benchmark's,
# benchmark/yardstick.py)
F32_FLOPS = 67e12
# the CUDA programming guide's arithmetic instruction throughput, compute
# capability 9.0: 32-bit integer multiplies and multiply-adds a clock an SM
INT32_MADS_PER_CLOCK_SM = 64
RESULTS = {}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, iters, median=False):
    """Device time of fn by CUDA events, warm: the mean over one loop of
    iters calls, or (median) the median of iters calls each between two
    events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if median:
        times = []
        for _ in range(iters):
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def on_device(module, g):
    """A module built on the meta device, materialized on the card and
    filled with seeded values there."""
    return init_random_(module.to_empty(device=DEV), g).eval()


# -- 28. the dormant modules at full width -----------------------------------
# No config names these modules (users import them); their widths come from
# the configs beside them.  The flows run at the behavior flow's width
# (configs/behavior_net.yaml: 1024 channels, mid width 2048, hidden depth
# 2, 15 flows) at bulk sampling's B=256.
DORMANT = dict(C=1024, MID=2048, DEPTH=2, N_FLOWS=15, B=256, BINS=8,
               LABELS=15, IMG=256, IMG_B=20, N_DOWN=4, KPS=153, RIM_N=8,
               RIM_H=128, RIM_K=4, RIM_B=64, T=50, MTVAE_B=256, MTVAE_T=61,
               VUNET_HW=64, VUNET_C=128, MIN_DIM=128)
# the CPU recomputes these rows of the card's batch (every module here
# computes each row on its own)
DORMANT_CPU_ROWS = 4
DORMANT_TOL = 1e-4


def _tame_couplings(factor=0.1):
    """The coupling MLPs' output layers scaled by ``factor``: with weights
    of N(0, 1/fan_in) a GIN scale channel sums 511 tanh values, and 15
    flows of such maps overflow f32 or lose the reverse to rounding."""
    def prepare(module):
        from behavior_driven_video_synthesis_tpu_torch.ops.nn import (
            FullyConnectedNet)
        for m in module.modules():
            if isinstance(m, FullyConnectedNet):
                last = [x for x in m.main if isinstance(x, torch.nn.Linear)]
                for p in last[-1].parameters():
                    p.mul_(factor)
    return prepare


def _dormant_cases(g):
    """(name, make(device), prepare, inputs on the card, call, is_flow)
    of every module of phase [28]; call(module, *inputs) returns a tuple
    of batch-first tensors."""
    from behavior_driven_video_synthesis_tpu_torch.models import (
        discriminators as disc, flows, rim)
    from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
    d = DORMANT
    C, MID, DEPTH, NF, B = d["C"], d["MID"], d["DEPTH"], d["N_FLOWS"], d["B"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    def flat(out):
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
    cases = []
    for kind in ("gin", "nice", "rqs"):
        cases.append((
            f"UnconditionalFlow {kind}", lambda dev, kind=kind:
            flows.UnconditionalFlow(C, MID, DEPTH, NF, coupling_type=kind,
                                    device=dev),
            _tame_couplings(), [randn(B, C)],
            lambda m, x: m(x), True))
    onehot = F.one_hot(torch.randint(0, d["LABELS"], (B,), generator=g,
                                     device=DEV), d["LABELS"]).float()
    cases += [
        ("ConditionalFlow sequential", lambda dev: flows.ConditionalFlow(
            C, C, MID, DEPTH, NF, conditioning_option="sequential",
            device=dev), _tame_couplings(), [randn(B, C), randn(B, C)],
            lambda m, x, e: m(x, e), True),
        ("ConditionalTransformer DenseEmbedder (15-way one-hot)",
         lambda dev: flows.ConditionalTransformer(
             C, MID, DEPTH, NF, conditioning_option="parallel",
             conditioning_in_channels=d["LABELS"], device=dev),
         _tame_couplings(), [randn(B, C), onehot],
         lambda m, x, y: m(x, y), True),
        ("ConditionalTransformer Embedder (256 px RGB)",
         lambda dev: flows.ConditionalTransformer(
             C, MID, DEPTH, NF, conditioning_spatial_size=d["IMG"],
             conditioning_in_channels=3, embedder_down=d["N_DOWN"],
             device=dev), _tame_couplings(),
         [randn(d["IMG_B"], C),
          torch.rand(d["IMG_B"], d["IMG"], d["IMG"], 3, generator=g,
                     device=DEV) * 2 - 1],
         lambda m, x, y: m(x, y), True)]
    for ncond in (0, C):
        cases.append((
            f"ARFullyConnectedNet ncond {ncond}",
            lambda dev, ncond=ncond: flows.ARFullyConnectedNet(
                C, (MID, MID), 2 * C, ncond=ncond, device=dev), None,
            [randn(B, C)] + ([randn(B, ncond)] if ncond else []),
            lambda m, *a: flat(m(*a)), False))
    RB, T, N, H = d["RIM_B"], d["T"], d["RIM_N"], d["RIM_H"]
    for cell, layers, bi in (("LSTM", 2, True), ("GRU", 1, False)):
        states = layers * (2 if bi else 1)
        ins = [randn(RB, T, d["KPS"]), randn(RB, states, N * H)]
        if cell == "LSTM":
            ins.append(randn(RB, states, N * H))
        cases.append((
            f"RIM {cell} {layers} layer(s){' bidirectional' if bi else ''}",
            lambda dev, cell=cell, layers=layers, bi=bi: rim.RIM(
                d["KPS"], H, N, d["RIM_K"], rnn_cell=cell, n_layers=layers,
                bidirectional=bi, device=dev), None, ins,
            lambda m, x, *hc: tuple(o.transpose(0, 1) for o in m(
                x.transpose(0, 1), *[s.transpose(0, 1) for s in hc])),
            False))
    seq = randn(d["MTVAE_B"], d["MTVAE_T"], d["KPS"])
    for input_type in ("poses", "changes", "combined"):
        cases.append((
            f"SequenceDisc {input_type}",
            lambda dev, it=input_type: disc.SequenceDisc(
                d["KPS"], 256, input_type=it, device=dev), None, [seq],
            lambda m, x: (lambda o: (o[0], *o[1]))(m(x)), False))
    vhw, vc = d["VUNET_HW"], d["VUNET_C"]
    cases += [
        ("SequenceDiscConv", lambda dev: disc.SequenceDiscConv(
            d["KPS"], T, device=dev), None, [randn(RB, T, d["KPS"])],
         lambda m, x: flat(m(x)), False),
        ("MIDisc", lambda dev: disc.MIDisc(C, device=dev), None,
         [randn(B, C)], lambda m, x: flat(m(x)), False),
        ("MIDiscConv", lambda dev: disc.MIDiscConv(C, device=dev), None,
         [randn(B, C)], lambda m, x: flat(m(x)), False),
        ("ResnetBlock2D", lambda dev: disc.ResnetBlock2D(vc, vc,
                                                         device=dev),
         None, [randn(20, vhw, vhw, vc)], lambda m, x: flat(m(x)), False),
        ("SelfAttention2D (beta 0.5)", lambda dev: disc.SelfAttention2D(
            vc, device=dev), lambda m: m.beta.fill_(0.5),
         [randn(20, vhw, vhw, vc)], lambda m, x: flat(m(x)), False),
        ("BasicUnConnectedNet", lambda dev: pnn.BasicUnConnectedNet(
            C, 2, 256, device=dev), None, [randn(64, C)],
         lambda m, x: flat(m(x)), False)]
    return cases


def dormant_module(name, make, prepare, inputs, call, is_flow, g):
    """One module of phase [28] on the card against the CPU; returns its
    record."""
    card = on_device(make("meta"), g)
    if prepare is not None:
        with torch.no_grad():
            prepare(card)
    cpu = make("meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    cpu.eval()
    rows = DORMANT_CPU_ROWS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = call(card, *inputs)
        ms = cuda_ms(lambda: call(card, *inputs), 5, median=True)
        peak = torch.cuda.max_memory_allocated()
        ref = call(cpu, *[x[:rows].cpu() for x in inputs])
        err = max(rel_l2(o[:rows].cpu(), r) for o, r in zip(out, ref))
        for o in out:
            check(bool(torch.isfinite(o).all()), f"[28] {name}: not finite")
        check(err <= DORMANT_TOL, f"[28] {name}: card against the CPU, "
              f"rel-L2 {err:.2e} > {DORMANT_TOL:.0e}")
        rec = dict(ms=ms, peak_gib=peak / 2 ** 30, cpu_rel_l2=err,
                   params=sum(p.numel() for p in card.parameters()))
        if is_flow:
            back = card.reverse(out[0], *inputs[1:])
            rt = rel_l2(back, inputs[0])
            check(rt <= DORMANT_TOL, f"[28] {name}: reverse(forward(x)) "
                  f"rel-L2 {rt:.2e} > {DORMANT_TOL:.0e}")
            rec["round_trip_rel_l2"] = rt
            rec["reverse_ms"] = cuda_ms(
                lambda: card.reverse(out[0], *inputs[1:]), 5, median=True)
    shapes = ", ".join("x".join(map(str, x.shape)) for x in inputs)
    extra = (f"; reverse {rec['reverse_ms']:.3f} ms, reverse(forward(x)) "
             f"rel-L2 {rec['round_trip_rel_l2']:.2e}" if is_flow else "")
    log(f"    {name} ({rec['params'] / 1e6:.1f} M parameters; {shapes}): "
        f"{ms:.3f} ms (median of 5 by CUDA events), peak "
        f"{rec['peak_gib']:.2f} GiB, card against the CPU on {rows} rows "
        f"rel-L2 {err:.2e}{extra}")
    return rec


def dormant_model_axis(g):
    """The "model"-axis rules on a 1-rank NCCL group's ("data", "model")
    mesh: a full-width ConditionalTransformer placed by shard_module_state
    against the same module unplaced, one forward and one Adam step each
    under deterministic algorithms, all bit-equal."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from behavior_driven_video_synthesis_tpu_torch.models import flows
    from behavior_driven_video_synthesis_tpu_torch.parallel import (
        sharding_rules)
    d = DORMANT
    C, MID, DEPTH, NF, B = d["C"], d["MID"], d["DEPTH"], d["N_FLOWS"], d["B"]

    def make(dev):
        return flows.ConditionalTransformer(
            C, MID, DEPTH, NF, conditioning_option="sequential",
            conditioning_in_channels=d["LABELS"], device=dev)
    seed = int(torch.randint(0, 2 ** 31, (1,), generator=g, device=DEV))
    x = torch.randn(B, C, generator=g, device=DEV)
    y = F.one_hot(torch.randint(0, d["LABELS"], (B,), generator=g,
                                device=DEV), d["LABELS"]).float()
    plan = convert.conditional_transformer_plan(NF, DEPTH + 2, True, False,
                                                2)
    base = tempfile.mkdtemp(prefix="chip_smoke_axis_")
    runs = {}
    dist.init_process_group("nccl", init_method=f"file://{base}/pg", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        # a data dimension beside "model": the backward's average over it
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        with deterministic_algorithms() as nondeterministic:
            for placed in (False, True):
                module = on_device(make("meta"),
                                   torch.Generator(DEV).manual_seed(seed))
                with torch.no_grad():
                    _tame_couplings()(module)
                module.train()
                dims = (sharding_rules.shard_module_state(
                    module, mesh, plan, min_dim=d["MIN_DIM"])
                    if placed else None)
                opt = torch.optim.Adam(module.parameters(), lr=1e-4)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z, logdet = module(x, y)
                loss = 0.5 * (z ** 2).sum() / B - logdet.mean()
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                params = {k: (v.full_tensor() if hasattr(v, "full_tensor")
                              else v).detach().clone()
                          for k, v in module.named_parameters()}
                moments = [st for st in opt.state.values()]
                runs[placed] = dict(z=z.detach(), logdet=logdet.detach(),
                                    params=params, dims=dims, ms=step_ms,
                                    moments=moments)
                del module, opt
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(base, ignore_errors=True)
    a, b = runs[True], runs[False]
    check(torch.equal(a["z"], b["z"]) and torch.equal(a["logdet"],
                                                      b["logdet"]),
          "[28] model axis: the placed forward differs")
    differ = [k for k in b["params"] if not torch.equal(a["params"][k],
                                                        b["params"][k])]
    check(not differ, f"[28] model axis: the placed Adam step differs at "
          f"{differ[:3]}")
    sharded = sum(v is not None for v in a["dims"].values())
    check(sharded > 0, "[28] model axis: no parameter sharded")
    placed_moments = sum(
        1 for st in a["moments"] for v in st.values()
        if torch.is_tensor(v) and v.dim() > 0 and hasattr(v, "placements"))
    check(placed_moments == 2 * len(a["dims"]),
          f"[28] model axis: {placed_moments} Adam moments are DTensors")
    log(f"    model axis: ConditionalTransformer (DenseEmbedder, "
        f"sequential, {NF} flows) placed by shard_module_state on a 1-rank "
        f"NCCL group's ('data', 'model') mesh ({sharded} of "
        f"{len(a['dims'])} parameters sharded, every Adam moment a DTensor"
        f"): forward and one Adam step bit-equal to the unplaced module's;"
        f" step {a['ms']:.1f} ms placed, {b['ms']:.1f} ms unplaced (host "
        f"clock, first step); ops without a deterministic implementation: "
        f"{nondeterministic or 'none'}")
    return dict(sharded=sharded, params=len(a["dims"]),
                placed_step_ms=a["ms"], plain_step_ms=b["ms"])


def phase_dormant():
    log(f"[28] the dormant modules at full width on {RESULTS['card']}: "
        f"each against the same state dict on the CPU "
        f"({DORMANT_CPU_ROWS} rows) within rel-L2 {DORMANT_TOL:.0e}, each "
        f"flow's reverse(forward(x)) too; f32, TF32 off")
    g = torch.Generator(DEV).manual_seed(28)
    records = {}
    for name, make, prepare, inputs, call, is_flow in _dormant_cases(g):
        records[name] = dormant_module(name, make, prepare, inputs, call,
                                       is_flow, g)
        torch.cuda.empty_cache()
    records["model axis"] = dormant_model_axis(g)
    RESULTS["dormant"] = records


# -- 1. the card --------------------------------------------------------------
def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {name}; {torch.cuda.device_count()} device(s)")
    log(card)
    RESULTS["card"] = card
    return name


# -- 2. the build -------------------------------------------------------------
KERNEL_SOURCES = ("rollout", "elu_dropout", "fused_rnb", "conv_int8",
                  "conv_epilogue", "stickman")


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for lib in pool.map(load_library, KERNEL_SOURCES):
            check(lib is not None, "a kernel library did not load")
    log(f"[2] csrc/{{{','.join(KERNEL_SOURCES)}}}.cu built in parallel and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        log(f"    csrc/{name}.cu:")
        log(build_log(name).strip())
    cfg = rollout.rollout_config(20, 48, 1024)
    log(f"    launch at (B, K, H) = (20, 48, 1024): {cfg}")
    RESULTS["rollout_config"] = cfg


# -- 3. kernel against its plain version --------------------------------------
def rollout_args(B, K, H, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)

    def u(*shape, scale):
        return (torch.rand(*shape, generator=g, device=DEV) * 2 - 1) * scale
    bound = H ** -0.5
    return (u(B, H, scale=1.0), u(B, K, scale=0.5), u(4 * H, K, scale=bound),
            u(4 * H, H, scale=bound), u(4 * H, scale=bound),
            u(4 * H, scale=bound), u(K, H, scale=bound), u(K, scale=bound))


def rollout_decoder(args):
    """A ResidualDecoder on the card holding rollout_args' weights."""
    (_, H), K = args[0].shape, args[1].shape[1]
    decoder = ResidualDecoder(K, H, device="meta").to_empty(device=DEV)
    names = ("rnn.weight_ih", "rnn.weight_hh", "rnn.bias_ih", "rnn.bias_hh",
             "n_out.weight", "n_out.bias")
    decoder.load_state_dict(dict(zip(names, args[2:])))
    return decoder.eval()


def phase_kernel():
    log("[3] rollout kernel vs plain PyTorch (bf16 operands: atol 1e-2, "
        "rtol 1e-2; f32 operands: reported, the JAX kernel test allows "
        "atol 5e-2, rtol 1e-2)")
    errs = []
    for B, K, H, T in ROLLOUT_SHAPES:
        args = rollout_args(B, K, H)
        with torch.no_grad():
            out = rollout.residual_lstm_rollout(*args, T)
            torch.cuda.synchronize()
            ref16 = rollout.residual_lstm_rollout_plain(
                *args, T, operand_dtype=torch.bfloat16)
            ref32 = rollout.residual_lstm_rollout_plain(*args, T)
        check(out.shape == (B, T, K) and bool(torch.isfinite(out).all()),
              f"rollout output at {(B, K, H, T)}")
        e16 = float((out - ref16).abs().max())
        e32 = float((out - ref32).abs().max())
        ok16 = torch.allclose(out, ref16, atol=1e-2, rtol=1e-2)
        ok32 = torch.allclose(out, ref32, atol=5e-2, rtol=1e-2)
        log(f"    (B,K,H,T)={(B, K, H, T)}: max|kernel-plain_bf16| {e16:.3e}"
            f" ({'ok' if ok16 else 'FAIL'}), max|kernel-plain_f32| "
            f"{e32:.3e} (within JAX test tolerance: {ok32}), "
            f"max|out| {float(out.abs().max()):.3f}")
        RESULTS.setdefault("rollout_vs_plain", []).append(
            dict(shape=[B, K, H, T], max_abs_err_bf16=e16,
                 max_abs_err_f32=e32, within_jax_tol_f32=bool(ok32)))
        check(ok16, f"kernel disagrees with its plain version at "
              f"{(B, K, H, T)}")
        errs.append(e16)
    for name, (regs, st, ld) in sorted(
            ptxas_report(build_log("rollout"), "rollout_kernel").items()):
        log(f"    rollout_kernel<weights in smem={bool(name)}>: {regs} "
            f"registers, spill stores {st} B, spill loads {ld} B")
        RESULTS.setdefault("rollout_registers", {})[name] = dict(
            registers=regs, spill_stores=st, spill_loads=ld)
    log("    times: the kernel on prepared operands (CUDA events), the "
        "decoder_rollout_kernel call with its operands cached (route), T "
        "and 2T grid barriers alone on the same grid (floors: the kernel "
        "takes two barriers a step since it sums in a fixed order); two "
        "launches on the same operands must be bit-equal")
    timed = {}
    for B, K, H, T in ROLLOUT_TIMED:
        args = rollout_args(B, K, H)
        decoder = rollout_decoder(args)
        b, x0 = args[:2]
        cfg = rollout.rollout_config(B, K, H)
        with torch.no_grad():
            operands = decoder.rollout_operands()

            def kernel():
                return rollout.residual_lstm_rollout_prepared(b, x0,
                                                              operands, T)

            def plain():
                return rollout.residual_lstm_rollout_plain(
                    *args, T, operand_dtype=torch.bfloat16)

            def route():
                return decoder_rollout_kernel(decoder, b, x0, T)
            out = kernel()
            again = kernel()
            check(torch.equal(out, again), f"two rollout launches on the "
                  f"same operands differ at {(B, K, H, T)}: max "
                  f"{float((out - again).abs().max()):.3e}")
            ref = rollout.residual_lstm_rollout_prepared_plain(
                b, x0, operands, T)
            e = float((out - ref).abs().max())
            check(torch.allclose(out, ref, atol=1e-2, rtol=1e-2),
                  f"kernel on prepared operands disagrees with its plain "
                  f"version at {(B, K, H, T)}: {e:.3e}")
            if B <= 32:
                order = [("plain", plain, 5), ("kernel", kernel, 50),
                         ("kernel", kernel, 50), ("plain", plain, 5)]
            else:
                order = [("kernel", kernel, 20), ("kernel", kernel, 20),
                         ("plain", plain, 1)]
            times = [(name, cuda_ms(fn, n)) for name, fn, n in order]
            builds = ops_nn.prepared_builds["rollout"]
            route_ms = cuda_ms(route, 20)
            check(ops_nn.prepared_builds["rollout"] == builds,
                  "decoder_rollout_kernel rebuilt cached operands")
            floor_ms = cuda_ms(
                lambda: rollout.barrier_floor(B, K, H, T, DEV), 20)
            floor2_ms = cuda_ms(
                lambda: rollout.barrier_floor(B, K, H, 2 * T, DEV), 20)
        ms = float(np.mean([t for n, t in times if n == "kernel"]))
        plain_ms = float(np.mean([t for n, t in times if n == "plain"]))
        bound, bound_by = rollout_bound_ms(B, K, H, T)
        log(f"    {(B, K, H, T)}: launch {cfg}; "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
            + f"; route {route_ms:.4f} ms; floor of {T} barriers "
            f"{floor_ms:.4f} ms, of {2 * T} {floor2_ms:.4f} ms; bound "
            f"{bound:.5f} ms ({bound_by}); {ms / T * 1e3:.2f} us a step, "
            f"{floor2_ms / T * 1e3:.2f} of them the two barriers; two "
            f"launches bit-equal; max|kernel-plain| {e:.3e}")
        timed[(B, K, H, T)] = dict(
            config=cfg, order=times, ms=ms, plain_ms=plain_ms,
            route_ms=route_ms, floor_ms=floor_ms, floor_2t_ms=floor2_ms,
            bound_ms=bound, bound_by=bound_by, max_abs_err=e,
            repeat_bit_equal=True)
    RESULTS["rollout_times_ms"] = [dict(shape=list(k), **v)
                                   for k, v in timed.items()]
    serving = timed[ROLLOUT_TIMED[0]]
    return max(errs), serving["ms"], serving["plain_ms"]


def sm_clock_hz():
    """The card's SM clock: torch's device properties where they hold it,
    else the H100 SXM's maximum boost clock, 1,980 MHz (NVIDIA's data
    sheet)."""
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", None)
    if khz:
        return khz * 1e3, "device properties"
    return 1.98e9, "stated (H100 SXM maximum boost)"


def philox_floor_ms(n):
    """Least time of the n / 4 Philox4x32-10 blocks that n elements need: 4
    32-bit multiplies a round (the high and low words of two 32x32
    products; the first round's second product is of a zero word), 38 a
    block, at compute capability 9.0's 64 32-bit integer multiply-adds a
    clock an SM (CUDA programming guide, arithmetic instruction throughput)
    on every SM at the SM clock."""
    blocks = (n + 3) // 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = INT32_MADS_PER_CLOCK_SM * sms * sm_clock_hz()[0]
    return blocks * 38 / rate * 1e3


def elu_dropout_bound_parts(n, dtype, backward):
    """The three floors of one ELU+dropout pass over n elements, in ms:
    x (and ct) read once and out written once over the HBM rate; ~4 f32
    operations an element (the compare, exp, product and select) at the
    f32 peak outside the tensor cores; Philox's integer multiplies
    (philox_floor_ms)."""
    size = torch.tensor([], dtype=dtype).element_size()
    return {"bytes": (3 if backward else 2) * n * size / HBM_BYTES_PER_S
            * 1e3,
            "f32": 4 * n / F32_FLOPS * 1e3,
            "philox": philox_floor_ms(n)}


def elu_dropout_bound_ms(n, dtype, backward):
    """The largest of elu_dropout_bound_parts, and whether bytes or
    operations (f32 or Philox's integer work) set it."""
    parts = elu_dropout_bound_parts(n, dtype, backward)
    bound = max(parts.values())
    return bound, "bytes" if parts["bytes"] >= bound else "operations"


def ulp_ok(out, ref):
    """|out - ref| within one ulp of ref in bf16, within 1e-6 in f32."""
    if out.dtype == torch.bfloat16:
        ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp(
            min=torch.finfo(torch.bfloat16).tiny)
        return bool(((out.float() - ref.float()).abs() <= ulp).all())
    return bool(((out - ref).abs() <= 1e-6).all())


def sweep_ok(out, ref):
    """ulp_ok where ref is finite; NaN exactly where ref is NaN and the
    same infinities where ref is infinite."""
    fin = torch.isfinite(ref)
    inf = torch.isinf(ref)
    return (torch.equal(torch.isnan(out), torch.isnan(ref))
            and torch.equal(out[inf], ref[inf]) and ulp_ok(out[fin],
                                                            ref[fin]))


def keep_mismatches(out, ref, keep):
    """Elements whose zero pattern differs from the plain version's, or
    that are non-zero though dropped: an element is 0 where it is dropped
    and where the plain version's value is 0."""
    return int(((out == 0) != (ref == 0)).sum()
               + ((out != 0) != (keep & (ref != 0))).sum())


def elu_dropout_sweep(what, x, ct, g, offsets=(0, 3)):
    """Forward and backward of the kernels over x against their plain
    versions at ELU_DROPOUT_SWEEP_RATES and the element offsets: 0 keep
    mismatches, values by sweep_ok."""
    rows = []
    for rate in ELU_DROPOUT_SWEEP_RATES:
        for off in offsets:
            seed = elu_dropout.draw_seed(DEV, g)
            y = elu_dropout.elu_dropout_forward(x, seed, rate, off)
            dx = elu_dropout.elu_dropout_backward(x, ct, seed, rate, off)
            torch.cuda.synchronize()
            y_ref = elu_dropout.elu_dropout_plain(x, seed, rate, off)
            dx_ref = elu_dropout.elu_dropout_backward_plain(x, ct, seed,
                                                            rate, off)
            keep = elu_dropout.dropout_bits(seed, x.numel(), off) < \
                elu_dropout.keep_params(rate)[0]
            mism = (keep_mismatches(y, y_ref, keep)
                    + keep_mismatches(dx, dx_ref, keep))
            ok = mism == 0 and sweep_ok(y, y_ref) and sweep_ok(dx, dx_ref)
            fin = torch.isfinite(y_ref) & torch.isfinite(dx_ref)
            e_fwd = float((y.float() - y_ref.float())[fin].abs().max())
            e_bwd = float((dx.float() - dx_ref.float())[fin].abs().max())
            log(f"    sweep {what} rate {rate} offset {off}: keep "
                f"mismatches {mism}, {int(keep.sum())} kept; max|fwd-plain| "
                f"{e_fwd:.3e}, max|bwd-plain| {e_bwd:.3e} where finite; "
                f"non-finite values as the plain version's "
                f"({'ok' if ok else 'FAIL'})")
            rows.append(dict(sweep=what, rate=rate, offset=off,
                             keep_mismatches=mism, kept=int(keep.sum()),
                             max_abs_err_fwd=e_fwd, max_abs_err_bwd=e_bwd,
                             ok=ok))
            check(ok, f"ELU+dropout sweep {what} at rate {rate}, offset "
                  f"{off}: the kernels disagree with their plain versions")
    RESULTS.setdefault("elu_dropout_sweeps", []).extend(rows)


def elu_dropout_sweeps(g):
    """Every bf16 bit pattern (65,536, the non-finite ones included), and
    every 4,099th f32 bit pattern with the edge values of the ELU's two
    sides, each beside random ct."""
    x16 = torch.arange(65536, dtype=torch.int32, device=DEV).to(
        torch.int16).view(torch.bfloat16)
    ct16 = torch.randn(x16.shape, generator=g, device=DEV).to(torch.bfloat16)
    elu_dropout_sweep("bf16 all 65,536", x16, ct16, g)
    x32 = torch.arange(0, 2 ** 32, 4099, dtype=torch.int64, device=DEV)
    x32 = torch.where(x32 >= 2 ** 31, x32 - 2 ** 32, x32).to(
        torch.int32).view(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    edges = [0.0, -0.0, 1e-45, -1e-45, -tiny, -tiny / 2, -1e-30, -1e-7,
             -0.25, float(np.nextafter(np.float32(-0.5), np.float32(0))),
             -0.5, float(np.nextafter(np.float32(-0.5), np.float32(-1))),
             -0.6931472, -1.0, -10.0, -87.3, -87.34, -88.0, -88.73, -89.0,
             -103.0, -104.0, -1e30, -3.4028235e38, 3.4028235e38, 1e-30,
             1.0, float("inf"), float("-inf"), float("nan")]
    x32 = torch.cat([x32, torch.tensor(edges, device=DEV)])
    ct32 = torch.randn(x32.shape, generator=g, device=DEV)
    elu_dropout_sweep(f"f32 {x32.numel():,} (every 4,099th pattern and "
                      f"{len(edges)} edges)", x32, ct32, g)


def offset_bit_checks(g):
    """At element offsets 0-7, n and n + 1 the kernels keep exactly the
    elements that the plain version's bits keep (x and ct hold no zero, so
    an output is 0 iff its element is dropped), with values as ulp_ok."""
    for shape, dtype in ELU_DROPOUT_SHAPES:
        x = torch.randn(shape, generator=g, device=DEV).to(dtype)
        ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
        x[x == 0] = 1.0
        ct[ct == 0] = 1.0
        n = x.numel()
        seed = elu_dropout.draw_seed(DEV, g)
        rate = 0.3
        thresh = elu_dropout.keep_params(rate)[0]
        mism = 0
        for off in list(range(8)) + [n, n + 1]:
            y = elu_dropout.elu_dropout_forward(x, seed, rate, off)
            dx = elu_dropout.elu_dropout_backward(x, ct, seed, rate, off)
            torch.cuda.synchronize()
            keep = (elu_dropout.dropout_bits(seed, n, off) < thresh
                    ).reshape(shape)
            mism_off = int(((y != 0) != keep).sum()
                           + ((dx != 0) != keep).sum())
            mism += mism_off
            check(mism_off == 0
                  and ulp_ok(y, elu_dropout.elu_dropout_plain(x, seed, rate,
                                                              off))
                  and ulp_ok(dx, elu_dropout.elu_dropout_backward_plain(
                      x, ct, seed, rate, off)),
                  f"ELU+dropout at offset {off} disagrees with its plain "
                  f"version at {tuple(shape)} {dtype}: {mism_off} keep "
                  f"mismatches")
        log(f"    offsets 0-7, n and n + 1 at {tuple(shape)} "
            f"{str(dtype)[6:]}: keep decisions those of the plain "
            f"version's bits (mismatches {mism}), values within tolerance, "
            f"forward and backward")
        RESULTS.setdefault("elu_dropout_offset_bits", []).append(dict(
            shape=list(shape), dtype=str(dtype), keep_mismatches=mism))


def elu_dropout_site_times(g):
    """Forward and backward at every distinct dropout site of [7]'s cvbae
    step (bf16, rate 0.05), each with its launches a step: the kernel's
    device time a launch (torch.profiler; at the small sites a call's CUDA
    events time the host's launch rate instead, so both are kept), and the
    step's sums of launches x time against launches x bound."""
    rows, sums = [], {"device": 0.0, "call": 0.0, "bound": 0.0}
    for shape, (n_fwd, n_bwd) in CVBAE_DROPOUT_SITES.items():
        x = torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
        ct = torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
        seed = elu_dropout.draw_seed(DEV, g)
        row = dict(shape=list(shape), fwd_launches=n_fwd,
                   bwd_launches=n_bwd)
        for d, launches, fn in (
                ("fwd", n_fwd,
                 lambda: elu_dropout.elu_dropout_forward(x, seed, 0.05)),
                ("bwd", n_bwd,
                 lambda: elu_dropout.elu_dropout_backward(x, ct, seed,
                                                          0.05))):
            dev = device_ms_per_launch(fn, 20, "elu_dropout_kernel")
            call = cuda_ms(fn, 100)
            bound = elu_dropout_bound_ms(x.numel(), torch.bfloat16,
                                         d == "bwd")[0]
            row.update({f"{d}_device_ms": dev, f"{d}_call_ms": call,
                        f"{d}_bound_ms": bound})
            sums["device"] += launches * (dev if dev is not None
                                          else float("nan"))
            sums["call"] += launches * call
            sums["bound"] += launches * bound
        log(f"    site {shape}: " + "; ".join(
            f"{d} x {row[d + '_launches']} device "
            + ("not measured" if row[d + "_device_ms"] is None
               else f"{row[d + '_device_ms']:.4f} ms")
            + f", call {row[d + '_call_ms']:.4f} ms, bound "
            f"{row[d + '_bound_ms']:.4f} ms" for d in ("fwd", "bwd")))
        rows.append(row)
    log(f"    a cvbae step's {sum(f for f, _ in CVBAE_DROPOUT_SITES.values())}"
        f" + {sum(b for _, b in CVBAE_DROPOUT_SITES.values())} launches: "
        f"sum of launches x device time {sums['device']:.4f} ms, of "
        f"launches x call time {sums['call']:.4f} ms, of launches x bound "
        f"{sums['bound']:.4f} ms")
    RESULTS["elu_dropout_sites"] = dict(
        sites=rows, step_device_ms=sums["device"], step_call_ms=sums["call"],
        step_bound_ms=sums["bound"])


def phase_elu_dropout():
    log("[3] ELU+dropout kernels vs plain PyTorch (the same Philox stream: "
        "0 keep-decision mismatches; values within 1 bf16 ulp, or 1e-6 in "
        "f32, non-finite values as the plain version's; drop fraction "
        "within 5 sigma of the rate)")
    clock, clock_from = sm_clock_hz()
    log(f"    SM clock for the Philox floor: {clock / 1e6:.0f} MHz "
        f"({clock_from})")
    g = torch.Generator(device=DEV).manual_seed(0)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for shape, dtype in ELU_DROPOUT_SHAPES:
        x = torch.randn(shape, generator=g, device=DEV).to(dtype)
        ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
        for rate in ELU_DROPOUT_RATES:
            seed = elu_dropout.draw_seed(DEV, g)
            y = elu_dropout.elu_dropout_forward(x, seed, rate)
            dx = elu_dropout.elu_dropout_backward(x, ct, seed, rate)
            torch.cuda.synchronize()
            y_ref = elu_dropout.elu_dropout_plain(x, seed, rate)
            dx_ref = elu_dropout.elu_dropout_backward_plain(x, ct, seed,
                                                            rate)
            thresh, _ = elu_dropout.keep_params(rate)
            keep = (elu_dropout.dropout_bits(seed, x.numel()) < thresh
                    ).reshape(shape)
            # an element is dropped iff it is 0 where ELU is not 0
            live = F.elu(x.float()) != 0
            mism = int(((y != 0) != keep)[live].sum()
                       + ((y_ref != 0) != keep)[live].sum()
                       + ((dx != 0) != keep)[live & (ct != 0)].sum())
            drop = 1.0 - float(keep.float().mean())
            sigma = (rate * (1 - rate) / x.numel()) ** 0.5
            e_fwd = float((y.float() - y_ref.float()).abs().max())
            e_bwd = float((dx.float() - dx_ref.float()).abs().max())
            ok = (mism == 0 and abs(drop - rate) <= 5 * sigma
                  and ulp_ok(y, y_ref) and ulp_ok(dx, dx_ref)
                  and y.dtype == dtype and dx.dtype == dtype)
            log(f"    {tuple(shape)} {str(dtype)[6:]} rate {rate}: keep "
                f"mismatches {mism}, drop fraction {drop:.6f} "
                f"({(drop - rate) / sigma:+.2f} sigma), max|fwd-plain| "
                f"{e_fwd:.3e}, max|bwd-plain| {e_bwd:.3e} "
                f"({'ok' if ok else 'FAIL'})")
            RESULTS.setdefault("elu_dropout_vs_plain", []).append(dict(
                shape=list(shape), dtype=str(dtype), rate=rate,
                keep_mismatches=mism, drop_fraction=drop,
                max_abs_err_fwd=e_fwd, max_abs_err_bwd=e_bwd))
            check(ok, f"ELU+dropout kernels disagree with their plain "
                  f"versions at {tuple(shape)} {dtype} rate {rate}")
            errs["fwd"] = max(errs["fwd"], e_fwd)
            errs["bwd"] = max(errs["bwd"], e_bwd)
    elu_dropout_sweeps(g)
    offset_checks(g)
    offset_bit_checks(g)
    # time at the largest dropout site of the training path
    shape, dtype = ELU_DROPOUT_SHAPES[0]
    rate = 0.05
    x = torch.randn(shape, generator=g, device=DEV).to(dtype)
    ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
    seed = elu_dropout.draw_seed(DEV, g)
    xg = x.clone().requires_grad_(True)
    y_lib = F.dropout(F.elu(xg), rate)
    fns = {
        "fwd": (lambda: elu_dropout.elu_dropout_forward(x, seed, rate),
                lambda: elu_dropout.elu_dropout_plain(x, seed, rate),
                lambda: F.dropout(F.elu(x), rate)),
        "bwd": (lambda: elu_dropout.elu_dropout_backward(x, ct, seed, rate),
                lambda: elu_dropout.elu_dropout_backward_plain(x, ct, seed,
                                                               rate),
                lambda: torch.autograd.grad(y_lib, xg, ct,
                                            retain_graph=True)),
    }
    out = {}
    for d, (kernel, plain, library) in fns.items():
        order = [("plain", plain, 5), ("kernel", kernel, 50),
                 ("kernel", kernel, 50), ("plain", plain, 5)]
        times = [(n, cuda_ms(fn, it)) for n, fn, it in order]
        lib_ms = cuda_ms(library, 50)
        ms = float(np.mean([t for n, t in times if n == "kernel"]))
        plain_ms = float(np.mean([t for n, t in times if n == "plain"]))
        bound, bound_by = elu_dropout_bound_ms(x.numel(), dtype, d == "bwd")
        parts = elu_dropout_bound_parts(x.numel(), dtype, d == "bwd")
        log(f"    {d} at {shape} bf16 rate {rate} (plain, kernel, kernel, "
            f"plain): " + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
            + f"; library {lib_ms:.4f} ms; bound {bound:.4f} ms "
            f"({bound_by}: bytes {parts['bytes']:.4f}, Philox's integer "
            f"multiplies {parts['philox']:.4f}, f32 {parts['f32']:.4f}); "
            f"{bound / ms:.1%} of the bound reached")
        # the same launch as rank 1 of a 2-rank batch (offset n, a whole
        # number of Philox blocks) and at an offset inside a block
        off_ms = {off: cuda_ms(lambda: (
            elu_dropout.elu_dropout_forward(x, seed, rate, off) if d == "fwd"
            else elu_dropout.elu_dropout_backward(x, ct, seed, rate, off)),
            50) for off in (x.numel(), x.numel() + 1)}
        log(f"    {d} with an element offset: n {off_ms[x.numel()]:.4f} ms, "
            f"n + 1 {off_ms[x.numel() + 1]:.4f} ms "
            f"({off_ms[x.numel() + 1] / ms - 1:+.1%} against offset 0)")
        RESULTS[f"elu_dropout_{d}_times_ms"] = dict(
            order=times, library=lib_ms, bound=bound, bound_parts=parts,
            offset_n=off_ms[x.numel()], offset_n_plus_1=off_ms[x.numel() + 1])
        out[d] = dict(max_abs_err=errs[d], ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
    elu_dropout_site_times(g)
    return out


def offset_checks(g):
    """Each half of a batch run by the kernels at its element offset (rank
    r of 2: r * n_local) is bit-equal to the same rows of one launch over
    the whole batch, forward and backward (dropout_impl pallas_sharded),
    and the plain version's slice agrees as in the checks above."""
    for shape, dtype in ((ELU_DROPOUT_SHAPES[0][0], torch.bfloat16),
                         ((6, 33, 17, 5), torch.float32)):
        x = torch.randn(shape, generator=g, device=DEV).to(dtype)
        ct = torch.randn(shape, generator=g, device=DEV).to(dtype)
        seed = elu_dropout.draw_seed(DEV, g)
        rate = 0.3
        full = elu_dropout.elu_dropout_forward(x, seed, rate)
        dfull = elu_dropout.elu_dropout_backward(x, ct, seed, rate)
        rows = shape[0] // 2
        n_local = x[:rows].numel()
        for r in range(2):
            sl = slice(r * rows, (r + 1) * rows)
            part = elu_dropout.elu_dropout_forward(x[sl], seed, rate,
                                                   r * n_local)
            dpart = elu_dropout.elu_dropout_backward(x[sl], ct[sl], seed,
                                                     rate, r * n_local)
            torch.cuda.synchronize()
            ref = elu_dropout.elu_dropout_plain(x[sl], seed, rate,
                                                r * n_local)
            check(torch.equal(part, full[sl]) and torch.equal(dpart,
                                                              dfull[sl]),
                  f"ELU+dropout at offset {r * n_local} is not the slice of "
                  f"the whole launch at {tuple(shape)} {dtype}")
            check(torch.equal(part == 0, ref == 0) and ulp_ok(part, ref),
                  f"ELU+dropout at offset {r * n_local} disagrees with its "
                  f"plain version at {tuple(shape)} {dtype}")
        log(f"    offsets: each half of {tuple(shape)} {str(dtype)[6:]} at "
            f"offset rank * {n_local} bit-equal to the whole launch's rows, "
            f"forward and backward")
        RESULTS.setdefault("elu_dropout_offset_halves", []).append(
            dict(shape=list(shape), dtype=str(dtype), n_local=n_local,
                 bit_equal=True))


def ptxas_report(log_text, kernel):
    """{template argument: (registers, spill store bytes, spill load
    bytes)} of each instantiation of ``kernel`` in an nvcc -Xptxas -v
    log."""
    out, cur, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            a = re.search(kernel + r"IL[a-z](\d+)E", m.group(1))
            cur = int(a.group(1)) if a else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m.group(1)),) + spills
            cur, spills = None, (0, 0)
    return out


def device_ms_per_launch(fn, n, name):
    """Mean device time of the kernels whose name holds ``name`` over n
    calls of fn, from torch.profiler; None where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in events)
    if count == 0:
        return None
    return sum(e.self_device_time_total for e in events) / count / 1e3


def fused_twin(block, C):
    """A VunetRNB under rnb_impl "fused" with block's weights."""
    twin = ops_nn.VunetRNB(C, dtype=torch.bfloat16, rnb_impl="fused",
                           device="meta").to_empty(device=DEV)
    twin.load_state_dict(block.state_dict())
    return twin.eval()


def phase_fused_rnb():
    log("[3] fused RNB kernel vs plain PyTorch (bf16: atol 1e-2, rtol 1e-2)")
    report = ptxas_report(build_log("fused_rnb"), "fused_rnb_kernel")
    for CP in sorted(report):
        plan = fused_rnb.kernel_plan(CP, DEV)
        regs, st, ld = report[CP]
        log(f"    instantiation CP={CP}: {regs} registers, spill stores "
            f"{st} B, spill loads {ld} B; dynamic shared memory "
            f"{plan['smem_bytes']:,} B, {plan['tap_slots']} tap slots, "
            f"{plan['halo_buffers']} halo buffer(s), a warp {plan['warp_rows']}"
            f" rows x {plan['warp_channels']} channels, "
            f"{plan['blocks_per_sm']} block(s) an SM, grid cap "
            f"{plan['grid_cap']}")
        RESULTS.setdefault("fused_rnb_instantiations", {})[CP] = dict(
            registers=regs, spill_stores=st, spill_loads=ld, **plan)
    check(len(report) == 8, f"ptxas reported {sorted(report)}")
    check(not any(st or ld for _, st, ld in report.values()),
          "a fused RNB instantiation spills registers")
    g = torch.Generator(device=DEV).manual_seed(0)
    blocks, err = {}, 0.0

    def block_of(C):
        if C not in blocks:
            blocks[C] = on_device(ops_nn.VunetRNB(
                C, dtype=torch.bfloat16, device="meta"), g)
        return blocks[C]
    for shape in FUSED_RNB_SHAPES:
        block = block_of(shape[-1])
        x = (torch.randn(shape, generator=g, device=DEV) * 0.5).bfloat16()
        with torch.inference_mode():
            out = block._forward_fused(x)
            torch.cuda.synchronize()
            ref = fused_rnb.fused_rnb_plain(x, *block.fused_weights())
        e = float((out.float() - ref.float()).abs().max())
        ok = (out.shape == x.shape and out.dtype == torch.bfloat16
              and torch.allclose(out.float(), ref.float(), atol=1e-2,
                                 rtol=1e-2))
        log(f"    {shape}: max|kernel-plain| {e:.3e} "
            f"({'ok' if ok else 'FAIL'}), max|out| "
            f"{float(out.float().abs().max()):.3f}")
        RESULTS.setdefault("fused_rnb_vs_plain", []).append(
            dict(shape=list(shape), max_abs_err=e))
        check(ok, f"fused RNB kernel disagrees with its plain version at "
              f"{shape}")
        err = max(err, e)
    log("    times at the org request's sites: the kernel on prepared "
        "operands (CUDA events; device time per launch from "
        "torch.profiler), the VunetRNB call under rnb_impl fused (route), "
        "the default VunetRNB eval forward (library: cuDNN conv and eager "
        "ELU, affine, residual)")
    timed, rows = {}, []
    for shape in ORG_RNB_SITES:
        C = shape[-1]
        block = block_of(C)
        twin = fused_twin(block, C)
        x = (torch.randn(shape, generator=g, device=DEV) * 0.5).bfloat16()
        n = 20 if shape[1] >= 64 else 100
        with torch.inference_mode():
            operands = block.fused_operands()

            def kernel():
                return fused_rnb.fused_rnb_prepared(x, operands)

            def plain():
                return fused_rnb.fused_rnb_plain(x, *block.fused_weights())
            out, ref = kernel().float(), plain().float()
            e = float((out - ref).abs().max())
            close = torch.allclose(out, ref, atol=1e-2, rtol=1e-2)
            order = [("plain", plain, 3), ("kernel", kernel, n),
                     ("kernel", kernel, n), ("plain", plain, 3)]
            times = [(name, cuda_ms(fn, it)) for name, fn, it in order]
            route_ms = cuda_ms(lambda: twin(x), n)
            lib_ms = cuda_ms(lambda: block(x), n)
            dev_ms = device_ms_per_launch(kernel, n, "fused_rnb_kernel")
        ms = float(np.mean([t for name, t in times if name == "kernel"]))
        plain_ms = float(np.mean([t for name, t in times
                                  if name == "plain"]))
        bound, bound_by = fused_rnb_bound_ms(*shape)
        launches = ORG_RNB_SITES[shape]
        kernel_ms = dev_ms if dev_ms is not None else ms
        log(f"    {shape}: (plain, kernel, kernel, plain) "
            + ", ".join(f"{name} {t:.4f}" for name, t in times)
            + " ms; device "
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
            + f"; route {route_ms:.4f} ms; library {lib_ms:.4f} ms; bound "
            f"{bound:.4f} ms ({bound_by}), kernel at {bound / kernel_ms:.1%}"
            f" of it; {lib_ms / kernel_ms:.2f}x the library; "
            f"{launches} launches an org request; max|kernel-plain| "
            f"{e:.3e}")
        check(close, f"fused RNB kernel disagrees with its plain version "
              f"at {shape}")
        rows.append(dict(shape=list(shape), order=times, ms=ms,
                         device_ms=dev_ms, route_ms=route_ms, library=lib_ms,
                         bound=bound, bound_by=bound_by, launches=launches,
                         max_abs_err=e))
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound, bound_by=bound_by)
    total = {k: sum(r["launches"] * v for r, v in zip(rows, vals))
             for k, vals in (
                 ("kernel", [r["device_ms"] if r["device_ms"] is not None
                             else r["ms"] for r in rows]),
                 ("route", [r["route_ms"] for r in rows]),
                 ("library", [r["library"] for r in rows]),
                 ("bound", [r["bound"] for r in rows]))}
    log(f"    an org B=20, T=50 request ({ORG_RNB_LAUNCHES} launches): "
        f"sum of launches x kernel {total['kernel']:.3f} ms, x route "
        f"{total['route']:.3f} ms, x library {total['library']:.3f} ms, "
        f"x bound {total['bound']:.3f} ms (kernel at "
        f"{total['bound'] / total['kernel']:.1%} of its bound)")
    RESULTS["fused_rnb_sites"] = rows
    RESULTS["fused_rnb_org_request_ms"] = total
    # the kernels line carries the largest site, 256 px at C=32
    return dict(max_abs_err=err, **timed[CHUNK_RNB_SITES[0]])


def phase_conv_epilogue():
    log("[3] conv epilogue kernel vs its plain version (bf16: bit-equal)")
    log("    " + "; ".join(line.strip() for line in
                           build_log("conv_epilogue").splitlines()
                           if "registers" in line))
    g = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for shape in EPILOGUE_SITES:
        for with_residual in (False, True):
            y = torch.randn(shape, generator=g, device=DEV).bfloat16()
            b = torch.randn(shape[-1], generator=g, device=DEV)
            r = (torch.randn(shape, generator=g, device=DEV).bfloat16()
                 if with_residual else None)
            ref = conv_epilogue.conv_epilogue_plain(y, b, r)
            out = conv_epilogue.conv_epilogue(y.clone(), b, r)
            equal = bool(torch.equal(out, ref))
            e = float((out.float() - ref.float()).abs().max())
            del out, ref
            b16 = b.bfloat16()
            gamma, beta = torch.ones_like(b16), torch.zeros_like(b16)

            def library():
                """The unfolded route's passes on y: the conv's bias
                add_ on its NCHW view, gamma *, + beta, the residual."""
                y.permute(0, 3, 1, 2).add_(b16.reshape(1, -1, 1, 1))
                out = gamma * y + beta
                return out if r is None else r + out
            n = 20 if shape[1] >= 64 else 200
            ms = cuda_ms(lambda: conv_epilogue.conv_epilogue(y, b, r), n)
            plain_ms = cuda_ms(
                lambda: conv_epilogue.conv_epilogue_plain(y, b, r), n)
            lib_ms = cuda_ms(library, n)
            bound = (y.numel() * y.element_size() * (3 if r is not None
                                                     else 2)
                     + b.numel() * 4) / HBM_BYTES_PER_S * 1e3
            log(f"    {shape} residual {with_residual}: kernel {ms:.4f} ms,"
                f" bound {bound:.4f} ms (bytes), kernel at "
                f"{bound / ms:.1%} of it; plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms; bit-equal to plain: {equal}")
            check(equal, f"conv epilogue differs from its plain version at "
                  f"{shape}, residual {with_residual}: max abs {e:.3e}")
            rows.append(dict(shape=list(shape), residual=with_residual,
                             max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by="bytes"))
            del y, r
    strided = torch.zeros(8, 16, 16, 32, device=DEV,
                          dtype=torch.bfloat16).transpose(1, 2)
    try:
        conv_epilogue.conv_epilogue(strided, torch.zeros(32, device=DEV))
        refused = False
    except ValueError:
        refused = True
    check(refused, "conv epilogue took a strided output")
    log("    a strided output is refused")
    RESULTS["conv_epilogue_sites"] = rows
    RESULTS["conv_epilogue_act_sites"] = conv_epilogue_act_sites(g)
    torch.cuda.empty_cache()
    # the kernels line carries the largest site, 256 px at C=32, without
    # a residual
    return {k: rows[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}


def conv_epilogue_act_sites(g):
    """The activated store at the residual blocks' sites of a 125-frame
    chunk (C of a 2C conv input): ELU(x) into the lower half (no bias),
    the nin conv's ELU(y + b') into the upper half, and with a residual;
    bit-equal to its plain version, timed beside its byte bound, the plain
    version and the passes the route no longer runs (the in-place epilogue
    where there is a bias, F.elu, and the half of torch.cat that copied
    it into the conv's input)."""
    log("[3] conv epilogue's activated store into a 2C conv input vs its "
        "plain version (bf16: bit-equal)")
    rows = []
    for shape in EPILOGUE_SITES[:4]:
        C = shape[-1]
        buf = torch.empty(shape[:-1] + (2 * C,), device=DEV,
                          dtype=torch.bfloat16)
        for mode in ("x", "nin", "residual"):
            y = torch.randn(shape, generator=g, device=DEV).bfloat16()
            b = (None if mode == "x"
                 else torch.randn(C, generator=g, device=DEV))
            r = (torch.randn(shape, generator=g, device=DEV).bfloat16()
                 if mode == "residual" else None)
            out = buf[..., :C] if mode == "x" else buf[..., C:]
            ref = conv_epilogue.conv_epilogue_act_plain(y, b, r)
            conv_epilogue.conv_epilogue_act(y, out, b, r)
            equal = bool(torch.equal(out, ref))
            e = float((out.float() - ref.float()).abs().max())
            del ref
            y_lib = y.clone()

            def library():
                """The concatenating route's passes after the conv: the
                in-place epilogue (with a bias), F.elu, the cat's half."""
                v = (y_lib if b is None
                     else conv_epilogue.conv_epilogue(y_lib, b, r))
                out.copy_(F.elu(v))
            n = 20 if shape[1] >= 64 else 200
            ms = cuda_ms(
                lambda: conv_epilogue.conv_epilogue_act(y, out, b, r), n)
            plain_ms = cuda_ms(
                lambda: conv_epilogue.conv_epilogue_act_plain(y, b, r), n)
            lib_ms = cuda_ms(library, n)
            bound = (y.numel() * y.element_size() * (3 if r is not None
                                                     else 2)
                     + (0 if b is None else b.numel() * 4)
                     ) / HBM_BYTES_PER_S * 1e3
            log(f"    {shape} into {2 * C} channels, {mode}: kernel "
                f"{ms:.4f} ms, bound {bound:.4f} ms (bytes), kernel at "
                f"{bound / ms:.1%} of it; plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms; bit-equal to plain: {equal}")
            check(equal, f"the activated store differs from its plain "
                  f"version at {shape}, {mode}: max abs {e:.3e}")
            rows.append(dict(shape=list(shape), ldo=2 * C, mode=mode,
                             max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by="bytes"))
            del y, y_lib, r, out
        del buf
    return rows


def stickman_joints(n, S, seed=0):
    """n figure-like frames of 17 joints: a centre in the middle half of
    the image and joints within a quarter of the image of it; the first
    frames carry the edge cases (invalid and NaN joints, a degenerate
    segment, joints past the image and past the kernel's cull limit, a
    body of fewer than 3 valid vertices)."""
    rng = np.random.RandomState(seed)
    j = (rng.rand(n, 1, 2) * 0.5 + 0.25) * S \
        + (rng.rand(n, 17, 2) - 0.5) * 0.5 * S
    j[0, 3] = -1.0
    j[1, 5] = np.nan
    j[2, 1] = j[2, 0]
    j[3, 4] = [1.6 * S, 0.5 * S]
    j[4, 6] = [7e4, 3.0]
    j[5, [0, 3, 8]] = -1.0
    return torch.tensor(j, dtype=torch.float32, device=DEV)


def phase_stickman():
    N, S, thick = STICK["frames"], STICK["S"], STICK["thickness"]
    log(f"[3] stickman raster kernel vs its eager version on the card "
        f"({N} frames, {S} px, thickness {thick}: bit-equal)")
    log("    " + "; ".join(line.strip() for line in
                           build_log("stickman").splitlines()
                           if "registers" in line))
    jm = detailed_joint_model(world_coords=True)
    joints = stickman_joints(N, S)
    rows = []
    for normalized in (False, True):
        def kernel():
            return render_stickman(joints, jm, S, thick,
                                   normalized=normalized)

        def eager():
            return render_stickman_plain(joints, jm, S, thick,
                                         normalized=normalized)
        ref = eager()
        before = stickman.stickman_launches
        out = kernel()
        check(stickman.stickman_launches == before + 1,
              "render_stickman on the card launched the kernel "
              f"{stickman.stickman_launches - before} times")
        differ = int((out != ref).any(-1).sum())
        check(out.dtype == ref.dtype and torch.equal(out, ref),
              f"the stickman kernel differs from the eager version "
              f"(normalized {normalized}) at {differ} pixels")
        err = float((out.float() - ref.float()).abs().max())
        ms = cuda_ms(kernel, 20)
        eager_ms = cuda_ms(eager, 3)
        # the function's own traffic: the joints read and the image written
        # once; its arithmetic (a distance field over the pixels a thick
        # segment covers) is far below this at the H100's f32 rate
        nbytes = out.numel() * out.element_size() + joints.numel() * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        del out, ref
        t0 = time.perf_counter()
        render_stickman_plain(joints.cpu(), jm, S, thick,
                              normalized=normalized)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        log(f"    {'bf16 normalized' if normalized else 'f32 0..255'}: "
            f"kernel {ms:.4f} ms, byte bound {bound:.4f} ms, kernel at "
            f"{bound / ms:.1%} of it; eager on the card {eager_ms:.2f} ms, "
            f"plain on the CPU ({torch.get_num_threads()} threads) "
            f"{cpu_ms:.0f} ms; bit-equal to the eager version")
        rows.append(dict(normalized=normalized, max_abs_err=err, ms=ms,
                         plain_ms=eager_ms, plain_cpu_ms=cpu_ms,
                         bound_ms=bound, bound_by="bytes", library_ms=None))
    RESULTS["stickman"] = dict(rows=rows)
    torch.cuda.empty_cache()
    # the kernels line carries the served output, normalized bf16
    return {k: rows[1][k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "plain_cpu_ms", "bound_ms", "bound_by",
                                    "library_ms")}


# -- 4. the full-width slice --------------------------------------------------
def serving_vunet(variant, **kw):
    """The serving VUNet on the meta device: bench.py's alter VUNet, or
    configs/vunet.yaml's org VUNet (30-channel part stack, box_factor 2)."""
    if variant == "org":
        return vunet_from_config(load_config(ORG_CONFIG), "org",
                                 dtype=torch.bfloat16, device="meta", **kw)
    return VUNet(spatial_size=SLICE["S"], nf_start=SLICE["NF_START"],
                 nf_max=SLICE["NF_MAX"], dtype=torch.bfloat16,
                 device="meta", **kw)


def vunet_frames(pipe, vunet, app_img, stick):
    """The frames ``vunet`` makes of ``stick`` (B*T stickmen) with the
    posterior means of ``app_img`` (drawn as ``serve`` draws them), in the
    pipeline's chunks."""
    n = stick.shape[0]
    length = n // app_img.shape[0]
    g = torch.Generator(device=DEV).manual_seed(1)
    with torch.inference_mode():
        means, _ = vunet.encode_means(app_img, generator=g)
        tiled = [torch.repeat_interleave(m, length, 0) for m in means]
        cs, _ = pipe._chunk_size(n)
        return torch.cat([vunet.transfer_cached(
            [m[s:s + cs] for m in tiled], stick[s:s + cs])
            for s in range(0, n, cs)])


def served_copy(vunet, variant, **kw):
    """A copy of a serving VUNet, its weights included, built with the
    options ``kw`` (rnb_impl, quant, upsample_transpose, ...)."""
    other = serving_vunet(variant, **kw).to_empty(device=DEV)
    other.load_state_dict(vunet.state_dict())
    return other.eval()


def full_width_slice(variant="alter"):
    HID, K_FULL, K_USE, S = (SLICE[k] for k in ("HID", "K_FULL", "K_USE",
                                                 "S"))
    g = torch.Generator(device=DEV).manual_seed(0)
    behavior = on_device(ResidualBehaviorNet(
        K_USE, HID, dtype=torch.bfloat16, device="meta"), g)
    flow = on_device(LatentFlow(HID, 2 * HID, n_flows=SLICE["N_FLOWS"],
                                device="meta"), g)
    vunet = on_device(serving_vunet(variant), g)
    rng = np.random.RandomState(0)
    mean = rng.randn(K_FULL).astype(np.float32)
    std = (np.abs(rng.rand(K_FULL)) + 0.5).astype(np.float32)
    dim_to_use = np.arange(K_FULL)[np.arange(K_FULL) % 17 != 0][:K_USE]
    pipe = BehaviorTransferPipeline(
        behavior, vunet, detailed_joint_model(world_coords=True), mean, std,
        dim_to_use, spatial_size=S, flow_model=flow)
    counts = {n: sum(p.numel() for p in m.parameters())
              for n, m in (("behavior", behavior), ("flow", flow),
                           ("vunet", vunet))}
    return pipe, g, counts


def request_inputs(B, g, app_shape=None):
    """A request of B videos; the appearance is (B,) + app_shape, by
    default an RGB image at the slice's size."""
    HID, K, S = SLICE["HID"], SLICE["K_USE"], SLICE["S"]
    app_shape = app_shape or (S, S, 3)
    extr = torch.tensor(np.hstack([np.eye(3), [[0], [0], [4.0]]]),
                        dtype=torch.float32, device=DEV).expand(B, 3, 4)
    intr = torch.tensor([1145.0, 500.0, 1143.0, 500.0],
                        device=DEV).expand(B, 4)
    return dict(
        z=torch.randn(B, HID, generator=g, device=DEV),
        x_start=torch.zeros(B, K, device=DEV),
        app_img=torch.rand((B,) + tuple(app_shape), generator=g,
                           device=DEV) * 2 - 1,
        extrinsics=extr, intrinsics=intr,
        image_size=torch.full((B, 2), 1000.0, device=DEV))


def phase_slice():
    pipe, g, counts = full_width_slice()
    log(f"[4] full-width slice: parameters {counts}; "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    RESULTS["slice_params"] = counts
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    reqs = [("generate", B, T, "warm-up"), ("generate", B, T, "timed"),
            ("generate", B, T, "timed"), ("reenact", 4, T, ""),
            ("generate", 3, T, f"n={3 * T}"),
            ("generate", 3, 43, "n=129: zero-padded to two chunks of 128")]
    inputs = {b: request_inputs(b, g) for b in (B, 4, 3)}
    source = torch.randn(4, T, SLICE["K_USE"], generator=g,
                         device=DEV) * 0.3
    times = []
    rollout.rollout_launches = 0          # counts start here: the main path
    stickman.stickman_launches = 0
    calls = [0, 0]

    def count_call(module, args):
        calls[0] += 1

    def count_aux_call(module, args):
        calls[1] += len(args) > 1 and args[1] is not None
    for i, (kind, b, length, note) in enumerate(reqs):
        x = inputs[b]
        before = rollout.rollout_launches
        if i == 0:      # the warm-up: one conv epilogue a NormConv2d call,
            # two activated stores a residual block call with aux input
            hooks = [m.register_forward_pre_hook(count_call)
                     for m in pipe.vunet.modules()
                     if isinstance(m, ops_nn.NormConv2d)]
            hooks += [m.register_forward_pre_hook(count_aux_call)
                      for m in pipe.vunet.modules()
                      if isinstance(m, ops_nn.VunetRNB)]
            conv_epilogue.conv_epilogue_launches = 0
            conv_epilogue.conv_epilogue_act_launches = 0
        if i == 1:
            builds = sum(ops_nn.prepared_builds.values())
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "generate":
            out = pipe.generate(x["z"], x["x_start"], x["app_img"],
                                x["extrinsics"], x["intrinsics"],
                                x["image_size"], length=length, generator=g)
        else:
            out = pipe.reenact(source, x["x_start"], x["app_img"],
                               x["extrinsics"], x["intrinsics"],
                               x["image_size"], length=length, generator=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            epilogue_launches = conv_epilogue.conv_epilogue_launches
            for h in hooks:
                h.remove()
            check(epilogue_launches == calls[0] > 0,
                  f"the B={b} request launched the conv epilogue "
                  f"{epilogue_launches} times in {calls[0]} NormConv2d "
                  f"calls")
            log(f"    the B={b} warm-up: {epilogue_launches} conv epilogue "
                f"launches, one a NormConv2d call")
            act_launches = conv_epilogue.conv_epilogue_act_launches
            check(act_launches == 2 * calls[1] > 0,
                  f"the B={b} request made {act_launches} activated stores "
                  f"in {calls[1]} residual block calls with aux input")
            log(f"    the B={b} warm-up: {act_launches} activated stores, "
                f"two in each of {calls[1]} residual block calls with aux "
                f"input")
            RESULTS["slice_conv_epilogue_act_launches"] = act_launches
        if i == 2:
            eager = render_stickman_plain(
                out["keypoints_2d"], pipe.joint_model, S, pipe.thickness,
                normalized=True)
            check(torch.equal(out["stickman"], eager),
                  "the served stickman differs from the eager raster's")
            del eager
            built = sum(ops_nn.prepared_builds.values()) - builds
            check(built == 0, f"the timed requests built {built} prepared "
                  f"kernel weights")
        peak = torch.cuda.max_memory_allocated()
        frames = out["frames"]
        check(frames.shape == (b, length, S, S, 3),
              f"{kind} frames shape {tuple(frames.shape)}")
        check(bool(torch.isfinite(frames.float()).all())
              and bool(torch.isfinite(out["stickman"].float()).all())
              and bool(torch.isfinite(out["poses_3d"]).all()),
              f"{kind} B={b}: non-finite output")
        check(rollout.rollout_launches == before + 1,
              f"{kind} B={b} launched the rollout kernel "
              f"{rollout.rollout_launches - before} times")
        check(stickman.stickman_launches == i + 1,
              f"{kind} B={b} left {stickman.stickman_launches} stickman "
              f"raster launches after {i + 1} requests")
        fps = b * length / dt
        log(f"    {kind:8s} B={b:2d} T={length}: {dt * 1e3:9.2f} ms, "
            f"{fps:8.1f} frames/s, peak {peak / 2**30:.2f} GiB  {note}")
        times.append(dict(kind=kind, B=b, T=length, ms=dt * 1e3, fps=fps,
                          peak_gib=peak / 2**30, note=note))
    launches = rollout.rollout_launches
    check(launches == len(reqs), f"rollout launches {launches}")
    raster_launches = stickman.stickman_launches
    log(f"    {raster_launches} stickman raster launches in {len(reqs)} "
        f"requests, one a request")
    RESULTS["slice_requests"] = times
    RESULTS["slice_conv_epilogue_launches"] = epilogue_launches
    RESULTS["slice_stickman_launches"] = raster_launches
    stage_breakdown(pipe, inputs[B], g, "slice_stages_ms")
    concat_free_request(pipe, inputs[B])
    alter_fused_request(pipe, inputs[B])
    return launches, epilogue_launches, raster_launches


def serve(pipe, x, seed=1):
    """One generate request, its posterior noise drawn from a generator
    seeded with ``seed`` (so that two calls make the same request):
    (outputs, host ms, peak device bytes)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.generate(x["z"], x["x_start"], x["app_img"], x["extrinsics"],
                        x["intrinsics"], x["image_size"],
                        length=SLICE["T"], generator=g)
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated())


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def alter_fused_request(pipe, x):
    """One B=20 alter request under rnb_impl "fused" beside the same
    request under the default route."""
    B, T = SLICE["B"], SLICE["T"]
    cudnn_vunet = pipe.vunet
    ref, _, _ = serve(pipe, x)
    pipe.vunet = served_copy(cudnn_vunet, "alter", rnb_impl="fused")
    try:
        fused_rnb.fused_rnb_launches = 0    # counts start here: the alter
        out, ms, peak = serve(pipe, x)      # fused route
        launches = fused_rnb.fused_rnb_launches
    finally:
        pipe.vunet = cudnn_vunet
    frames = out["frames"]
    check(frames.shape == ref["frames"].shape
          and bool(torch.isfinite(frames.float()).all()),
          "alter fused request: frames")
    check(launches == ALTER_RNB_LAUNCHES,
          f"the alter B={B} request launched the fused RNB kernel "
          f"{launches} times, not {ALTER_RNB_LAUNCHES}")
    rel = rel_l2(frames, ref["frames"])
    log(f"    generate B={B} T={T} rnb_impl=fused: {ms:9.2f} ms, "
        f"{B * T * 1e3 / ms:8.1f} frames/s, peak {peak / 2**30:.2f} GiB; "
        f"{launches} fused RNB launches; rel-L2 to the cudnn route "
        f"{rel:.3e} (reported)")
    RESULTS["slice_alter_fused"] = dict(ms=ms, fps=B * T * 1e3 / ms,
                                        peak_gib=peak / 2**30,
                                        launches=launches, rel_l2_cudnn=rel)


def concat_free_request(pipe, x):
    """One B=20 request with every residual block with aux input on the
    concatenation-free route beside the same request on the concatenating
    route (``VunetRNB._concat_free`` patched off): bit-equal frames; three
    of each in turn, host ms."""
    route = ops_nn.VunetRNB._concat_free
    ms = {"concat_free": [], "concatenating": []}
    frames = {}
    try:
        for _ in range(3):
            for name in ms:
                if name == "concatenating":
                    ops_nn.VunetRNB._concat_free = (
                        lambda self, x, a, train: False)
                out, t, _ = serve(pipe, x)
                ops_nn.VunetRNB._concat_free = route
                ms[name].append(t)
                frames[name] = out["frames"]
    finally:
        ops_nn.VunetRNB._concat_free = route
    same = bool(torch.equal(frames["concat_free"], frames["concatenating"]))
    check(same, "the concatenation-free route's frames differ from the "
          "concatenating route's")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"    generate B={SLICE['B']} T={SLICE['T']}: concatenation-free "
        f"{med['concat_free']:.2f} ms, concatenating "
        f"{med['concatenating']:.2f} ms (host medians of 3, in turns); "
        f"frames bit-equal: {same}")
    RESULTS["slice_concat_free"] = dict(ms=ms, median_ms=med,
                                        bit_equal=same)


def stage_breakdown(pipe, x, g, key):
    """Host-clock time of each stage of one full-batch request, kept in
    RESULTS[key]; returns a closure that runs its transfer_cached stage
    again on the same inputs."""
    B, length, S = SLICE["B"], SLICE["T"], SLICE["S"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        b, t_flow = timed(lambda: pipe.flow_model.reverse(x["z"]))
        xs, t_roll = timed(lambda: decoder_rollout_kernel(
            pipe.behavior_model.decoder, b, x["x_start"], length))
        world = pipe._unnormalize(xs).reshape(B, length, -1, 3)
        px, t_proj = timed(lambda: pipe._project(
            world, x["extrinsics"], x["intrinsics"], x["image_size"]))
        stick, t_raster = timed(lambda: render_stickman(
            px, pipe.joint_model, S, pipe.thickness, normalized=True))
        flat = stick.reshape((B * length,) + stick.shape[2:])
        means, t_enc = timed(lambda: pipe.vunet.encode_means(
            x["app_img"], generator=g)[0])
        tiled = [torch.repeat_interleave(m, length, 0) for m in means]
        cs, _ = pipe._chunk_size(B * length)

    def vunet_stage():
        with torch.inference_mode():
            for s in range(0, B * length, cs):
                pipe.vunet.transfer_cached([m[s:s + cs] for m in tiled],
                                           flat[s:s + cs])
    _, t_vunet = timed(vunet_stage)
    stages = dict(flow_reverse=t_flow, rollout_kernel=t_roll,
                  camera=t_proj, stickman_raster=t_raster,
                  vunet_encode_means=t_enc, vunet_transfer_cached=t_vunet)
    log(f"    stages of one B={B} request (ms, host clock, synchronized): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    RESULTS[key] = stages
    return vunet_stage


# -- 5. the CLI ---------------------------------------------------------------
def phase_cli():
    rng = np.random.RandomState(0)
    K, HID, S = 48, 64, 64
    net = init_random_(ResidualBehaviorNet(K, HID), rng)
    flow = init_random_(LatentFlow(HID, 2 * HID, n_flows=3), rng)
    vunet = init_random_(VUNet(spatial_size=S, nf_start=8, nf_max=16), rng)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    convert.save_flax_npz(os.path.join(tmp, "behavior.npz"), {
        "net": convert.behavior_net_to_flax(net.state_dict()),
        "flow": convert.latent_flow_to_flax(flow.state_dict())})
    convert.save_flax_npz(os.path.join(tmp, "synth.npz"), {
        "vunet": convert.vunet_alter_to_flax(vunet.state_dict())})
    with open(os.path.join(tmp, "behavior.json"), "w") as f:
        json.dump({"architecture": {"dim_hidden_b": HID, "n_flows": 3}}, f)
    with open(os.path.join(tmp, "synth.json"), "w") as f:
        json.dump({"data": {"spatial_size": S}, "architecture": {
            "nf_start": 8, "nf_max": 16}}, f)
    req = os.path.join(tmp, "request.npz")
    np.savez(req, x_start=(rng.randn(2, K) * 0.1).astype(np.float32),
             source=(rng.randn(2, 8, K) * 0.1).astype(np.float32))
    for mode in ("sample", "transfer"):
        out = os.path.join(tmp, mode)
        man = cli.main(["--behavior_params", os.path.join(tmp, "behavior.npz"),
                        "--synth_params", os.path.join(tmp, "synth.npz"),
                        "--request", req, "--mode", mode, "--length", "8",
                        "--out", out, "--device", "cuda"])
        check(os.path.exists(os.path.join(out, "manifest.json")),
              f"CLI {mode}: no manifest")
        check(len(man["videos"]) == 2 and all(
            os.path.getsize(p) > 0 for p in man["videos"].values()),
            f"CLI {mode}: videos {man['videos']}")
        log(f"[5] CLI {mode}: {len(man['videos'])} videos "
            f"({man['video_format']}) on {man['device']}")
    # an org synthesis run (experiment "vunet": a 30-channel part stack at
    # S/4 = 16 px, box_factor 2) through the fused RNB kernel
    org = init_random_(VUNet(spatial_size=S, n_channels_x=30, nf_start=8,
                             nf_max=16, box_factor=2, variant="org"), rng)
    convert.save_flax_npz(os.path.join(tmp, "synth_org.npz"), {
        "vunet": convert.vunet_org_to_flax(org.state_dict())})
    with open(os.path.join(tmp, "synth_org.json"), "w") as f:
        json.dump({"data": {"spatial_size": S, "inplane_normalize": True,
                            "box_factor": 2},
                   "architecture": {"nf_start": 8, "nf_max": 16},
                   "general": {"experiment": "vunet"}}, f)
    req_org = os.path.join(tmp, "request_org.npz")
    np.savez(req_org, x_start=(rng.randn(2, K) * 0.1).astype(np.float32),
             app_img=(rng.rand(2, S // 4, S // 4, 30) * 2 - 1).astype(
                 np.float32))
    out = os.path.join(tmp, "org")
    before = fused_rnb.fused_rnb_launches
    man = cli.main(["--behavior_params", os.path.join(tmp, "behavior.npz"),
                    "--synth_params", os.path.join(tmp, "synth_org.npz"),
                    "--request", req_org, "--length", "8", "--out", out,
                    "--rnb_impl", "fused", "--device", "cuda"])
    # eu: 3 scales on the 16x16 part stack; du: 5 scales, one chunk
    launches = fused_rnb.fused_rnb_launches - before
    check((man["variant"], man["rnb_impl"]) == ("org", "fused")
          and len(man["videos"]) == 2 and all(
              os.path.getsize(p) > 0 for p in man["videos"].values()),
          f"CLI org: manifest {man}")
    check(launches == 2 * 3 + 2 * 5,
          f"CLI org: {launches} fused RNB launches")
    log(f"[5] CLI sample, org synthesis run, --rnb_impl fused: "
        f"{len(man['videos'])} videos on {man['device']}, {launches} fused "
        f"RNB launches")


# -- 6. against the JAX package's golden ---------------------------------------
def phase_golden():
    # the slice of tests/torch_port_slice.py
    S, HID, T, NF_START, NF_MAX, FLOW_MID, N_FLOWS = 32, 32, 6, 8, 16, 64, 2
    with np.load(GOLDEN) as data:
        g = convert.unflatten_tree({k: data[k] for k in data.files})
    # the weights are stored as float16, which holds them exactly
    params = {k: convert.unflatten_tree({
        n: v.astype(np.float32) if v.dtype == np.float16 else v
        for n, v in convert.flatten_tree(tree).items()})
        for k, tree in g["params"].items()}
    inputs = g["inputs"]
    eps = [torch.from_numpy(g["noise"][str(i)]).to(DEV)
           for i in range(len(g["noise"]))]
    behavior = ResidualBehaviorNet(inputs["x_start"].shape[1], HID,
                                   device=DEV).eval()
    behavior.load_state_dict(convert.behavior_net_from_flax(
        params["behavior"]))
    vunet = VUNet(spatial_size=S, nf_start=NF_START, nf_max=NF_MAX,
                  device=DEV).eval()
    vunet.load_state_dict(convert.vunet_alter_from_flax(params["vunet"]))
    flow = LatentFlow(HID, FLOW_MID, n_flows=N_FLOWS, device=DEV).eval()
    flow.load_state_dict(convert.latent_flow_from_flax(params["flow"]))

    def pipeline(use_kernel):
        return BehaviorTransferPipeline(
            behavior, vunet, detailed_joint_model(world_coords=True),
            inputs["norm_mean"], inputs["norm_std"], inputs["dim_to_use"],
            spatial_size=S, flow_model=flow, use_rollout_kernel=use_kernel)

    cam = (inputs["app_img"], inputs["extrinsics"], inputs["intrinsics"],
           inputs["image_size"])
    plain = pipeline(False)
    for name, out in (
            ("generate", plain.generate(inputs["z"], inputs["x_start"], *cam,
                                        length=T, eps=eps)),
            ("reenact", plain.reenact(inputs["x_source"], inputs["x_start"],
                                      *cam, length=T, eps=eps))):
        ref = g[name]
        d_pose = float(np.abs(out["poses_3d"].cpu().numpy()
                              - ref["poses_3d"]).max())
        d_px = float(np.abs(out["keypoints_2d"].cpu().numpy()
                            - ref["keypoints_2d"]).max())
        stick = out["stickman"].float().cpu().numpy()
        mism = float(np.mean(np.any(stick != ref["stickman"], axis=-1)))
        with torch.inference_mode():
            means, _ = vunet.encode_means(
                torch.from_numpy(inputs["app_img"]).to(DEV), eps)
            on_ref_stick = vunet.transfer_cached(
                [torch.repeat_interleave(m, T, 0) for m in means],
                torch.from_numpy(ref["stickman"].reshape(
                    (-1, S, S, 3))).to(DEV))
        frames_ref = ref["frames"]
        d_vunet = float(np.abs(on_ref_stick.cpu().numpy().reshape(
            frames_ref.shape) - frames_ref).max())
        tol_vunet = 1e-4 * (1 + float(np.abs(frames_ref).max()))
        d_frames = float(np.mean(np.abs(out["frames"].cpu().numpy()
                                        - frames_ref)))
        log(f"[6] golden {name}: poses {d_pose:.2e} (<=1e-4), keypoints "
            f"{d_px:.2e} px (<=1e-2), stickman mismatch {mism:.2e} "
            f"(<=1e-3), VUNet on golden stickman {d_vunet:.2e} "
            f"(<={tol_vunet:.2e}), frames mean abs {d_frames:.2e} (<=1e-3)")
        RESULTS[f"golden_{name}"] = dict(
            poses=d_pose, keypoints=d_px, stickman_mismatch=mism,
            vunet=d_vunet, vunet_tol=tol_vunet, frames_mean_abs=d_frames)
        check(d_pose <= 1e-4 and d_px <= 1e-2 and mism <= 1e-3
              and d_vunet <= tol_vunet and d_frames <= 1e-3,
              f"golden {name} out of tolerance")
    with torch.inference_mode():
        b = flow.reverse(torch.from_numpy(inputs["z"]).to(DEV))
        xs = decoder_rollout_kernel(
            behavior.decoder, torch.from_numpy(g["rollout"]["b"]).to(DEV),
            torch.from_numpy(inputs["x_start"]).to(DEV), T)
    d_b = float(np.abs(b.cpu().numpy() - g["rollout"]["b"]).max())
    xs_ref = torch.from_numpy(g["rollout"]["xs"])
    d_xs = float((xs.cpu() - xs_ref).abs().max())
    ok_xs = torch.allclose(xs.cpu(), xs_ref, atol=5e-2, rtol=1e-2)
    log(f"[6] golden flow reverse {d_b:.2e}; rollout kernel vs JAX f32 scan "
        f"{d_xs:.2e} (atol 5e-2, rtol 1e-2: {ok_xs})")
    RESULTS["golden_rollout"] = dict(flow_reverse=d_b, kernel_vs_scan=d_xs)
    check(d_b <= 1e-4 * (1 + float(np.abs(g["rollout"]["b"]).max()))
          and ok_xs, "golden flow/rollout out of tolerance")


def phase_org_golden():
    """The small org VUNet (tests/make_torch_port_org_golden.py) in f32:
    posterior means, transfer_cached and test_forward against the JAX
    package's, each within 1e-4 * (1 + max|ref|)."""
    with np.load(ORG_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    arch = json.loads(bytes(g["config"]).decode())
    vunet = VUNet(**arch, device=DEV).eval()
    vunet.load_state_dict(convert.vunet_org_from_flax(
        unflatten_tree({k: v.astype(np.float32) for k, v in
                        flatten_tree(g["params"]["vunet"]).items()})))

    def dev(a):
        return torch.from_numpy(a).to(DEV)
    noise = g["noise"]
    post = [dev(noise["posterior"][str(i)]) for i in range(2)]
    prior = [[dev(noise["prior"][str(i)][str(l)]) for l in range(4)]
             for i in range(2)]
    c = dev(g["inputs"]["c"])
    with torch.inference_mode():
        means, _ = vunet.encode_means(dev(g["inputs"]["x"]), post)
        got = {f"means/{i}": m for i, m in enumerate(means)}
        got["transfer_cached"] = vunet.transfer_cached(means, c)
        got["test_forward"] = vunet.test_forward(c, prior)
    ref = flatten_tree(g["outputs"])
    worst = 0.0
    for k, v in got.items():
        err = float(np.abs(v.cpu().numpy() - ref[k]).max())
        worst = max(worst, err / (1e-4 * (1 + float(np.abs(ref[k]).max()))))
    log(f"[6] golden org VUNet (f32, TF32 off): worst error / tolerance "
        f"{worst:.3f} over {sorted(got)}")
    RESULTS["golden_org"] = dict(err_over_tol=worst)
    check(worst <= 1.0, "golden org VUNet out of tolerance")


# -- 7. cvbae training at full width -----------------------------------------
class StepRecorder:
    """Wraps the training step that ``make_cvbae_train_step`` returns:
    each step runs between two ``torch.cuda.synchronize()`` calls and is
    recorded with its metrics, its ELU+dropout launches and the host time
    since the previous step ended (the data pipeline's share)."""

    def __init__(self, make=None, stop_after=None):
        self.steps, self.last, self._end = [], None, None
        self._make = make or make_cvbae_train_step
        self.stop_after, self.args = stop_after, None

    def make(self, *args, **kwargs):
        step = self._make(*args, **kwargs)
        self.args = args

        def recorded(state, batch, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data_ms = (t0 - self._end) * 1e3 if self._end else None
            fwd0 = elu_dropout.elu_dropout_fwd_launches
            bwd0 = elu_dropout.elu_dropout_bwd_launches
            metrics = step(state, batch, **kw)
            torch.cuda.synchronize()
            self._end = time.perf_counter()
            self.steps.append(dict(
                step=state.step, ms=(self._end - t0) * 1e3, data_ms=data_ms,
                fwd_launches=elu_dropout.elu_dropout_fwd_launches - fwd0,
                bwd_launches=elu_dropout.elu_dropout_bwd_launches - bwd0,
                **{k: float(v) for k, v in metrics.items()}))
            self.last = (step, state, batch, kw)
            if self.stop_after and len(self.steps) >= self.stop_after:
                raise StopTraining
            return metrics
        return recorded


class StopTraining(Exception):
    """Raised by a StepRecorder after its ``stop_after`` steps."""


def train_config(base_dir):
    cfg = load_config(TRAIN_CONFIG)
    return deep_merge(cfg, {
        "general": {"base_dir": base_dir, "project_name": "chip_smoke"},
        "training": {"dropout_impl": "pallas",
                     "end_iteration": TRAIN_STEPS}})


def site_shapes(recorder):
    """(numel, dtype) of every forward and every backward launch of one
    training step."""
    step, state, batch, kw = recorder.last
    shapes = {"fwd": [], "bwd": []}
    fwd, bwd = elu_dropout._launch_fwd, elu_dropout._launch_bwd

    def spy_fwd(x, seed, rate, offset=0):
        shapes["fwd"].append((x.numel(), x.dtype))
        return fwd(x, seed, rate, offset)

    def spy_bwd(x, ct, seed, rate, offset=0):
        shapes["bwd"].append((x.numel(), x.dtype))
        return bwd(x, ct, seed, rate, offset)
    elu_dropout._launch_fwd, elu_dropout._launch_bwd = spy_fwd, spy_bwd
    try:
        step(state, batch, **kw)
    finally:
        elu_dropout._launch_fwd, elu_dropout._launch_bwd = fwd, bwd
    return shapes


def per_step_bound_ms(shapes):
    """Bound of a step's ELU+dropout work, launch by launch."""
    return sum(elu_dropout_bound_ms(n, dtype, d == "bwd")[0]
               for d, launches in shapes.items() for n, dtype in launches)


def profile_step(recorder, step_ms):
    """Device busy time and the costliest kernels of one training step
    under torch.profiler; the idle share is taken against the profiled
    step's wall time and against ``step_ms``, the unprofiled median step.
    None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    step, state, batch, kw = recorder.last
    step(state, batch, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves: an operator's entry, or a range annotated on
    # the device's timeline (Optimizer.step), would count kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    elu = {d: [(e.self_device_time_total / 1e3, e.count) for e in events
               if "elu_dropout_kernel" in e.key and f"::{op}," in e.key]
           for d, op in (("fwd", "Fwd"), ("bwd", "Bwd"))}
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                elu_dropout_ms={d: sum(t for t, _ in v)
                                for d, v in elu.items()},
                elu_dropout_launches={d: sum(c for _, c in v)
                                      for d, v in elu.items()},
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                idle_share_unprofiled=max(0.0, 1.0 - busy_ms / step_ms),
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                     for e in top])


def phase_train():
    base = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = train_config(base)
    path = os.path.join(base, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    recorder = StepRecorder()
    made = shape_and_pose_net.make_cvbae_train_step
    shape_and_pose_net.make_cvbae_train_step = recorder.make
    elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
    elu_dropout.elu_dropout_bwd_launches = 0   # main path of training
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(["-c", path, "--device", "cuda"])
    finally:
        shape_and_pose_net.make_cvbae_train_step = made
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (elu_dropout.elu_dropout_fwd_launches,
                elu_dropout.elu_dropout_bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    steps = recorder.steps
    batch = int(cfg["training"]["batch_size"])
    log(f"[7] cvbae training, {TRAIN_STEPS} steps at full width through "
        f"bdvs-train-torch's main: {wall:.1f} s in all; VUNet "
        f"{out['n_params']:,} parameters")
    for r in steps:
        log(f"    step {r['step']}: loss {r['loss']:.6g} (likelihood "
            f"{r['likelihood_loss']:.6g}, kl {r['kl_loss']:.6g}, gamma "
            f"{r['gamma']:.3g}, loss_reg {r['loss_reg']:.4g}, grad_norm "
            f"{r['grad_norm']:.4g}); {r['ms']:.2f} ms; data "
            + ("-" if r["data_ms"] is None else f"{r['data_ms']:.2f}")
            + f" ms; launches fwd {r['fwd_launches']} bwd "
            f"{r['bwd_launches']}")
    accum = int(cfg["training"].get("grad_accum", 1))
    per_step = DROPOUT_SITES * accum
    per_step_bwd = (DROPOUT_SITES - DEAD_BACKWARD_SITES) * accum
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} training steps")
    check(all(np.isfinite(r[k]) for r in steps
              for k in ("loss", "likelihood_loss", "kl_loss", "grad_norm")),
          "a training step's loss is not finite")
    check(all(r["fwd_launches"] == per_step
              and r["bwd_launches"] == per_step_bwd for r in steps),
          f"a training step did not launch the ELU+dropout kernels "
          f"{per_step} (forward) and {per_step_bwd} (backward) times")
    check(launches == (per_step * TRAIN_STEPS, per_step_bwd * TRAIN_STEPS),
          f"ELU+dropout launches {launches}")
    check(steps[-1]["gamma"] >= 0 and any(r["kl_loss"] > 0 for r in steps),
          "the KL term never opened")
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    data_ms = float(np.median([r["data_ms"] for r in steps[1:]]))
    log(f"    median step after the first {step_ms:.2f} ms, "
        f"{batch * 1e3 / step_ms:.1f} img/s; median host data time "
        f"{data_ms:.2f} ms a step; peak memory {peak / 2**30:.2f} GiB")
    shapes = site_shapes(recorder)
    check(len(shapes["fwd"]) == per_step and len(shapes["bwd"])
          == per_step_bwd, f"sites in one step: {shapes}")
    if accum == 1:
        for i, d in enumerate(("fwd", "bwd")):
            want = {int(np.prod(k)): v[i] for k, v in
                    CVBAE_DROPOUT_SITES.items()}
            got = collections.Counter(n for n, _ in shapes[d])
            check(got == want, f"the step's {d} sites {dict(got)} are not "
                  f"CVBAE_DROPOUT_SITES' {want}")
    bound_ms = per_step_bound_ms(shapes)
    elems = sum(n for n, _ in shapes["fwd"])
    prof = profile_step(recorder, step_ms)
    if prof is None:
        log(f"    ELU+dropout per step: {per_step} sites, {elems:,} "
            f"elements, bound {bound_ms:.3f} ms; profiler: no device time "
            f"seen, so kernel time and idle share not measured")
    else:
        log(f"    ELU+dropout per step: {per_step} sites, {elems:,} "
            f"elements; device time (profiler) fwd "
            f"{prof['elu_dropout_ms']['fwd']:.3f} ms in "
            f"{prof['elu_dropout_launches']['fwd']} launches + bwd "
            f"{prof['elu_dropout_ms']['bwd']:.3f} ms in "
            f"{prof['elu_dropout_launches']['bwd']}; bound {bound_ms:.3f} ms")
        log(f"    profiled step: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f} ({prof['idle_share_unprofiled']:.3f} "
            f"of the unprofiled median step); top kernels (ms, calls):")
        for name, ms, count in prof["top"]:
            log(f"      {ms:9.3f} {count:5d}  {name}")
    RESULTS["train"] = dict(
        steps=steps, step_ms_median=step_ms, img_per_s=batch * 1e3 / step_ms,
        data_ms_median=data_ms, peak_gib=peak / 2**30, wall_s=wall,
        launches=list(launches), sites=per_step, site_elements=elems,
        kernel_bound_ms_per_step=bound_ms, profile=prof,
        vunet_params=out["n_params"])
    serve_trained(out["synth_params"])
    return launches, base, path


def serve_trained(synth_params):
    """The run's synth.npz, strictly into a serving VUNet, and one
    transfer_cached call."""
    tree, cfg = cli._load_params(synth_params)
    vunet = vunet_from_config(cfg, "alter", dtype=torch.bfloat16,
                              remat=False, device=DEV).eval()
    vunet.load_state_dict(convert.vunet_alter_from_flax(tree["vunet"]),
                          strict=True)
    S = vunet.spatial_size
    g = torch.Generator(device=DEV).manual_seed(3)
    app = torch.rand(2, S, S, 3, generator=g, device=DEV) * 2 - 1
    stick = torch.rand(2, S, S, 3, generator=g, device=DEV) * 2 - 1
    with torch.inference_mode():
        means, _ = vunet.encode_means(app, generator=g)
        frames = vunet.transfer_cached(means, stick)
    check(frames.shape == (2, S, S, 3)
          and bool(torch.isfinite(frames.float()).all()),
          "the trained synth.npz does not serve")
    log(f"    synth.npz loaded strictly and served: frames "
        f"{tuple(frames.shape)}, mean |frame| "
        f"{float(frames.float().abs().mean()):.4f}")


# -- 8. the training step against the JAX package's golden -------------------
def phase_train_golden():
    with np.load(TRAIN_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    cfg = json.loads(bytes(g["config"]).decode())
    tr, arch = cfg["training"], cfg["architecture"]
    S = int(cfg["data"]["spatial_size"])
    vunet = vunet_from_config(cfg, "alter", device=DEV)
    vunet.load_state_dict(convert.vunet_alter_from_flax(
        g["params"]["vunet"]))
    reg = g["params"]["regressor"]
    n_linear = sum(1 for k in reg if k.startswith("Dense_"))
    regressor = VunetRegressor(
        reg[f"Dense_{n_linear - 1}"]["bias"].shape[0],
        latent_widths(S, n_latent_scales=int(arch["n_latent_scales"])),
        nf_max=int(arch["nf_max"]), n_linear=n_linear, device=DEV)
    regressor.load_state_dict(convert.vunet_regressor_from_flax(reg))
    vunet.train()
    step = make_cvbae_train_step(
        vunet, regressor, LaplacianPyramidFeatures(),
        make_vunet_optimizers(vunet, regressor, tr), cfg)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in g["batch"].items()}
    B, R = batch["pose_img"].shape[0], batch["reg_imgs"].shape[1]
    noise = [torch.from_numpy(g["noise"][str(B)][str(i)]).to(DEV)
             for i in range(len(g["noise"][str(B)]))]
    state = VunetTrainState(gamma=torch.zeros((), device=DEV))
    worst = {}
    for i in sorted(g["metrics"]):
        m = step(state, batch, eps=[noise], reg_eps=[noise] * R)
        for k, ref in g["metrics"][i].items():
            ref = float(ref)
            err = abs(float(m[k]) - ref)
            tol = 1e-4 * abs(ref) + (1e-5 if k == "loss" else 0.0)
            worst[k] = max(worst.get(k, 0.0), err / tol if tol else err)
    after = {"vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
             "regressor": convert.vunet_regressor_to_flax(
                 regressor.state_dict())}
    ref_after = flatten_tree(g["after"])
    d_params = max(float(np.abs(v - ref_after[k]).max())
                   for k, v in flatten_tree(after).items())
    log(f"[8] golden cvbae step x{len(g['metrics'])} (f32, TF32 off): worst "
        f"metric error / tolerance " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; max |param - JAX| after Adam {d_params:.2e} (<= 1e-4)")
    RESULTS["golden_train"] = dict(err_over_tol=worst, params=d_params)
    check(all(v <= 1.0 for k, v in worst.items())
          and d_params <= 1e-4, "golden training step out of tolerance")


# -- 9. org-VUNet serving at full width ---------------------------------------
def phase_org():
    pipe, g, counts = full_width_slice("org")
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    app = (S // 4, S // 4, 30)
    log(f"[9] org-VUNet serving (configs/vunet.yaml, appearance "
        f"{app}): parameters {counts}")
    x = request_inputs(B, g, app)
    vunets = {"cudnn": pipe.vunet,
              "fused": served_copy(pipe.vunet, "org", rnb_impl="fused")}
    frames, launches, rows = {}, None, []
    for impl, vunet in vunets.items():
        pipe.vunet = vunet
        if impl == "fused":
            fused_rnb.fused_rnb_launches = 0   # counts start here: the
        for note in ("warm-up", "timed", "timed"):   # org main path
            before = fused_rnb.fused_rnb_launches
            out, ms, peak = serve(pipe, x)
            n = fused_rnb.fused_rnb_launches - before
            check(out["frames"].shape == (B, T, S, S, 3)
                  and bool(torch.isfinite(out["frames"].float()).all()),
                  f"org {impl} request: frames")
            check(n == (ORG_RNB_LAUNCHES if impl == "fused" else 0),
                  f"the org {impl} request launched the fused RNB kernel "
                  f"{n} times")
            log(f"    generate B={B} T={T} rnb_impl={impl:5s}: {ms:9.2f} ms, "
                f"{B * T * 1e3 / ms:8.1f} frames/s, peak "
                f"{peak / 2**30:.2f} GiB, {n} fused RNB launches  {note}")
            rows.append(dict(rnb_impl=impl, ms=ms, fps=B * T * 1e3 / ms,
                             peak_gib=peak / 2**30, launches=n, note=note))
        if impl == "fused":
            launches = fused_rnb.fused_rnb_launches
        frames[impl] = out["frames"]
    # the same request with the fused blocks' plain version
    launch = ops_nn.VunetRNB._forward_fused
    ops_nn.VunetRNB._forward_fused = (
        lambda self, x: fused_rnb.fused_rnb_plain(x, *self.fused_weights()))
    try:
        plain, _, _ = serve(pipe, x)
    finally:
        ops_nn.VunetRNB._forward_fused = launch
    rel_plain = rel_l2(frames["fused"], plain["frames"])
    rel_cudnn = rel_l2(frames["fused"], frames["cudnn"])
    log(f"    fused route vs its plain version: rel-L2 {rel_plain:.3e} "
        f"(<= 2e-2); vs the cudnn route {rel_cudnn:.3e} (reported)")
    check(rel_plain <= 2e-2, "org fused route disagrees with the plain "
          "version of its blocks")
    RESULTS["org_requests"] = rows
    RESULTS["org_rel_l2"] = dict(fused_vs_plain=rel_plain,
                                 fused_vs_cudnn=rel_cudnn)
    for impl, vunet in vunets.items():
        pipe.vunet = vunet
        stage_breakdown(pipe, x, g, f"org_stages_ms_{impl}")
    # one test_forward chunk: the autoregressive prior runs for real
    cs, _ = pipe._chunk_size(B * T)
    stick = plain["stickman"].reshape((B * T, S, S, 3))[:cs]
    with torch.inference_mode():
        before = fused_rnb.fused_rnb_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample = vunets["fused"].test_forward(stick, generator=g)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = fused_rnb.fused_rnb_launches - before
    check(sample.shape == (cs, S, S, 3)
          and bool(torch.isfinite(sample.float()).all())
          and n == ORG_PRIOR_RNB_LAUNCHES,
          f"org test_forward: shape {tuple(sample.shape)}, {n} launches")
    log(f"    test_forward, {cs} frames, rnb_impl=fused: {ms:.2f} ms, {n} "
        f"fused RNB launches")
    RESULTS["org_test_forward"] = dict(frames=cs, ms=ms, launches=n)
    return launches


# -- 10. behavior_net training at full width ----------------------------------
BEHAVIOR_MAKERS = (("make_behavior_train_step", "cvae"),
                   ("make_flow_train_step", "flow"))


class BehaviorRecorder:
    """Wraps the step makers of an experiment module (by default the cVAE
    and flow steps of ``experiments/behavior_net.py``): each step runs
    between two ``torch.cuda.synchronize()`` calls and is recorded with
    its metrics; the last call of each stage is kept for the profiler."""

    def __init__(self, owner=behavior_net, makers=BEHAVIOR_MAKERS):
        self.owner, self.makers = owner, makers
        self.steps = {stage: [] for _, stage in makers}
        self.last = {}
        self._made = {}

    def install(self):
        for name, stage in self.makers:
            self._made[name] = make = getattr(self.owner, name)
            setattr(self.owner, name, self._wrap(make, stage))

    def uninstall(self):
        for name, make in self._made.items():
            setattr(self.owner, name, make)

    def _wrap(self, make, stage):
        def recorded_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(state, *a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, *a, **kw)
                torch.cuda.synchronize()
                self.steps[stage].append(dict(
                    step=state.step, ms=(time.perf_counter() - t0) * 1e3,
                    **{k: float(v.float().mean())
                       for k, v in metrics.items()}))
                self.last[stage] = (step, state, a, kw)
                return metrics
            return recorded
        return recorded_make


def profile_call(fn, wall_ms_of=None, top_n=5, match=None):
    """Device busy time, idle share and the top kernels of one call of fn
    under torch.profiler (None where it saw no device time); with
    ``match``, the summed device time and launches of the kernels whose
    name holds it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:top_n]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               busy_share=min(1.0, busy_ms / wall_ms),
               launches=sum(e.count for e in events),
               top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                    for e in top])
    if wall_ms_of:
        out["busy_share_unprofiled"] = min(1.0, busy_ms / wall_ms_of)
    if match:
        hits = [e for e in events if match in e.key]
        out["match_ms"] = sum(e.self_device_time_total for e in hits) / 1e3
        out["match_count"] = sum(e.count for e in hits)
    return out


def profile_stages(recorder, median_ms):
    """One more step of each stage, profiled, after the run; the
    recorder's references to the run's state go with it."""
    profiles = {}
    for stage, ms in median_ms.items():
        step, state, a, kw = recorder.last.pop(stage)
        prof = profile_call(lambda: step(state, *a, **kw), ms)
        profiles[stage] = prof
        if prof is None:
            log(f"    profiled {stage} step: no device time seen; busy "
                f"share not measured")
            continue
        log(f"    profiled {stage} step: wall {prof['wall_ms']:.2f} ms, "
            f"{prof['launches']} kernel launches, "
            f"device busy {prof['device_busy_ms']:.2f} ms, busy share "
            f"{prof['busy_share']:.3f} ({prof['busy_share_unprofiled']:.3f} "
            f"of the unprofiled median step); top kernels (ms, calls):")
        for name, kms, count in prof["top"]:
            log(f"      {kms:9.3f} {count:5d}  {name}")
    return profiles


def behavior_config(base_dir):
    cfg = load_config(BEHAVIOR_CONFIG)
    return deep_merge(cfg, {"general": {"base_dir": base_dir}})


def metric_lines(run_dir):
    with open(os.path.join(run_dir, "log", "debug", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def module_digest(module):
    """Sum of |parameter| in float64: a check that two runs hold the same
    weights."""
    return float(sum(p.detach().double().abs().sum()
                     for p in module.parameters()))


def phase_behavior():
    """Returns the rollout kernel's launches in the served request and the
    run's base directory, which phase [12] evaluates and deletes."""
    base = tempfile.mkdtemp(prefix="chip_smoke_behavior_")
    path = os.path.join(base, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(behavior_config(base), f)
    recorder = BehaviorRecorder()
    recorder.install()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(["-c", path, "--device", "cuda", "--debug"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = recorder.steps
        batch = int(behavior_config(base)["training"]["batch_size"])
        n_params = out["n_params"]
        log(f"[10] behavior_net training at full width (configs/"
            f"behavior_net.yaml, --debug) through bdvs-train-torch's main: "
            f"{len(steps['cvae'])} cVAE and {len(steps['flow'])} flow steps "
            f"in {wall:.1f} s; parameters {n_params}")
        check(len(steps["cvae"]) == BEHAVIOR_STEPS
              and len(steps["flow"]) == BEHAVIOR_FLOW_STEPS,
              f"steps {[len(v) for v in steps.values()]}")
        check(all(np.isfinite(v) for r in steps["cvae"] + steps["flow"]
                  for v in r.values()), "a behavior step metric is not "
              "finite")
        for stage in ("cvae", "flow"):
            for r in steps[stage][:2] + steps[stage][-1:]:
                log(f"    {stage} step {r['step']}: {r['ms']:.2f} ms; "
                    + ", ".join(f"{k} {v:.5g}" for k, v in r.items()
                                if k not in ("step", "ms")))
        cvae_ms = float(np.median([r["ms"] for r in steps["cvae"][1:]]))
        flow_ms = float(np.median([r["ms"] for r in steps["flow"][1:]]))
        log(f"    median cVAE step after the first {cvae_ms:.2f} ms, "
            f"{batch * 1e3 / cvae_ms:.1f} sequences/s; median flow step "
            f"after the first {flow_ms:.2f} ms; peak memory "
            f"{peak / 2**30:.2f} GiB")
        run_dir = os.path.join(base, "behavior_net")
        lines = metric_lines(run_dir)
        prefixes = {p: sum(any(k.startswith(p) for k in r) for r in lines)
                    for p in ("train/", "eval/", "flow/")}
        check(all(prefixes.values()) and all(
            np.isfinite(v) for r in lines for v in r.values()),
            f"metrics.jsonl lines {prefixes}")
        log(f"    metrics.jsonl: {prefixes}; last flow line "
            + json.dumps({k: round(v, 5) for k, v in lines[-1].items()}))
        # the net as saved at the last step, before the profiled step
        # below updates it once more
        net_digest = module_digest(out["modules"]["net"])
        profiles = profile_stages(recorder, {"cvae": cvae_ms,
                                             "flow": flow_ms})
        behavior_params = out["behavior_params"]
        n_lines = len(metric_lines(run_dir))
    finally:
        recorder.uninstall()
    del out
    # a second main with -r: the run is finished, so no step runs
    recorder = BehaviorRecorder()
    recorder.install()
    try:
        again = train_cli.main(["-c", path, "--device", "cuda", "--debug",
                                "-r"])
    finally:
        recorder.uninstall()
    reruns = {k: len(v) for k, v in recorder.steps.items()}
    check(reruns == {"cvae": 0, "flow": 0}
          and again["state"].step == BEHAVIOR_STEPS
          and again["flow_state"].step == BEHAVIOR_FLOW_STEPS
          and len(metric_lines(run_dir)) == n_lines,
          f"-r after the run re-ran steps {reruns}")
    log(f"    -r after the run: restored cVAE step {again['state'].step} and "
        f"flow step {again['flow_state'].step}; steps run {reruns}")
    del again
    gc.collect()
    torch.cuda.empty_cache()
    launches, served = serve_behavior(behavior_params)
    RESULTS["behavior_train"] = dict(
        cvae_steps=steps["cvae"], flow_steps=steps["flow"],
        cvae_step_ms_median=cvae_ms, sequences_per_s=batch * 1e3 / cvae_ms,
        flow_step_ms_median=flow_ms, peak_gib=peak / 2**30, wall_s=wall,
        n_params=n_params, profile=profiles, metric_lines=prefixes,
        restart_steps=reruns, served=served, net_digest=net_digest)
    return launches, base


def serve_behavior(behavior_params):
    """The trained behavior.npz behind phase 4's alter VUNet: one B=20,
    T=50 sample request, which must launch the rollout kernel once and
    whose rollout must match the decoder's plain f32 loop on the kernel's
    bf16 operands, at phase 3's tolerance."""
    tree, bcfg = cli._load_params(behavior_params)
    arch, data = bcfg["architecture"], bcfg["data"]
    K, HID = int(data["n_kps"]), int(arch["dim_hidden_b"])
    net = ResidualBehaviorNet(K, HID, device=DEV).eval()
    net.load_state_dict(convert.behavior_net_from_flax(tree["net"]))
    flow = LatentFlow(HID, HID * int(arch.get("flow_mid_channels_factor", 2)),
                      int(arch.get("flow_hidden_depth", 2)),
                      int(arch.get("n_flows", 15)), device=DEV).eval()
    flow.load_state_dict(convert.latent_flow_from_flax(tree["flow"]))
    del tree
    g = torch.Generator(device=DEV).manual_seed(5)
    vunet = on_device(serving_vunet("alter"), g)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(world_coords=True),
        np.zeros(K, np.float32), np.ones(K, np.float32), np.arange(K),
        spatial_size=SLICE["S"], flow_model=flow)
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    x = request_inputs(B, g)
    loader, _ = build_sequence_data(load_config(BEHAVIOR_CONFIG), "test")
    x["x_start"] = torch.from_numpy(
        next(iter(loader))["keypoints"][:B, 0]).to(DEV)
    rollout.rollout_launches = 0          # counts start here: the trained
    out, ms, peak = serve(pipe, x)        # model's request
    launches = rollout.rollout_launches
    check(out["frames"].shape == (B, T, S, S, 3)
          and bool(torch.isfinite(out["frames"].float()).all()),
          "the trained behavior.npz request: frames")
    check(launches == 1, f"the trained behavior.npz request launched the "
          f"rollout kernel {launches} times")
    xs = out["poses_3d"].reshape(B, T, K)    # mean 0, std 1: xs itself
    d = net.decoder
    with torch.inference_mode():
        b = flow.reverse(x["z"])
        ref, _ = d(b, x["x_start"], T)
        r = d.rnn
        ref_bf16 = rollout.residual_lstm_rollout_plain(
            b, x["x_start"], r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
            d.n_out.weight, d.n_out.bias, T, operand_dtype=torch.bfloat16)
    err = float((xs - ref).abs().max())
    err_bf16 = float((xs - ref_bf16).abs().max())
    log(f"    served the trained behavior.npz (K={K}, flow on): B={B} T={T} "
        f"{ms:.2f} ms, {B * T * 1e3 / ms:.1f} frames/s, peak "
        f"{peak / 2**30:.2f} GiB, {launches} rollout launch; rollout vs the "
        f"decoder's plain f32 loop on its bf16 operands {err_bf16:.2e} "
        f"(atol 1e-2, rtol 1e-2, as in [3]); on its f32 weights {err:.2e} "
        f"(reported)")
    check(torch.allclose(xs, ref_bf16, atol=1e-2, rtol=1e-2),
          "the trained decoder's kernel rollout disagrees with its plain "
          "loop")
    return launches, dict(ms=ms, fps=B * T * 1e3 / ms, peak_gib=peak / 2**30,
                          launches=launches, err_plain_bf16=err_bf16,
                          err_plain_f32=err)


# -- 11. the behavior steps against the JAX package's golden ------------------
def phase_behavior_golden():
    with np.load(BEHAVIOR_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    cfg = json.loads(bytes(g["config"]).decode())
    d, arch, tr = cfg["data"], cfg["architecture"], cfg["training"]
    K, A, T = int(d["n_kps"]), int(d["n_actions"]), int(d["seq_length"][0])
    H, p = int(arch["dim_hidden_b"]), g["params"]
    modules = {
        "net": ResidualBehaviorNet(K, H, device=DEV),
        "regressor": RegressorFly(H, K, T, device=DEV),
        "cls_action": ClassifierAction(
            K, A, dim=p["cls_action"]["LSTM_0"]["w_hh"].shape[0],
            device=DEV),
        "cls_action2": SequenceDiscMichael(K, T - 1, out_dim=A, device=DEV),
        "cls_beta": ClassifierActionBeta(H, A, device=DEV)}
    flow = LatentFlow(H, 2 * H, 2, int(arch["n_flows"]), device=DEV)
    names = {"net": "behavior_net", "regressor": "regressor_fly",
             "cls_action": "classifier_action",
             "cls_action2": "sequence_disc_michael",
             "cls_beta": "classifier_action_beta", "flow": "latent_flow"}
    for name, m in dict(modules, flow=flow).items():
        m.load_state_dict(getattr(convert, f"{names[name]}_from_flax")(
            p[name]))
    n_steps = len(g["metrics"]["cvae"])
    state = BehaviorTrainState(
        modules, make_behavior_optimizers(modules, tr, n_steps),
        gamma=torch.zeros((), device=DEV))
    fstate = FlowTrainState(flow, make_flow_optimizer(flow, tr))

    def dev(a):
        return torch.as_tensor(a, device=DEV)
    batch = {k: dev(v) for k, v in g["batch"].items()}
    step = make_behavior_train_step(cfg, T, total_steps=n_steps)
    fstep = make_flow_train_step(modules["net"])
    worst = {}
    for stage in ("cvae", "flow"):
        for i in range(n_steps):
            dr = g["draws"][stage][str(i)]
            if stage == "cvae":
                m = step(state, batch, True, draws=StepDraws(
                    dev(dr["t_adv"]), [dev(t) for t in dr["t_reg"]],
                    dev(dr["eps"])))
            else:
                m = fstep(fstate, batch, eps=dev(dr["eps"]))
            for k, ref in g["metrics"][stage][str(i)].items():
                err = float((m[k].cpu() - torch.from_numpy(ref)).abs().max())
                tol = float(1e-4 * np.abs(ref).max()) + (
                    1e-5 if k in ("loss", "flow_loss") else 0.0)
                key = f"{stage}/{k}"
                worst[key] = max(worst.get(key, 0.0),
                                 err / tol if tol else err)
    after = {n: getattr(convert, f"{names[n]}_to_flax")(
        m.state_dict()) for n, m in dict(modules, flow=flow).items()}
    ref_after = flatten_tree(g["after"])
    d_params = max(float(np.abs(v - ref_after[k]).max())
                   for k, v in flatten_tree(after).items())
    bad = {k: v for k, v in worst.items() if v > 1.0}
    log(f"[11] golden behavior_net steps, {n_steps} cVAE + {n_steps} flow "
        f"(f32, TF32 off): worst metric error / tolerance "
        f"{max(worst.values()):.3f} over {len(worst)} metrics"
        f"{' ' + str(bad) if bad else ''}; max |param - JAX| of all six "
        f"modules {d_params:.2e} (<= 1e-4)")
    RESULTS["golden_behavior"] = dict(err_over_tol=worst, params=d_params)
    check(not bad and d_params <= 1e-4,
          "golden behavior_net steps out of tolerance")


# -- 12. the rest of the behavior experiment at full width ---------------------
class StageTimer:
    """Wraps callables of ``experiments/behavior_net.py`` so that each call
    runs between two ``torch.cuda.synchronize()`` calls; sums their wall
    times by stage."""

    def __init__(self):
        self.ms, self.calls = {}, {}
        self._orig = []

    def wrap(self, owner, name, stage, static=False):
        fn = getattr(owner, name)
        self._orig.append((owner, name, owner.__dict__[name]))

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[stage] = self.ms.get(stage, 0.0) + (
                time.perf_counter() - t0) * 1e3
            self.calls[stage] = self.calls.get(stage, 0) + 1
            return out
        setattr(owner, name, staticmethod(timed) if static else timed)

    def uninstall(self):
        for owner, name, orig in reversed(self._orig):
            setattr(owner, name, orig)


def summary_keys(seq_len):
    """The inference summary's keys at sequence length seq_len."""
    starts = list(dict.fromkeys(min(t, seq_len - 1)
                                for t in (0, 10, 20, 30, 40, 49)))
    per_start = [f"_t{t}" for t in starts] + [""]
    return ({"recon_mse", "ADE_c", "FDE_c", "recon_mu", "recon_mu_std",
             "distance_mu", "distance_mu_std", "flow_ks_p",
             "loss_regressor_posthoc", "CF_cross", "CF_logits_l2",
             "CF_logits_cos", "CF_action", "CF_action_beta"}
            | {f"{m}_{s}" for m in ("APD", "ASD", "FSD", "ADE", "FDE")
               for s in ("prior", "flow")}
            | {f"DE{t}" for t in per_start}
            | {f"loss_regressor{t}" for t in per_start[:-1]}
            | {f"{p}_{s}{t}" for p in ("score", "acc")
               for s in ("prior", "cross", "self", "flow")
               for t in per_start})


def timed_inference(path, extra_argv=()):
    """``main -m infer`` with its stages timed; returns (summary, wall s,
    stage ms, peak bytes, rollout kernel launches)."""
    timer = StageTimer()
    exp = behavior_net.BehaviorNetExperiment
    timer.wrap(behavior_net.CheckpointManager, "restore_latest",
               "checkpoint reads")
    timer.wrap(exp, "_sample_rollouts", "sampled rollouts", static=True)
    timer.wrap(behavior_net, "sequence_sample_metrics", "sample metrics")
    timer.wrap(exp, "_run_posthoc_protocol", "post-hoc protocol")
    timer.wrap(behavior_net, "train_posthoc_classifiers",
               "post-hoc probe training")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rollout.rollout_launches = 0          # counts start here: -m infer
    t0 = time.perf_counter()
    try:
        summary = train_cli.main(["-c", path, "--device", "cuda", "-m",
                                  "infer", *extra_argv])
        torch.cuda.synchronize()
    finally:
        timer.uninstall()
    launches = rollout.rollout_launches
    return (summary, time.perf_counter() - t0, timer.ms,
            torch.cuda.max_memory_allocated(), launches)


def check_summary(summary, seq_len, what):
    want = summary_keys(seq_len)
    check(set(summary) == want, f"{what}: summary keys differ by "
          f"{sorted(set(summary) ^ want)}")
    check(all(np.isfinite(v) for v in summary.values()),
          f"{what}: a summary value is not finite")


def log_inference(what, summary, wall, ms, peak, launches):
    log(f"    {what}: {len(summary)} summary keys, all finite; wall "
        f"{wall:.1f} s, peak {peak / 2**30:.2f} GiB, {launches} rollout "
        f"kernel launches (the f32 loop samples); stages (ms): "
        + ", ".join(f"{k} {v:.0f}" for k, v in ms.items()))
    log("    " + ", ".join(f"{k} {summary[k]:.4g}" for k in (
        "recon_mse", "ADE_prior", "FDE_prior", "APD_prior", "ADE_flow",
        "FDE_flow", "APD_flow", "ADE_c", "flow_ks_p", "score_prior",
        "acc_prior", "loss_regressor_posthoc", "CF_cross")))


def write_config(base, name, cfg):
    path = os.path.join(base, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_recorded(argv, profile_stage=None, recorder=None):
    """``main`` with its steps recorded (by default behavior_net's cVAE
    and flow steps); with ``profile_stage``, one more step of that stage
    profiled after the run.  Returns (main's result, the steps, the
    profile or None)."""
    recorder = recorder or BehaviorRecorder()
    recorder.install()
    try:
        out = train_cli.main(argv)
    finally:
        recorder.uninstall()
    profile = None
    if profile_stage:
        ms = float(np.median([r["ms"] for r in
                              recorder.steps[profile_stage][1:]]))
        profile = profile_stages(recorder, {profile_stage: ms})[
            profile_stage]
    recorder.last.clear()
    return out, recorder.steps, profile


def phase_behavior_rest(base):
    """(a) -m infer on phase [10]'s run, (b) -f in a sibling project, (c)
    the cVAE with training.bf16, (d) dataset: h36m_synthetic trained and
    inferred; all at configs/behavior_net.yaml's widths, through main."""
    f32 = RESULTS["behavior_train"]
    path = os.path.join(base, "config.yaml")
    seq_len = int(load_config(BEHAVIOR_CONFIG)["data"]["seq_length"][0])
    out = {}
    # (a)
    summary, wall, ms, peak, launches = timed_inference(path, ["--debug"])
    log(f"[12] the rest of the behavior experiment at full width "
        f"(configs/behavior_net.yaml) through bdvs-train-torch's main")
    log_inference("(a) -m infer --debug on [10]'s run (2 batches of 64 x 50 "
                  "prior and flow rollouts, 64 cached sequences, 50 "
                  "post-hoc iterations x 4 sources x 6 starts)", summary,
                  wall, ms, peak, launches)
    check_summary(summary, seq_len, "(a) -m infer")
    check(launches == 0, f"-m infer launched the rollout kernel {launches} "
          f"times; its rollouts are the f32 loop's")
    run_dir = os.path.join(base, "behavior_net")
    infer_lines = [r for r in metric_lines(run_dir)
                   if any(k.startswith("infer/") for k in r)]
    check(len(infer_lines) == 1, f"{len(infer_lines)} infer/ lines")
    out["infer"] = dict(summary=summary, wall_s=wall, stage_ms=ms,
                        peak_gib=peak / 2**30, rollout_launches=launches)
    # (b): a sibling project without --debug, 1 epoch of 8 batches; [10]'s
    # flow save (7.6 GB) and behavior.npz (2.5 GB) are no longer needed
    debug_ckpt = os.path.join(run_dir, "ckpt", "debug")
    shutil.rmtree(os.path.join(debug_ckpt, "flow_ckpt"))
    os.remove(os.path.join(debug_ckpt, "behavior.npz"))
    batch = int(behavior_config(base)["training"]["batch_size"])
    cfg = deep_merge(behavior_config(base), {
        "general": {"project_name": "sibling"}, "training": {"n_epochs": 1},
        "data": {"n_samples": 8 * batch}})
    t0 = time.perf_counter()
    sib, steps, _ = run_recorded(["-c", write_config(base, "sibling.yaml",
                                                     cfg),
                                  "--device", "cuda", "-f"])
    wall = time.perf_counter() - t0
    n = {k: len(v) for k, v in steps.items()}
    digest = module_digest(sib["modules"]["net"])
    ckpt = os.path.join(run_dir, "ckpt", "sibling")
    log(f"    (b) -f in the project 'sibling': {n} steps in {wall:.1f} s; "
        f"its net's digest {digest:.6f} vs [10]'s {f32['net_digest']:.6f}; "
        f"reg_ckpt saves {os.listdir(os.path.join(ckpt, 'reg_ckpt'))}, "
        f"flow_ckpt saves {os.listdir(os.path.join(ckpt, 'flow_ckpt'))}")
    check(n == {"cvae": 0, "flow": 8} and digest == f32["net_digest"]
          and not os.listdir(os.path.join(ckpt, "reg_ckpt"))
          and all(np.isfinite(v) for r in steps["flow"]
                  for v in r.values()),
          "-f did not train the flow alone over [10]'s cVAE")
    out["flow_only"] = dict(steps=n, wall_s=wall,
                            flow_step_ms_median=float(np.median(
                                [r["ms"] for r in steps["flow"][1:]])))
    del sib
    shutil.rmtree(base, ignore_errors=True)
    # (c)
    base = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        cfg = deep_merge(behavior_config(base), {"training": {"bf16": True}})
        bf, steps, prof = run_recorded(
            ["-c", write_config(base, "c.yaml", cfg), "--device", "cuda",
             "--debug"], profile_stage="cvae")
        mods = bf["modules"]
        check(len(steps["cvae"]) == BEHAVIOR_STEPS
              and len(steps["flow"]) == BEHAVIOR_FLOW_STEPS
              and all(np.isfinite(v) for r in steps["cvae"] + steps["flow"]
                      for v in r.values())
              and mods["net"].decoder.dtype == torch.bfloat16
              and all(p.dtype == torch.float32 for m in mods.values()
                      for p in m.parameters()),
              "the bf16 run's steps or dtypes")
        del bf, mods
        ms_bf16 = float(np.median([r["ms"] for r in steps["cvae"][1:]]))
        log(f"    (c) training.bf16: median cVAE step after the first "
            f"{ms_bf16:.2f} ms, {batch * 1e3 / ms_bf16:.1f} sequences/s, "
            f"beside [10]'s f32 {f32['cvae_step_ms_median']:.2f} ms, "
            f"{f32['sequences_per_s']:.1f} sequences/s "
            f"(x{f32['cvae_step_ms_median'] / ms_bf16:.3f}); last step "
            + ", ".join(f"{k} {v:.4g}" for k, v in steps["cvae"][-1].items()
                        if k in ("loss", "loss_recon", "kl_loss")))
        out["bf16"] = dict(cvae_steps=steps["cvae"], profile=prof,
                           cvae_step_ms_median=ms_bf16,
                           sequences_per_s=batch * 1e3 / ms_bf16,
                           f32_cvae_step_ms_median=f32["cvae_step_ms_median"])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    # (d)
    base = tempfile.mkdtemp(prefix="chip_smoke_h36m_")
    try:
        cfg = deep_merge(behavior_config(base),
                         {"data": {"dataset": "h36m_synthetic"}})
        path = write_config(base, "d.yaml", cfg)
        t0 = time.perf_counter()
        h36, steps, _ = run_recorded(["-c", path, "--device", "cuda",
                                      "--debug"])
        wall = time.perf_counter() - t0
        n = {k: len(v) for k, v in steps.items()}
        kps = h36["modules"]["net"].n_kps
        # 2 train subjects x 3 actions x 120 frames a batch at a time
        per_epoch = 2 * 3 * 120 // batch
        check(n == {"cvae": 2 * per_epoch, "flow": per_epoch} and kps == 51
              and all(np.isfinite(v) for r in steps["cvae"] + steps["flow"]
                      for v in r.values()),
              f"h36m_synthetic training: steps {n}, {kps} keypoints")
        del h36
        summary, iwall, ms, peak, launches = timed_inference(path,
                                                             ["--debug"])
        log(f"    (d) dataset: h36m_synthetic: trained {n} steps in "
            f"{wall:.1f} s (51 keypoints, 4 action labels)")
        log_inference("-m infer --debug on it", summary, iwall, ms, peak,
                      launches)
        check_summary(summary, seq_len, "(d) -m infer")
        out["h36m_synthetic"] = dict(steps=n, train_wall_s=wall,
                                     summary=summary, infer_wall_s=iwall,
                                     stage_ms=ms, peak_gib=peak / 2**30)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    RESULTS["behavior_rest"] = out


# -- 13. inference against the JAX package's golden ----------------------------
def phase_infer_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_infer as TI

    with np.load(INFER_GOLDEN) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    trees, draws = TI.golden_inputs(golden)
    with tempfile.TemporaryDirectory() as tmp:
        summary = TI.port_run_inference(trees, tmp, draws, device=DEV)
    worst, bad = TI.check_against_golden(summary, golden)
    log(f"[13] golden -m infer at small width (f32, TF32 off): "
        f"{len(golden['summary'])} summary values held, worst error / "
        f"tolerance {worst:.3f}{' ' + str(bad) if bad else ''}")
    RESULTS["golden_infer"] = dict(err_over_tol=worst, bad=bad,
                                   summary=summary)
    check(not bad, "golden -m infer out of tolerance")


# -- 14. the VUNet experiments at full width ----------------------------------
# the org VUNet's dropout sites at 256 px with a 64x64 part stack: 10 RNBs
# in the appearance EncUp (5 scales), 14 in the shape EncUp, 5 residual
# RNBs in EncDown and 14 in DecDown (two sites each), and at each of the 2
# latent scales the prior's pre block (one) and 3 residual blocks (two)
ORG_DROPOUT_SITES = 10 + 14 + 2 * 5 + 2 * 14 + 2 * (1 + 2 * 3)
ORG_TRAIN_STEPS, ORG_DROPOUT_STEPS, CVBAE_RESUMED_TO = 6, 2, 8
ORG_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "golden",
                                "torch_port_org_train_small.npz")


def org_train_config(base_dir, **training):
    cfg = load_config(ORG_CONFIG)
    return deep_merge(cfg, {
        "general": {"base_dir": base_dir, "project_name": "chip_smoke"},
        "training": training})


def rnb_dropout_sites(vunet):
    """(forward, backward) ELU+dropout launches of a training step: one
    site per RNB input (two for a residual block), less EncDown's last two
    residual blocks' backward (DEAD_BACKWARD_SITES)."""
    fwd = sum(1 + int(m.residual) for m in vunet.modules()
              if isinstance(m, ops_nn.VunetRNB))
    return fwd, fwd - DEAD_BACKWARD_SITES


def recorded_main(argv, make_name, stop_after=None):
    """``main`` with the training step that shape_and_pose_net's
    ``make_name`` makes recorded; returns (main's result, recorder)."""
    recorder = StepRecorder(getattr(shape_and_pose_net, make_name),
                            stop_after)
    made = getattr(shape_and_pose_net, make_name)
    setattr(shape_and_pose_net, make_name, recorder.make)
    try:
        out = train_cli.main(argv)
    except StopTraining:
        out = None
    finally:
        setattr(shape_and_pose_net, make_name, made)
    return out, recorder


def timed_vunet_inference(path):
    """``main -m infer`` on a VUNet run, its stages timed (with IS and FID
    on, the Inception forward and the FID's statistics alone, inside the
    evaluation); returns (summary, wall s, stage ms, stage calls, peak
    bytes)."""
    timer = StageTimer()
    exp = shape_and_pose_net.ShapePoseExperiment
    timer.wrap(shape_and_pose_net.CheckpointManager, "restore_latest",
               "restore")
    timer.wrap(exp, "_build_data", "data set-up")
    timer.wrap(exp, "_eval_metrics", "evaluation")
    timer.wrap(shape_and_pose_net, "inception_features", "Inception forward")
    timer.wrap(shape_and_pose_net, "fid_from_features", "FID statistics")
    timer.wrap(exp, "_posthoc_latent_regressor", "post-hoc regressor")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        summary = train_cli.main(["-c", path, "--device", "cuda", "-m",
                                  "infer"])
        torch.cuda.synchronize()
    finally:
        timer.uninstall()
    return (summary, time.perf_counter() - t0, timer.ms, timer.calls,
            torch.cuda.max_memory_allocated())


def log_vunet_inference(what, summary, wall, ms, peak):
    log(f"    {what}: " + ", ".join(f"{k} {v:.5g}" for k, v in
                                    summary.items())
        + f"; wall {wall:.2f} s, peak {peak / 2**30:.2f} GiB; stages (ms): "
        + ", ".join(f"{k} {v:.0f}" for k, v in ms.items()))
    check(all(np.isfinite(v) for v in summary.values()),
          f"{what}: a summary value is not finite")


def snapshot(vunet, opts, state, gens):
    return (copy.deepcopy(vunet.state_dict()),
            {k: copy.deepcopy(o.state_dict()) for k, o in opts.items()
             if o is not None},
            state.step, [g.get_state() for g in gens])


def restore_snapshot(snap, vunet, opts, state, gens):
    sd, osd, step, gstates = snap
    vunet.load_state_dict(sd)
    for k, v in osd.items():
        opts[k].load_state_dict(copy.deepcopy(v))
    state.step = step
    for g, st in zip(gens, gstates):
        g.set_state(st)


def phase_vunet(cvbae_base, cvbae_path):
    """(a) configs/vunet.yaml trained 6 steps and resumed, its synth.npz
    served; (b) 2 org steps through the ELU+dropout kernels against their
    plain versions; (c) phase [7]'s cvbae run resumed to step 8 and
    evaluated; (d) the org run evaluated; (e) the device part-stack warp
    against its plain version.  Returns the ELU+dropout launches of (b)
    and (c)."""
    base = tempfile.mkdtemp(prefix="chip_smoke_vunet_")
    try:
        return _phase_vunet(base, cvbae_base, cvbae_path)
    finally:
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(cvbae_base, ignore_errors=True)


def _phase_vunet(base, cvbae_base, cvbae_path):
    # (a) org training as published, 6 steps
    cfg = org_train_config(base, end_iteration=ORG_TRAIN_STEPS)
    path = write_config(base, "vunet.yaml", cfg)
    render_ms = []
    stacks = SyntheticImageDataset.part_stacks

    def timed_stacks(self, renders):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stacks(self, renders)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    SyntheticImageDataset.part_stacks = timed_stacks
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out, rec = recorded_main(["-c", path, "--device", "cuda"],
                                 "make_org_vunet_train_step")
    finally:
        SyntheticImageDataset.part_stacks = stacks
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = rec.steps
    B = int(cfg["training"]["batch_size"])
    check(len(steps) == ORG_TRAIN_STEPS and out["state"].step
          == ORG_TRAIN_STEPS, f"org training ran {len(steps)} steps")
    check(all(np.isfinite(r[k]) for r in steps for k in (
        "loss", "likelihood_loss", "kl_loss", "kl_weight", "grad_norm")),
        "an org training metric is not finite")
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    log(f"[14] (a) org VUNet training (configs/vunet.yaml, B={B}, "
        f"{ORG_TRAIN_STEPS} steps) through main: {wall:.1f} s in all; "
        f"VUNet {out['n_params']:,} parameters; part stacks of the "
        f"{len(render_ms)} split(s) rendered in "
        + ", ".join(f"{ms:.2f}" for ms in render_ms) + " ms")
    for r in steps:
        log(f"    step {r['step']}: loss {r['loss']:.6g} (likelihood "
            f"{r['likelihood_loss']:.6g}, kl {r['kl_loss']:.6g}, kl_weight "
            f"{r['kl_weight']:.3g}, grad_norm {r['grad_norm']:.4g}); "
            f"{r['ms']:.2f} ms")
    step, state, batch, kw = rec.last
    prof = profile_call(lambda: step(state, batch, **kw), step_ms)
    busy = "not measured" if prof is None else (
        f"{prof['busy_share']:.3f} ({prof['busy_share_unprofiled']:.3f} of "
        f"the median step), device {prof['device_busy_ms']:.2f} ms in "
        f"{prof['launches']} launches")
    log(f"    median step after the first {step_ms:.2f} ms, "
        f"{B * 1e3 / step_ms:.1f} img/s; peak {peak / 2**30:.2f} GiB; "
        f"profiled step busy share {busy}")
    rec.last = None
    RESULTS["org_train"] = dict(
        steps=steps, step_ms_median=step_ms, img_per_s=B * 1e3 / step_ms,
        peak_gib=peak / 2**30, wall_s=wall, part_stack_ms=render_ms,
        profile=prof, vunet_params=out["n_params"])
    synth = out["synth_params"]
    del out, step, state, batch, kw
    out, rec = recorded_main(["-c", path, "--device", "cuda", "-r"],
                             "make_org_vunet_train_step")
    check(out["state"].step == ORG_TRAIN_STEPS and not rec.steps,
          f"-r ran {len(rec.steps)} steps from step {out['state'].step}")
    log(f"    -r: restored step {out['state'].step}, ran no step")
    del out
    serve_org_chunk(synth)

    # (b) 2 org steps through the ELU+dropout kernels
    cfg_b = org_train_config(os.path.join(base, "dropout"),
                             dropout_prob=0.05, dropout_impl="pallas")
    path_b = write_config(base, "vunet_dropout.yaml", cfg_b)
    elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
    elu_dropout.elu_dropout_bwd_launches = 0   # org step with dropout
    _, rec = recorded_main(["-c", path_b, "--device", "cuda"],
                           "make_org_vunet_train_step",
                           stop_after=ORG_DROPOUT_STEPS)
    launches_b = (elu_dropout.elu_dropout_fwd_launches,
                  elu_dropout.elu_dropout_bwd_launches)
    vunet, _, opts = rec.args[:3]
    sites = rnb_dropout_sites(vunet)
    check(sites[0] == ORG_DROPOUT_SITES, f"org dropout sites {sites}")
    check(len(rec.steps) == ORG_DROPOUT_STEPS and all(
        (r["fwd_launches"], r["bwd_launches"]) == sites for r in rec.steps),
        f"an org step did not launch the ELU+dropout kernels {sites} times: "
        + str([(r["fwd_launches"], r["bwd_launches"]) for r in rec.steps]))
    check(all(np.isfinite(r["loss"]) for r in rec.steps),
          "an org dropout step's loss is not finite")
    step, state, batch, kw = rec.last
    gens = [kw["generator"], kw["dropout_generator"]]
    snap = snapshot(vunet, opts, state, gens)
    loss_k = float(step(state, batch, **kw)["loss"])
    restore_snapshot(snap, vunet, opts, state, gens)
    launch = elu_dropout._launch_fwd, elu_dropout._launch_bwd
    elu_dropout._launch_fwd = elu_dropout.elu_dropout_plain
    elu_dropout._launch_bwd = elu_dropout.elu_dropout_backward_plain
    try:
        loss_p = float(step(state, batch, **kw)["loss"])
    finally:
        elu_dropout._launch_fwd, elu_dropout._launch_bwd = launch
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"    (b) {ORG_DROPOUT_STEPS} org steps, dropout 0.05 through the "
        f"ELU+dropout kernels: {sites[0]} forward / {sites[1]} backward "
        f"launches a step ({launches_b} in all); losses "
        + ", ".join(f"{r['loss']:.6g}" for r in rec.steps)
        + f"; a step {float(np.mean([r['ms'] for r in rec.steps])):.2f} ms; "
        f"the next step's loss {loss_k:.8g} vs the plain Philox route "
        f"{loss_p:.8g}: rel {rel:.2e} (<= 1e-5)")
    check(rel <= 1e-5, "the org step through the kernels disagrees with "
          "their plain versions")
    RESULTS["org_dropout"] = dict(steps=rec.steps, sites=list(sites),
                                  launches=list(launches_b), loss_kernel=
                                  loss_k, loss_plain=loss_p, rel=rel)
    del vunet, opts, step, state, batch, kw, snap, rec

    # (c) phase [7]'s cvbae run, resumed to step 8 and evaluated
    run_cfg = os.path.join(cvbae_base, "cvbae", "config", "chip_smoke",
                           "config.yaml")
    dumped = load_config(run_cfg)
    dumped["training"]["end_iteration"] = CVBAE_RESUMED_TO
    with open(run_cfg, "w") as f:
        yaml.safe_dump(dumped, f)
    elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
    elu_dropout.elu_dropout_bwd_launches = 0   # resumed cvbae run
    out, rec = recorded_main(["-c", cvbae_path, "--device", "cuda", "-r"],
                             "make_cvbae_train_step")
    launches_c = (elu_dropout.elu_dropout_fwd_launches,
                  elu_dropout.elu_dropout_bwd_launches)
    check([r["step"] for r in rec.steps] == list(range(
        TRAIN_STEPS + 1, CVBAE_RESUMED_TO + 1))
        and out["state"].step == CVBAE_RESUMED_TO,
        f"the resumed cvbae run took steps {[r['step'] for r in rec.steps]}")
    check(all(np.isfinite(r["loss"]) for r in rec.steps),
          "a resumed cvbae step's loss is not finite")
    log(f"    (c) cvbae -r: restored step {TRAIN_STEPS}, ran to "
        f"{CVBAE_RESUMED_TO}: losses "
        + ", ".join(f"{r['loss']:.6g}" for r in rec.steps)
        + f"; ELU+dropout launches {launches_c}")
    del out, rec
    infer_cfg = load_config(run_cfg)
    infer_cfg["general"]["debug"] = True      # 2 post-hoc epochs
    summary, wall, ms, _, peak = timed_vunet_inference(
        write_config(base, "cvbae_infer.yaml", infer_cfg))
    check(set(summary) == {"ssim", "loss_regressor_posthoc"},
          f"cvbae -m infer summary {sorted(summary)}")
    log_vunet_inference("cvbae -m infer (debug)", summary, wall, ms, peak)
    RESULTS["cvbae_infer"] = dict(summary=summary, wall_s=wall,
                                  stages_ms=ms, peak_gib=peak / 2**30)

    # (d) the org run evaluated, without the post-hoc regressor (C6)
    org_infer = deep_merge(cfg, {"general": {"debug": True},
                                 "metrics": {"posthoc_regressor": False}})
    summary, wall, ms, _, peak = timed_vunet_inference(
        write_config(base, "vunet_infer.yaml", org_infer))
    check(set(summary) == {"ssim"}, f"org -m infer summary {summary}")
    log_vunet_inference("org -m infer (debug, posthoc_regressor off)",
                        summary, wall, ms, peak)
    RESULTS["org_infer"] = dict(summary=summary, wall_s=wall,
                                stages_ms=ms, peak_gib=peak / 2**30)

    # (e) the device part-stack warp against its plain version
    dcfg = cfg["data"]
    ds = SyntheticImageDataset(
        spatial_size=int(dcfg["spatial_size"]), inplane_normalize=True,
        box_factor=int(dcfg["box_factor"]), device=DEV)
    S = ds.spatial_size
    part = S // 2 ** ds.box_factor
    renders = ((ds.photos + 1) * 127.5).round().to(torch.uint8)
    mats, valid = parts.part_transforms(ds.norm_keypoints * S,
                                        ds.joint_model, part, S)
    device_ms = cuda_ms(lambda: parts.warp_parts(renders, mats, valid,
                                                 part), 5)
    stack = parts.warp_parts(renders, mats, valid, part).cpu().numpy()
    t0 = time.perf_counter()
    plain = parts.warp_parts_plain(renders.cpu().numpy(), mats, valid, part)
    plain_ms = (time.perf_counter() - t0) * 1e3
    d = np.abs(stack.astype(int) - plain.astype(int))
    within, worst = float((d <= 1).mean()), int(d.max())
    log(f"    (e) part-stack warp, {ds.n} frames x {mats.shape[1]} parts at "
        f"{part}x{part} from {S} px: device {device_ms:.3f} ms (events), "
        f"the plain numpy loop {plain_ms:.0f} ms; {within:.5f} of values "
        f"within 1 level (>= 0.999), worst {worst} (<= 8); homographies "
        f"valid {valid.mean():.3f}")
    check(within >= 0.999 and worst <= 8,
          "the device part-stack warp disagrees with its plain version")
    RESULTS["part_stack_warp"] = dict(
        frames=ds.n, device_ms=device_ms, plain_ms=plain_ms,
        within_1=within, worst=worst)
    return (launches_b[0] + launches_c[0], launches_b[1] + launches_c[1])


def serve_org_chunk(synth_params):
    """The org run's synth.npz, strictly into a serving VUNet, and one
    transfer_cached chunk of 125 frames."""
    tree, cfg = cli._load_params(synth_params)
    vunet = vunet_from_config(cfg, "org", dtype=torch.bfloat16,
                              device=DEV).eval()
    vunet.load_state_dict(convert.vunet_org_from_flax(tree["vunet"]),
                          strict=True)
    S = vunet.spatial_size
    g = torch.Generator(device=DEV).manual_seed(3)
    app = torch.rand(1, S // 4, S // 4, 30, generator=g, device=DEV) * 2 - 1
    stick = torch.rand(125, S, S, 3, generator=g, device=DEV) * 2 - 1
    with torch.inference_mode():
        means, _ = vunet.encode_means(app, generator=g)
        frames = vunet.transfer_cached(
            [m.expand(125, *m.shape[1:]) for m in means], stick)
    check(frames.shape == (125, S, S, 3)
          and bool(torch.isfinite(frames.float()).all()),
          "the org run's synth.npz does not serve")
    log(f"    synth.npz loaded strictly and served one org transfer_cached "
        f"chunk: frames {tuple(frames.shape)}")


# -- 15. the org training step against the JAX package's golden ---------------
def phase_org_train_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_org_train as TO

    with np.load(ORG_TRAIN_GOLDEN) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    tree, batch, noise = TO.golden_inputs(golden)
    metrics, after = TO.port_steps(tree, batch, noise, device=DEV)
    worst_m, worst_u = TO.check_against_golden(metrics, tree, after, golden)
    log(f"[15] golden org step x{len(metrics)} (f32, TF32 off): worst "
        f"metric error / tolerance {worst_m:.3f}, worst update error / "
        f"tolerance {worst_u:.3f} (each <= 1)")
    RESULTS["golden_org_train"] = dict(metric_err_over_tol=worst_m,
                                       update_err_over_tol=worst_u)
    check(worst_m <= 1.0 and worst_u <= 1.0,
          "golden org training step out of tolerance")


# -- 16. the MT-VAE experiment at full width -----------------------------------
MTVAE_CONFIG = os.path.join(ROOT, "configs", "mt_vae.yaml")
MTVAE_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_port_mtvae_small.npz")
MTVAE_STEPS = 16          # debug: 2 epochs of 8 batches of 256


def mtvae_recorder():
    return BehaviorRecorder(mt_vae, (("make_mtvae_train_step", "mtvae"),))


def mtvae_config(base_dir, **sections):
    """configs/mt_vae.yaml under base_dir with ``general.debug`` (2 epochs
    of 8 batches, as ``--debug``) in its own project, so that ``-p -d``
    can warm-start the "debug" project beside it."""
    return deep_merge(load_config(MTVAE_CONFIG), deep_merge(
        {"general": {"base_dir": base_dir, "debug": True}}, sections))


def mtvae_summary_keys(t_out):
    """The JAX experiment's summary keys at t_out predicted frames (held
    against a live JAX run in tests/test_torch_mtvae_cli.py)."""
    starts = dict.fromkeys(min(t, t_out - 1) for t in (0, 10, 20, 30, 40, 49))
    per_start = [f"_t{t}" for t in starts] + [""]
    return ({"APD", "ASD", "FSD", "ADE", "FDE", "self_recon_mse", "ADE_c",
             "FDE_c"} | {f"DE{t}" for t in per_start}
            | {f"{p}_{s}{t}" for p in ("score", "acc")
               for s in ("prior", "self", "cross") for t in per_start})


def kernel_launches():
    return dict(rollout=rollout.rollout_launches,
                elu_dropout_fwd=elu_dropout.elu_dropout_fwd_launches,
                elu_dropout_bwd=elu_dropout.elu_dropout_bwd_launches,
                fused_rnb=fused_rnb.fused_rnb_launches)


def zero_kernel_launches():
    rollout.rollout_launches = fused_rnb.fused_rnb_launches = 0
    elu_dropout.elu_dropout_fwd_launches = 0
    elu_dropout.elu_dropout_bwd_launches = 0


def timed_mtvae_inference(path):
    """``main -m infer`` on an mtvae run with its stages timed; returns
    (summary, wall s, stage ms, peak bytes)."""
    timer = StageTimer()
    timer.wrap(mt_vae.CheckpointManager, "restore_latest", "restore")
    timer.wrap(mt_vae.MTVAEExperiment, "_sample_prior", "prior sampling",
               static=True)
    timer.wrap(mt_vae, "sequence_sample_metrics", "sample metrics")
    timer.wrap(mt_vae, "cross_transfer_metrics", "sample metrics")
    timer.wrap(mt_vae, "train_posthoc_classifiers", "post-hoc probes")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        summary = train_cli.main(["-c", path, "--device", "cuda", "-m",
                                  "infer"])
        torch.cuda.synchronize()
    finally:
        timer.uninstall()
    wall = time.perf_counter() - t0
    timer.ms["other (self and cross forwards, data)"] = (
        wall * 1e3 - sum(timer.ms.values()))
    return summary, wall, timer.ms, torch.cuda.max_memory_allocated()


def phase_mtvae():
    base = tempfile.mkdtemp(prefix="chip_smoke_mtvae_")
    try:
        RESULTS["mtvae"] = _phase_mtvae(base)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _phase_mtvae(base):
    cfg = mtvae_config(base)
    path = write_config(base, "mt_vae.yaml", cfg)
    batch = int(cfg["training"]["batch_size"])
    project = cfg["general"]["project_name"]
    run_dir = os.path.join(base, "mtvae")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    t0 = time.perf_counter()
    run, steps, prof = run_recorded(["-c", path, "--device", "cuda"],
                                    "mtvae", mtvae_recorder())
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = steps["mtvae"]
    model = run["model"]
    T = int(cfg["data"]["seq_length"][0]) + 1
    log(f"[16] mtvae at full width (configs/mt_vae.yaml, general.debug) "
        f"through bdvs-train-torch's main: B={batch}, T={T} (n_cond "
        f"{model.n_cond}), {model.n_in} keypoints, dim {model.dim}, "
        f"{model.dtype}, TF32 off; {run['n_params']} parameters; "
        f"{len(steps)} steps in {wall:.1f} s (the profiled step after "
        f"them included); launches of the hand-written kernels "
        f"{launches} (none is on this path)")
    check(len(steps) == MTVAE_STEPS and all(
        np.isfinite(v) for r in steps for v in r.values()),
        f"{len(steps)} mtvae steps, or a metric is not finite")
    for r in steps[:2] + steps[-1:]:
        log(f"    step {r['step']}: {r['ms']:.2f} ms; " + ", ".join(
            f"{k} {v:.5g}" for k, v in r.items() if k not in ("step", "ms")))
    ms = float(np.median([r["ms"] for r in steps[1:]]))
    log(f"    median step after the first {ms:.2f} ms, "
        f"{batch * 1e3 / ms:.1f} sequences/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    with open(os.path.join(run_dir, "log", project, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check([r["step"] for r in lines] == [8, 16] and all(
        np.isfinite(v) for r in lines for v in r.values()),
        f"metrics.jsonl steps {[r['step'] for r in lines]}")
    del run, model
    out = dict(steps=steps, step_ms_median=ms,
               sequences_per_s=batch * 1e3 / ms, peak_gib=peak / 2**30,
               wall_s=wall, profile=prof, kernel_launches=launches)

    again, rsteps, _ = run_recorded(["-c", path, "--device", "cuda", "-r"],
                                    recorder=mtvae_recorder())
    check(not rsteps["mtvae"] and again["state"].step == MTVAE_STEPS,
          f"-r after the run ran {len(rsteps['mtvae'])} steps")
    log(f"    -r after the run: restored step {again['state'].step}, no "
        f"step run")
    del again

    summary, iwall, stage_ms, ipeak = timed_mtvae_inference(path)
    want = mtvae_summary_keys(T - int(cfg["training"]["n_cond"]))
    check(set(summary) == want, f"-m infer summary keys differ by "
          f"{sorted(set(summary) ^ want)}")
    check(all(np.isfinite(v) for v in summary.values()),
          "a -m infer summary value is not finite")
    log(f"    -m infer (2 batches x 50 prior samples, 50 post-hoc "
        f"iterations): {len(summary)} summary keys, all finite, equal to "
        f"the JAX experiment's; wall {iwall:.1f} s, peak {ipeak / 2**30:.2f} "
        f"GiB; stages (ms): " + ", ".join(f"{k} {v:.0f}"
                                          for k, v in stage_ms.items()))
    log("    " + ", ".join(f"{k} {summary[k]:.4g}" for k in (
        "ADE", "FDE", "APD", "self_recon_mse", "ADE_c", "FDE_c",
        "score_prior", "acc_prior", "score_cross", "DE")))
    out["infer"] = dict(summary=summary, wall_s=iwall, stage_ms=stage_ms,
                        peak_gib=ipeak / 2**30)

    pretrained = os.path.join(run_dir, "config", project)
    warm, wsteps, _ = run_recorded(
        ["-c", path, "--device", "cuda", "-p", pretrained, "-d"],
        recorder=mtvae_recorder())
    saves = sorted(os.listdir(os.path.join(run_dir, "ckpt", "debug",
                                           "reg_ckpt")))
    check(not wsteps["mtvae"] and warm["state"].step == MTVAE_STEPS
          and saves == sorted(os.listdir(os.path.join(
              run_dir, "ckpt", project, "reg_ckpt"))),
          f"-p -d: {len(wsteps['mtvae'])} steps, saves {saves}")
    log(f"    -p {project} -d: the 'debug' project restored the copied "
        f"step {warm['state'].step} ({saves}), no step run")
    del warm

    cfg16 = mtvae_config(base, general={"project_name": "bf16"},
                         training={"bf16": True})
    bf, bsteps, bprof = run_recorded(
        ["-c", write_config(base, "bf16.yaml", cfg16), "--device", "cuda"],
        "mtvae", mtvae_recorder())
    bsteps = bsteps["mtvae"]
    check(len(bsteps) == MTVAE_STEPS and bf["model"].dtype == torch.bfloat16
          and all(p.dtype == torch.float32 for p in bf["model"].parameters())
          and all(np.isfinite(v) for r in bsteps for v in r.values()),
          "the bf16 mtvae run's steps or dtypes")
    del bf
    ms16 = float(np.median([r["ms"] for r in bsteps[1:]]))
    log(f"    training.bf16: median step after the first {ms16:.2f} ms, "
        f"{batch * 1e3 / ms16:.1f} sequences/s, beside f32 {ms:.2f} ms "
        f"(x{ms / ms16:.3f}); last step " + ", ".join(
            f"{k} {v:.4g}" for k, v in bsteps[-1].items()
            if k in ("loss", "rec_loss", "kl_loss")))
    out["bf16"] = dict(steps=bsteps, step_ms_median=ms16,
                       sequences_per_s=batch * 1e3 / ms16, profile=bprof)
    return out


# -- 17. the MT-VAE step against the JAX package's golden ----------------------
def phase_mtvae_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_mtvae as TM

    with np.load(MTVAE_GOLDEN) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    tree, batch, noise = TM.golden_inputs(golden)
    metrics, after = TM.port_steps(tree, batch, noise, device=DEV)
    worst_m, worst_u = TM.check_against_golden(metrics, tree, after, golden)
    log(f"[17] golden mtvae step x{len(metrics)} (f32, TF32 off): worst "
        f"metric error / tolerance {worst_m:.3f}, worst update error / "
        f"tolerance {worst_u:.3f} (each <= 1)")
    RESULTS["golden_mtvae"] = dict(metric_err_over_tol=worst_m,
                                   update_err_over_tol=worst_u)
    check(worst_m <= 1.0 and worst_u <= 1.0,
          "golden mtvae training step out of tolerance")


# -- 18. the VUNet experiments on image files at full width -------------------
IMAGE_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_port_image_data_small.npz")
# Human3.6M: 2 subjects x 2 actions x 2 cameras x 40 frames of 1000 x 1000;
# the published action split trains on both actions (320 frames, 26
# batches of 12) and tests on action 8 (160 frames, 13 batches)
H36M_SHAPE = dict(subjects=(1, 9), actions=(2, 8),
                  cameras=(54138969, 55011271), n_frames=40, image_hw=1000)
# DeepFashion: 192 images of 256 px, 3 in 4 train (18 batches of 8)
DF_IMAGES, DF_SIZE = 192, 256
IMAGE_STEPS, IMAGE_RESUMED_TO = 6, 8


def write_image_trees(base):
    """The Human3.6M tree (JPEG frames and annot_export.h5) and the
    DeepFashion index.p tree from numpy seeds, the JPEGs encoded on a
    thread pool; returns (h36m root, deepfashion root)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_image_data as TI

    cols = TI.h36m_columns(**H36M_SHAPE)
    with ThreadPoolExecutor(8) as pool:
        h36m = TI.h36m_frames(cols, image_hw=H36M_SHAPE["image_hw"],
                              encode=lambda img: pool.submit(
                                  TI.encode_jpeg, img))
        h36m = [f.result() for f in h36m]
    df_jpegs, index = TI.index_data(DF_IMAGES, DF_SIZE, seed=31)
    return (TI.write_h36m_tree(os.path.join(base, "h36m"), cols, h36m),
            TI.write_index_tree(os.path.join(base, "deepfashion"), df_jpegs,
                                index),
            sum(map(len, h36m)) + sum(map(len, df_jpegs)))


def recomposed_loss(r, prev, cfg):
    """The loss a recorded step should report, from its own terms: cvbae
    adds gamma * KL once its step count passes ``n_init_batches`` (with
    the gamma of the step before, which the step updates after its loss)
    and subtracts the regressor's clipped loss; org adds its KL weight *
    KL."""
    if "kl_weight" in r:
        return r["likelihood_loss"] + r["kl_weight"] * r["kl_loss"]
    tr = cfg["training"]
    loss = r["likelihood_loss"]
    if r["step"] > int(tr.get("n_init_batches", 4)):
        loss += r["kl_loss"] * (1.0 if cfg["architecture"].get("cvae")
                                else (prev["gamma"] if prev else 0.0))
    return loss - min(r.get("loss_reg", 0.0), 1.2) * float(
        tr.get("weight_regressor", 4.0))


def check_loss_terms(what, steps, cfg):
    """Each step's loss is its terms recomposed (within 1e-2 relative), and
    the likelihood and the KL each end below their first step's value
    without ever reaching 10x it: a term that blows up fails, while the
    loss's jump where the KL joins it (gamma ~1e5 times a KL of ~1e9 from
    a random init) does not."""
    worst = max(abs(r["loss"] - recomposed_loss(r, prev, cfg))
                / max(abs(r["loss"]), 1.0)
                for r, prev in zip(steps, [None] + steps[:-1]))
    terms = {k: [r[k] for r in steps] for k in ("likelihood_loss",
                                                  "kl_loss")}
    log(f"    {what}: loss recomposed from its terms within {worst:.2e} "
        f"(relative); " + "; ".join(
            f"{k} {v[0]:.4g} -> {v[-1]:.4g} (most {max(v):.4g})"
            for k, v in terms.items()))
    check(worst <= 1e-2, f"{what}: the loss is not its terms recomposed "
                         f"({worst:.3g} relative)")
    for k, v in terms.items():
        check(v[-1] < v[0] and max(v) < 10 * v[0],
              f"{what}: {k} grew over the run: {v}")
    return dict(recomposed_rel_err=worst, **terms)


def replay_ms(fn, n=3):
    """Median ms of n calls of fn, each between two synchronizations."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def while_fetching(dataset, workers, fn):
    """fn() while ``workers`` threads fetch random items of ``dataset``
    without pause (the training loader's threads stop two batches
    ahead)."""
    stop = threading.Event()

    def fetch(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            dataset[int(rng.randint(len(dataset)))]
    threads = [threading.Thread(target=fetch, args=(i,), daemon=True)
               for i in range(workers)]
    for t in threads:
        t.start()
    try:
        return fn()
    finally:
        stop.set()
        for t in threads:
            t.join()


def image_run(what, cfg, base, make_name, sites=None):
    """Train ``cfg`` IMAGE_STEPS steps through main, resume to
    IMAGE_RESUMED_TO, run ``-m infer`` twice (the second must read the FID
    cache); check and log it all.  ``sites``: the (forward, backward)
    ELU+dropout launches each step must make.  Returns the results, with
    the ELU+dropout launches of the training steps (not of the profiled
    one) under "launches"."""
    from behavior_driven_video_synthesis_tpu_torch.data import base as dbase

    path = write_config(base, f"{what}.yaml", cfg)
    dbase.DECODES.clear()
    fetches = []                    # seconds of every item fetched
    train_set = []                  # the dataset the training run reads
    getitem = dbase.BaseDataset.__getitem__

    def timed_getitem(self, idx):
        t = time.perf_counter()
        item = getitem(self, idx)
        fetches.append(time.perf_counter() - t)
        if self.mode == "train" and not train_set:
            train_set.append(self)
        return item
    dbase.BaseDataset.__getitem__ = timed_getitem
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out, rec = recorded_main(["-c", path, "--device", "cuda"], make_name)
    finally:
        dbase.BaseDataset.__getitem__ = getitem
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = rec.steps
    B = int(cfg["training"]["batch_size"])
    check(len(steps) == IMAGE_STEPS and out["state"].step == IMAGE_STEPS,
          f"{what}: training ran {len(steps)} steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in steps), f"{what}: a training step is not finite")
    if sites is not None:
        check(all((r["fwd_launches"], r["bwd_launches"]) == sites
                  for r in steps),
              f"{what}: a step did not launch the ELU+dropout kernels "
              f"{sites} times: " + str([(r["fwd_launches"],
                                         r["bwd_launches"]) for r in steps]))
    terms = check_loss_terms(what, steps, cfg)
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    data_ms = float(np.median([r["data_ms"] for r in steps[1:]]))
    launches = [sum(r[k] for r in steps) for k in ("fwd_launches",
                                                     "bwd_launches")]
    step, state, batch, kw = rec.last
    # the last batch's step again, with the loader stopped, then while as
    # many threads as the loader's fetch items: what the fetching costs
    # the step's launch loop
    workers = int(cfg["data"].get("n_data_workers", 8))
    replay = lambda: step(state, batch, **kw)     # noqa: E731
    alone_ms = replay_ms(replay)
    fetching_ms = while_fetching(train_set[0], workers,
                                 lambda: replay_ms(replay))
    if "reg_targets" in batch:
        t = batch["reg_targets"].float()
        outside = float(((t < 0) | (t > 1)).float().mean())
        log(f"    the last batch's reg_targets span [{float(t.min()):.4f}, "
            f"{float(t.max()):.4f}], {outside:.4f} of them outside [0, 1]")
    log(f"    the last batch's step replayed: {alone_ms:.2f} ms with the "
        f"loader stopped, {fetching_ms:.2f} ms while {workers} threads "
        f"fetch items (median of 3 each; the run's median step "
        f"{step_ms:.2f} ms)")
    prof = profile_call(replay, step_ms)
    decodes = dict(dbase.DECODES)
    log(f"    {what}: {IMAGE_STEPS} steps through main in {wall:.1f} s (the "
        f"datasets' set-up included); B={B}; images decoded {decodes}")
    for r in steps:
        log(f"      step {r['step']}: loss {r['loss']:.6g}, grad_norm "
            f"{r['grad_norm']:.4g}; {r['ms']:.2f} ms; host data "
            + ("-" if r["data_ms"] is None else f"{r['data_ms']:.2f}")
            + f" ms; ELU+dropout launches {r['fwd_launches']} / "
            f"{r['bwd_launches']}")
    busy = "not measured" if prof is None else (
        f"{prof['busy_share']:.3f} of the profiled step, "
        f"{prof['device_busy_ms'] / (step_ms + data_ms):.3f} of a step with "
        f"its host data time; device {prof['device_busy_ms']:.2f} ms in "
        f"{prof['launches']} launches")
    item_ms = float(np.median(fetches)) * 1e3
    log(f"    median step after the first {step_ms:.2f} ms "
        f"({B * 1e3 / step_ms:.1f} img/s), median host data time "
        f"{data_ms:.2f} ms a step ({B * 1e3 / (step_ms + data_ms):.1f} img/s "
        f"with it; the loader runs ahead); an item takes {item_ms:.2f} ms "
        f"of host time (median of {len(fetches)}), {item_ms * B:.1f} ms a "
        f"batch on one thread of {workers}; peak {peak / 2**30:.2f} GiB; "
        f"busy share {busy}")
    rec.last = None
    del out, step, state, batch, kw

    # -r to IMAGE_RESUMED_TO
    run_cfg = os.path.join(cfg["general"]["base_dir"],
                           cfg["general"]["experiment"], "config",
                           cfg["general"]["project_name"], "config.yaml")
    dumped = load_config(run_cfg)
    dumped["training"]["end_iteration"] = IMAGE_RESUMED_TO
    with open(run_cfg, "w") as f:
        yaml.safe_dump(dumped, f)
    out, rec = recorded_main(["-c", path, "--device", "cuda", "-r"],
                             make_name)
    check([r["step"] for r in rec.steps] == list(range(
        IMAGE_STEPS + 1, IMAGE_RESUMED_TO + 1))
        and out["state"].step == IMAGE_RESUMED_TO,
        f"{what}: -r took steps {[r['step'] for r in rec.steps]}")
    log(f"    -r: restored step {IMAGE_STEPS}, ran to {IMAGE_RESUMED_TO}: "
        f"losses " + ", ".join(f"{r['loss']:.6g}" for r in rec.steps))
    launches = [n + sum(r[k] for r in rec.steps) for n, k in zip(
        launches, ("fwd_launches", "bwd_launches"))]
    del out, rec

    # -m infer, twice: the second reads the targets' Inception features
    infer_cfg = deep_merge(dumped, {"general": {"debug": True}})
    infer_path = write_config(base, f"{what}_infer.yaml", infer_cfg)
    runs = [timed_vunet_inference(infer_path) for _ in range(2)]
    want = {"ssim", "is_recon", "is_transfer", "fid"} | (
        {"loss_regressor_posthoc"} if cfg["metrics"].get(
            "posthoc_regressor", True) else set())
    for i, (summary, iwall, ms, calls, ipeak) in enumerate(runs):
        check(set(summary) == want, f"{what} -m infer summary "
                                    f"{sorted(summary)}")
        log_vunet_inference(f"-m infer {i + 1}", summary, iwall, ms, ipeak)
        log(f"      Inception forwards {calls.get('Inception forward')}")
    per_batch = [c.get("Inception forward", 0) for _, _, _, c, _ in runs]
    check(per_batch[0] * 2 == per_batch[1] * 3,
          f"{what}: the second -m infer did not read the FID cache "
          f"(Inception forwards {per_batch})")
    return dict(steps=steps, step_ms_median=step_ms, data_ms_median=data_ms,
                item_ms_median=item_ms, items_fetched=len(fetches),
                replay_alone_ms=alone_ms, replay_fetching_ms=fetching_ms,
                loss_terms=terms, launches=launches,
                img_per_s=B * 1e3 / step_ms,
                img_per_s_with_data=B * 1e3 / (step_ms + data_ms),
                peak_gib=peak / 2**30, wall_s=wall, decodes=decodes,
                profile=prof, infer=[dict(summary=r[0], wall_s=r[1],
                                          stages_ms=r[2], calls=r[3],
                                          peak_gib=r[4] / 2**30)
                                     for r in runs])


def phase_image_files():
    """cvbae on a Human3.6M tree and org-VUNet on a DeepFashion tree, as
    configs/shape_and_pose_net.yaml and configs/vunet.yaml publish them;
    returns the ELU+dropout launches of the cvbae run."""
    from behavior_driven_video_synthesis_tpu_torch.data import native

    base = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        t0 = time.perf_counter()
        h36m, deepfashion, nbytes = write_image_trees(base)
        log(f"[18] image trees written in {time.perf_counter() - t0:.1f} s: "
            f"Human3.6M {H36M_SHAPE}, DeepFashion {DF_IMAGES} x {DF_SIZE} "
            f"px; {nbytes / 2**20:.0f} MiB of JPEG")
        if native.decode_available():
            route = "native (libjpeg through data/native.py)"
        else:
            err = native.build_error() or ""
            line = next((ln for ln in err.splitlines() if "error" in ln),
                        err[:200])
            route = f"cv2 (the native library does not build: {line})"
            check("jpeglib.h" in err, "the JPEG decode library does not "
                  "build, and not for want of libjpeg's headers: " + err)
        log(f"    decoder route: {route}")
        metrics = {"compute_is": True, "compute_fid": True}
        cfg = deep_merge(train_config(os.path.join(base, "cvbae_run")), {
            "training": {"end_iteration": IMAGE_STEPS},
            "data": {"dataset": "human3.6m", "datapath": h36m},
            "metrics": metrics})
        elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
        elu_dropout.elu_dropout_bwd_launches = 0   # cvbae run on files
        per_step = (DROPOUT_SITES, DROPOUT_SITES - DEAD_BACKWARD_SITES)
        cvbae = image_run("cvbae on Human3.6M files", cfg, base,
                          "make_cvbae_train_step", sites=per_step)
        launches = tuple(cvbae["launches"])
        check(launches == tuple(n * IMAGE_RESUMED_TO for n in per_step),
              f"ELU+dropout launches of the cvbae run's steps {launches}")
        org_cfg = deep_merge(org_train_config(
            os.path.join(base, "org_run"), end_iteration=IMAGE_STEPS), {
                "data": {"dataset": "deepfashion", "datapath": deepfashion},
                "metrics": {**metrics, "posthoc_regressor": False}})
        org = image_run("org VUNet on DeepFashion files", org_cfg, base,
                        "make_org_vunet_train_step")
        for what, r in (("cvbae", cvbae), ("org", org)):
            if native.decode_available():
                check(r["decodes"].get("cv2", 0) == 0
                      and r["decodes"].get("native", 0) > 0,
                      f"{what}: decoded {r['decodes']}, not all native")
        train = RESULTS.get("train", {})
        synthetic = train.get("profile") or {}
        nan = float("nan")
        log(f"    beside phase [7]'s synthetic cvbae step: "
            f"{train.get('step_ms_median', nan):.2f} ms, idle share "
            f"{synthetic.get('idle_share', nan):.3f} of the profiled step")
        RESULTS["image_files"] = dict(route=route, cvbae=cvbae, org=org,
                                      jpeg_mib=nbytes / 2**20)
        return launches
    finally:
        shutil.rmtree(base, ignore_errors=True)


# -- 19. the image data and metrics against the JAX package's golden ----------
def phase_image_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_image_data as TI

    with np.load(IMAGE_GOLDEN) as data:
        golden = {k: data[k] for k in data.files}
    root = tempfile.mkdtemp(prefix="chip_smoke_image_golden_")
    try:
        worst = TI.check_against_golden(golden, DEV, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    equal = worst.pop("images_equal_share")
    log(f"[19] golden image data (f32, TF32 off): worst error / tolerance "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + f" (each <= 1; images within 1 uint8 level, the augmented pose "
        f"image 4; {equal:.5f} of their values equal)")
    RESULTS["golden_image_data"] = dict(worst, images_equal_share=equal)
    check(all(v <= 1.0 for v in worst.values()),
          "the image data or metrics disagree with the golden")


# -- 20. cvbae training with the GAN branch at full width ----------------------
GAN_TRAINING = {"use_gan": True, "grad_pen": True, "gan_weight": 1.0,
                "lambda_gp": 10.0, "disc_lr": 2e-4, "disc_ndf": 64,
                "disc_layers": 3}
GAN_STEPS, GAN_RESUMED_TO = 6, 8
GAN_GOLDEN = os.path.join(ROOT, "tests", "golden",
                          "torch_port_gan_small.npz")


def gan_config(base_dir):
    """configs/shape_and_pose_net.yaml as published (256 px, B=12, nf
    32->128, bf16, regressor on) with dropout_impl pallas, 6 steps and the
    GAN branch at the JAX defaults, R1 on."""
    return deep_merge(train_config(base_dir), {
        "training": dict(GAN_TRAINING, end_iteration=GAN_STEPS)})


class GanRecorder(StepRecorder):
    """A StepRecorder that also sees the discriminator (the ``gan`` the
    step is made with): each step's change of its parameters, and on the
    first step of a run the state it starts from."""

    def __init__(self):
        super().__init__()
        self.gan, self.changed, self.first_state = None, [], None

    def make(self, *args, **kwargs):
        step = super().make(*args, **kwargs)
        self.gan = kwargs.get("gan")

        def watched(state, batch, **kw):
            before = [p.detach().clone() for p in self.gan.disc.parameters()]
            if self.first_state is None:
                self.first_state = disc_state(self.gan)
            metrics = step(state, batch, **kw)
            self.changed.append([not torch.equal(b, p.detach()) for b, p in
                                 zip(before, self.gan.disc.parameters())])
            return metrics
        return watched


def disc_state(gan):
    """The discriminator's parameters and Adam state, copied to the host."""
    return ({k: v.detach().cpu().clone()
             for k, v in gan.disc.state_dict().items()},
            copy.deepcopy({i: {k: v.cpu() if torch.is_tensor(v) else v
                               for k, v in s.items()}
                           for i, s in gan.opt.state_dict()["state"].items()}))


def same_disc_state(a, b):
    (pa, sa), (pb, sb) = a, b
    return (pa.keys() == pb.keys()
            and all(torch.equal(v, pb[k]) for k, v in pa.items())
            and sa.keys() == sb.keys()
            and all(sa[i].keys() == sb[i].keys() and all(
                torch.equal(v, sb[i][k]) if torch.is_tensor(v)
                else v == sb[i][k] for k, v in sa[i].items()) for i in sa))


def gan_recorded_main(argv):
    recorder = GanRecorder()
    made = shape_and_pose_net.make_cvbae_train_step
    shape_and_pose_net.make_cvbae_train_step = recorder.make
    try:
        out = train_cli.main(argv)
    finally:
        shape_and_pose_net.make_cvbae_train_step = made
    return out, recorder


def gan_step_shares(recorder, step_ms):
    """The discriminator's share of a step: its update (two forwards, the
    R1 double backward, Adam) and the generator's pass through it, each
    replayed alone on the last step's batch and timed with CUDA events."""
    from behavior_driven_video_synthesis_tpu_torch.models.synth_discriminators \
        import generator_gan_loss
    from behavior_driven_video_synthesis_tpu_torch.train.gan import (
        GANState, make_gan_update)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_disc_optimizer)

    _, _, batch, _ = recorder.last
    # a copy, so that the replays leave the run's discriminator as it was
    disc = copy.deepcopy(recorder.gan.disc)
    update, _ = make_gan_update(GANState(disc, make_disc_optimizer(
                                    disc, GAN_TRAINING)),
                                lambda_gp=GAN_TRAINING["lambda_gp"],
                                use_gp=True)
    real = batch["pose_img"]
    fake = (real.flip(0) * 0.5).detach()

    def generator_pass():
        x = fake.clone().requires_grad_(True)
        generator_gan_loss(disc, x).backward()
    update_ms = cuda_ms(lambda: update(real, fake), 5)
    gen_ms = cuda_ms(generator_pass, 5)
    return dict(disc_update_ms=update_ms, generator_pass_ms=gen_ms,
                share=(update_ms + gen_ms) / step_ms)


def instance_norm_bf16_gap():
    """Relative L2 of the full-width PatchGAN's logits in bf16 against the
    same weights in f32 (TF32 off) on seeded 256 px images: the gap of the
    bf16 instance norm and convs."""
    from behavior_driven_video_synthesis_tpu_torch.models.synth_discriminators \
        import PatchGANDiscriminator

    g = torch.Generator(device=DEV).manual_seed(3)
    f32 = on_device(PatchGANDiscriminator(device="meta"), g)
    bf16 = PatchGANDiscriminator(dtype=torch.bfloat16, device=DEV)
    bf16.load_state_dict(f32.state_dict())
    x = torch.rand(12, 256, 256, 3, generator=g, device=DEV) * 2 - 1
    with torch.no_grad():
        a, b = bf16(x), f32(x)
    check(tuple(b.shape) == (12, 30, 30, 1), f"PatchGAN map {tuple(b.shape)}")
    return rel_l2(a, b)


def phase_gan():
    """configs/shape_and_pose_net.yaml with the GAN branch: 6 steps, -r to
    8, -m infer; returns (the ELU+dropout launches of its steps, the run's
    directory, its synth.npz)."""
    base = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    cfg = gan_config(base)
    path = write_config(base, "gan.yaml", cfg)
    tr = cfg["training"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    elu_dropout.elu_dropout_fwd_launches = 0   # counts start here: the
    elu_dropout.elu_dropout_bwd_launches = 0   # GAN run's steps
    t0 = time.perf_counter()
    out, rec = gan_recorded_main(["-c", path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = rec.steps
    per_step = (DROPOUT_SITES, DROPOUT_SITES - DEAD_BACKWARD_SITES)
    gan_keys = ("dloss", "dloss_r", "dloss_f", "gp", "gen_gan_loss")
    check(len(steps) == GAN_STEPS and out["state"].step == GAN_STEPS,
          f"GAN run: {len(steps)} steps")
    check(all(np.isfinite(r[k]) for r in steps for k in (
        "loss", "likelihood_loss", "kl_loss", "grad_norm") + gan_keys),
        "GAN run: a step is not finite")
    check(all((r["fwd_launches"], r["bwd_launches"]) == per_step
              for r in steps),
          f"GAN run: a step did not launch the ELU+dropout kernels "
          f"{per_step} times: " + str([(r["fwd_launches"], r["bwd_launches"])
                                       for r in steps]))
    names = [n for n, _ in out["gan"].disc.named_parameters()]
    weights = [i for i, n in enumerate(names) if n.endswith("weight")]
    check(len(rec.changed) == GAN_STEPS and all(
        any(c) and all(c[i] for i in weights) for c in rec.changed),
        f"GAN run: the discriminator did not move every step "
        f"{rec.changed}")
    worst_loss = max(
        abs(r["loss"] - recomposed_loss(r, prev, cfg)
            - tr["gan_weight"] * r["gen_gan_loss"]) / max(abs(r["loss"]), 1)
        for r, prev in zip(steps, [None] + steps[:-1]))
    worst_dloss = max(abs(r["dloss"] - r["dloss_r"] - r["dloss_f"] - r["gp"])
                      / max(abs(r["dloss"]), 1) for r in steps)
    log(f"[20] cvbae with the GAN branch, {GAN_STEPS} steps at full width "
        f"through main: {wall:.1f} s; discriminator "
        f"{sum(p.numel() for p in out['gan'].disc.parameters()):,} "
        f"parameters (ndf {tr['disc_ndf']}, {tr['disc_layers']} layers, "
        f"bf16 compute), R1 with lambda {tr['lambda_gp']}")
    for r in steps:
        log(f"    step {r['step']}: loss {r['loss']:.6g} (likelihood "
            f"{r['likelihood_loss']:.6g}, kl {r['kl_loss']:.6g}, gen_gan "
            f"{r['gen_gan_loss']:.4g}); dloss {r['dloss']:.4g} = real "
            f"{r['dloss_r']:.4g} + fake {r['dloss_f']:.4g} + gp "
            f"{r['gp']:.4g}; {r['ms']:.2f} ms; launches "
            f"{r['fwd_launches']} / {r['bwd_launches']}")
    log(f"    loss = its terms + gan_weight * gen_gan_loss within "
        f"{worst_loss:.2e}, dloss = dloss_r + dloss_f + gp within "
        f"{worst_dloss:.2e} (relative)")
    check(worst_loss <= 1e-2 and worst_dloss <= 1e-2,
          "GAN run: a logged loss is not its terms recomposed")
    run_dir = os.path.join(base, "cvbae")
    with open(os.path.join(run_dir, "log", "chip_smoke",
                           "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if '"train/loss"' in ln]
    check(lines and all(np.isfinite(ln[f"train/{k}"]) for ln in lines
                        for k in gan_keys),
          f"GAN run: the metric log lacks the GAN losses: {lines[-1:]}")
    step_ms = float(np.median([r["ms"] for r in steps[1:]]))
    plain_ms = RESULTS["train"]["step_ms_median"]
    shares = gan_step_shares(rec, step_ms)
    gap = instance_norm_bf16_gap()
    B = int(tr["batch_size"])
    log(f"    on {RESULTS.get('card', 'the card')}: median step after the "
        f"first {step_ms:.2f} ms "
        f"({B * 1e3 / step_ms:.1f} img/s) against {plain_ms:.2f} ms with "
        f"use_gan false (phase [7], same config, this call): "
        f"{step_ms / plain_ms:.3f}x; the discriminator's update "
        f"{shares['disc_update_ms']:.2f} ms + the generator's pass through "
        f"it {shares['generator_pass_ms']:.2f} ms = {shares['share']:.3f} "
        f"of the step (replayed alone); peak {peak / 2**30:.2f} GiB; "
        f"bf16 PatchGAN logits within rel-L2 {gap:.2e} of f32")
    check(gap <= 5e-2, f"bf16 PatchGAN logits rel-L2 {gap:.3g} off f32")
    saved = disc_state(out["gan"])
    launches = [sum(r[k] for r in steps) for k in ("fwd_launches",
                                                     "bwd_launches")]
    del out, rec

    # -r to GAN_RESUMED_TO: the discriminator starts where it was saved
    run_cfg = os.path.join(run_dir, "config", "chip_smoke", "config.yaml")
    dumped = load_config(run_cfg)
    dumped["training"]["end_iteration"] = GAN_RESUMED_TO
    write_config(os.path.dirname(run_cfg), "config.yaml", dumped)
    out, rec = gan_recorded_main(["-c", path, "--device", "cuda", "-r"])
    check([r["step"] for r in rec.steps] == list(range(
        GAN_STEPS + 1, GAN_RESUMED_TO + 1))
        and out["state"].step == GAN_RESUMED_TO,
        f"GAN -r took steps {[r['step'] for r in rec.steps]}")
    check(rec.first_state is not None
          and same_disc_state(rec.first_state, saved),
          "GAN -r: the discriminator or its Adam state is not the saved one")
    launches = [n + sum(r[k] for r in rec.steps) for n, k in zip(
        launches, ("fwd_launches", "bwd_launches"))]
    log(f"    -r: the discriminator's parameters and Adam moments at step "
        f"{GAN_STEPS} equal those saved, bit for bit; ran to "
        f"{GAN_RESUMED_TO}: losses "
        + ", ".join(f"{r['loss']:.6g}" for r in rec.steps))
    synth = out["synth_params"]
    del out, rec

    infer_cfg = deep_merge(dumped, {"general": {"debug": True}})
    summary, iwall, ms, _, ipeak = timed_vunet_inference(
        write_config(base, "gan_infer.yaml", infer_cfg))
    log_vunet_inference("-m infer", summary, iwall, ms, ipeak)
    check(set(summary) == {"ssim", "loss_regressor_posthoc"},
          f"GAN -m infer summary {sorted(summary)}")
    RESULTS["gan"] = dict(
        steps=steps, step_ms_median=step_ms, plain_step_ms_median=plain_ms,
        img_per_s=B * 1e3 / step_ms, peak_gib=peak / 2**30, wall_s=wall,
        loss_recomposed_rel_err=worst_loss,
        dloss_recomposed_rel_err=worst_dloss, bf16_logit_rel_l2=gap,
        launches=launches, infer=dict(summary=summary, wall_s=iwall,
                                      stages_ms=ms), **shares)
    return tuple(launches), base, synth


# -- 21. the GAN step against the JAX package's golden -------------------------
def phase_gan_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_train as T
    from behavior_driven_video_synthesis_tpu_torch.train.gan import (
        GANState, build_discriminator)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_disc_optimizer)

    with np.load(GAN_GOLDEN) as data:
        g = unflatten_tree({k: data[k] for k in data.files})
    cfg = json.loads(bytes(g["config"]).decode())
    tr, arch = cfg["training"], cfg["architecture"]
    S = int(cfg["data"]["spatial_size"])
    vunet = vunet_from_config(cfg, "alter", device=DEV)
    vunet.load_state_dict(convert.vunet_alter_from_flax(
        g["params"]["vunet"]))
    reg = g["params"]["regressor"]
    n_linear = sum(1 for k in reg if k.startswith("Dense_"))
    regressor = VunetRegressor(
        reg[f"Dense_{n_linear - 1}"]["bias"].shape[0],
        latent_widths(S, n_latent_scales=int(arch["n_latent_scales"])),
        nf_max=int(arch["nf_max"]), n_linear=n_linear, device=DEV)
    regressor.load_state_dict(convert.vunet_regressor_from_flax(reg))
    disc = build_discriminator(cfg, DEV)
    disc.load_state_dict(convert.patchgan_from_flax(g["params"]["disc"]))
    vunet.train()
    step = make_cvbae_train_step(
        vunet, regressor, LaplacianPyramidFeatures(),
        make_vunet_optimizers(vunet, regressor, tr), cfg,
        gan=GANState(disc, make_disc_optimizer(disc, tr)))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in g["batch"].items()}
    B, R = batch["pose_img"].shape[0], batch["reg_imgs"].shape[1]
    noise = [torch.from_numpy(g["noise"][str(B)][str(i)]).to(DEV)
             for i in range(len(g["noise"][str(B)]))]
    state = VunetTrainState(gamma=torch.zeros((), device=DEV))
    rtols = {**T.METRIC_RTOL, **T.GAN_METRIC_RTOL}
    worst = {}
    for i in sorted(g["metrics"]):
        m = step(state, batch, eps=[noise], reg_eps=[noise] * R)
        for k, rtol in rtols.items():
            ref = float(g["metrics"][i][k])
            tol = rtol * abs(ref) + (T.LOSS_ATOL if k == "loss" else 0.0)
            err = abs(float(m[k]) - ref)
            worst[k] = max(worst.get(k, 0.0), err / tol if tol else err)
    after = flatten_tree({
        "vunet": convert.vunet_alter_to_flax(vunet.state_dict()),
        "regressor": convert.vunet_regressor_to_flax(regressor.state_dict()),
        "disc": convert.patchgan_to_flax(disc.state_dict())})
    ref_after = flatten_tree(g["after"])
    normed = T.normed_bias_keys(int(tr["disc_layers"]))
    d_params = max(float(np.abs(v - ref_after[k]).max())
                   for k, v in after.items() if k not in normed)
    d_normed = max(float(np.abs(after[k] - ref_after[k]).max())
                   for k in normed)
    logits = T.disc_logits(unflatten_tree(
        {k[5:]: v for k, v in after.items() if k.startswith("disc/")}), DEV)
    ref_logits = T.disc_logits(g["after"]["disc"], DEV)
    d_logits = float(np.abs(logits - ref_logits).max())
    log(f"[21] golden cvbae GAN step x{len(g['metrics'])} (f32, TF32 off, "
        f"R1 on): worst metric error / tolerance " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; max |param - JAX| after Adam {d_params:.2e} (<= "
        f"{T.PARAM_ATOL:g}), the biases ahead of an instance norm "
        f"{d_normed:.2e} (<= {T.normed_bias_atol():.2e}), the "
        f"discriminator's logits {d_logits:.2e} (<= {T.DISC_LOGIT_ATOL:g})")
    RESULTS["golden_gan"] = dict(err_over_tol=worst, params=d_params,
                                 normed_biases=d_normed, logits=d_logits)
    check(all(v <= 1.0 for v in worst.values())
          and d_params <= T.PARAM_ATOL
          and d_normed <= T.normed_bias_atol()
          and d_logits <= T.DISC_LOGIT_ATOL,
          "golden GAN step out of tolerance")


# -- 22. serving the bilinear VUNet and --from_dataset -------------------------
def phase_bilinear():
    """One full-width B=20, T=50 request through an alter VUNet with
    subpixel_upsampling false, timed beside the subpixel VUNet's request
    behind the same behavior net and flow; returns the rollout launches."""
    pipe, g, _ = full_width_slice()
    x = request_inputs(SLICE["B"], g)
    before = rollout.rollout_launches
    subpixel = [serve(pipe, x)[1:] for _ in range(2)]
    pipe.vunet = on_device(serving_vunet("alter", subpixel_upsampling=False),
                           torch.Generator(device=DEV).manual_seed(5))
    ups = [m for m in pipe.vunet.modules() if isinstance(m, ops_nn.Upsample)]
    bilinear = []
    for _ in range(2):
        n = rollout.rollout_launches
        out, ms, peak = serve(pipe, x)
        check(rollout.rollout_launches == n + 1,
              f"bilinear request: {rollout.rollout_launches - n} rollout "
              f"launches")
        frames = out["frames"]
        check(tuple(frames.shape) == (SLICE["B"], SLICE["T"], SLICE["S"],
                                      SLICE["S"], 3)
              and bool(torch.isfinite(frames.float()).all()),
              f"bilinear request: frames {tuple(frames.shape)}")
        bilinear.append((ms, peak))
    n_bilinear = sum(not m.subpixel for m in ups)
    check(n_bilinear > 0, "the bilinear VUNet has no bilinear upsample")
    log(f"[22] on {RESULTS.get('card', 'the card')}: bilinear VUNet "
        f"(subpixel_upsampling false: {n_bilinear} of "
        f"{len(ups)} upsamples bilinear) B={SLICE['B']}, T={SLICE['T']}: "
        f"{bilinear[1][0]:.2f} ms (warm-up {bilinear[0][0]:.2f}), peak "
        f"{bilinear[1][1] / 2**30:.2f} GiB; the subpixel VUNet's request "
        f"in this call {subpixel[1][0]:.2f} ms (warm-up "
        f"{subpixel[0][0]:.2f})")
    RESULTS["bilinear"] = dict(ms=bilinear[1][0], warmup_ms=bilinear[0][0],
                               peak_gib=bilinear[1][1] / 2**30,
                               subpixel_ms=subpixel[1][0],
                               subpixel_warmup_ms=subpixel[0][0],
                               bilinear_upsamples=n_bilinear)
    del pipe
    return rollout.rollout_launches - before


FROM_DATASET_H36M = dict(subjects=(1, 9), actions=(2, 8), n_frames=24,
                         image_hw=256)
FROM_DATASET_B = 4


def phase_from_dataset(synth_params):
    """``bdvs-generate-torch --from_dataset`` in-process behind the GAN
    run's full-width synth.npz: a behavior run trained here on a Human3.6M
    tree written by phase [18]'s writer (real appearances and cameras),
    and the same net under an h36m_synthetic data config (the synthetic
    fallback); returns the rollout launches."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_image_data as TI
    from behavior_driven_video_synthesis_tpu_torch.experiments.visualize \
        import get_synth_input

    base = tempfile.mkdtemp(prefix="chip_smoke_from_dataset_")
    try:
        cols = TI.h36m_columns(**FROM_DATASET_H36M)
        root = TI.write_h36m_tree(os.path.join(base, "h36m"), cols,
                                  TI.h36m_frames(cols, image_hw=256))
        cfg = deep_merge(load_config(BEHAVIOR_CONFIG), {
            "general": {"base_dir": os.path.join(base, "runs"),
                        "project_name": "chip_smoke"},
            "data": {"dataset": "human3.6m", "datapath": root,
                     "seq_length": [8, 9], "n_data_workers": 0},
            "architecture": {"dim_hidden_b": 64, "n_flows": 2},
            "training": {"batch_size": FROM_DATASET_B, "n_epochs": 1}})
        t0 = time.perf_counter()
        train_cli.main(["-c", write_config(base, "behavior.yaml", cfg),
                        "--device", "cuda"])
        train_s = time.perf_counter() - t0
        run = os.path.join(base, "runs", "behavior_net", "ckpt",
                           "chip_smoke")
        synthetic = os.path.join(base, "synthetic")
        os.makedirs(synthetic)
        shutil.copy(os.path.join(run, "behavior.npz"), synthetic)
        with open(os.path.join(run, "behavior.json")) as f:
            bcfg = json.load(f)
        bcfg["data"] = {"dataset": "h36m_synthetic", "seq_length": [8, 9],
                        "n_frames_per_video": 24, "n_data_workers": 0}
        with open(os.path.join(synthetic, "behavior.json"), "w") as f:
            json.dump(bcfg, f)
        launches = 0
        for what, bdir, real in (("Human3.6M files", run, True),
                                 ("h36m_synthetic", synthetic, False)):
            n = rollout.rollout_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            man = cli.main([
                "--behavior_params", os.path.join(bdir, "behavior.npz"),
                "--synth_params", synth_params, "--from_dataset",
                "--batch", str(FROM_DATASET_B), "--length", "16",
                "--device", "cuda", "--out", os.path.join(base, what)])
            ms = (time.perf_counter() - t0) * 1e3
            launches += rollout.rollout_launches - n
            check(rollout.rollout_launches == n + 1,
                  f"--from_dataset ({what}): "
                  f"{rollout.rollout_launches - n} rollout launches")
            check(len(man["videos"]) == FROM_DATASET_B,
                  f"--from_dataset ({what}): videos {man['videos']}")
            with np.load(man["request"]) as data:
                req = {k: data[k] for k in data.files}
            check(("app_img" in req) == real,
                  f"--from_dataset ({what}): app_img in the request "
                  f"{'app_img' in req}")
            # the request's arrays are the port's data path's for the same
            # items: the test split's sequences and the first frames
            loader, meta = build_sequence_data(
                {"data": bcfg["data"] if not real else cfg["data"],
                 "training": {"batch_size": FROM_DATASET_B}}, mode="test")
            ds = meta["dataset"]
            kps = ds.datadict[ds.keypoint_key][req["sample_ids"]]
            same = (np.array_equal(req["source"], kps[:, :-1])
                    and np.array_equal(req["x_start"], kps[:, 0])
                    and np.array_equal(req["norm_mean"],
                                       meta["norm_stats"].mean))
            if real:
                want = [get_synth_input(ds, i, man["spatial"])
                        for i in range(FROM_DATASET_B)]
                same = same and all(
                    np.array_equal(req[k], np.stack(a)) for k, a in zip(
                        ("app_img", "extrinsics", "intrinsics",
                         "image_size"), zip(*want)))
            check(same, f"--from_dataset ({what}): the request is not the "
                        f"data path's arrays for its items")
            log(f"[22] --from_dataset, {what}: {FROM_DATASET_B} sequences "
                f"(ids {req['sample_ids'][:, 0].tolist()}), "
                + ("real appearances and cameras" if real else
                   "the synthetic appearance and camera")
                + f", equal to the data path's arrays; {ms:.0f} ms through "
                f"the CLI in-process, 1 rollout launch")
        RESULTS["from_dataset"] = dict(behavior_train_s=train_s,
                                       launches=launches)
        log(f"    the behavior run on the tree ({FROM_DATASET_H36M}) "
            f"trained in {train_s:.1f} s")
        return launches
    finally:
        shutil.rmtree(base, ignore_errors=True)


# -- 23. the figures and videos at full width ---------------------------------
# a Human3.6M tree whose 2 subjects are each filmed doing action 2 by one
# camera and action 8 by the other, 100 frames a video: the debug subset
# (the first 100 frames of each subject and action) keeps every video
# whole, so B=64 windows of 51 frames fill (6 training batches of the 400
# frames; the test split, action 8, 3 batches)
FIGURE_H36M = dict(subjects=(1, 9), actions=(2, 8),
                   cameras=(54138969, 55011271), n_frames=100, image_hw=256)
# the files the JAX hooks name for these calls
FIGURE_RGB = ("rgb0.mp4", "rgb1.mp4")
FIGURE_PAPER = tuple(f"figures/{n}" for n in (
    "enrollment-bid0-sid0.png", "enrollment-rgb-bid0-sid0.png",
    "enrollment-overlay-bid0-sid0.png", "enrollment_vid-bid0-sid0.mp4",
    "sid_sid0/samples-sid0.png", "sid_sid0/samples-sid0.mp4",
    *(f"interp-{p}-cam{c}.{e}" for p in ("slerp", "linear")
      for c in range(2) for e in ("png", "mp4"))))
FIGURE_EPOCH = ("seq0_transfer.mp4", "seq0_samples.mp4",
                "seq1_transfer.mp4", "seq1_samples.mp4", "latent_interp.mp4",
                "eval_grid.mp4")
FIGURE_INFER = ("beta_embedding.png", "recon_error_hist.png",
                "beta_nearest_neighbours.png")
FIGURE_POSTHOC_ITERS = 5     # -m infer's probes (50 under --debug; [12])


class HookClock:
    """The wall time of each figure hook between two synchronizations,
    split into its device work (the rollouts and pipeline calls inside it,
    each between two synchronizations) and the rest (host drawing and
    encoding); counts the pipeline calls and keeps the first one's inputs
    and every call's outputs' finiteness."""

    def __init__(self):
        self.rows, self.device_s = [], 0.0
        self.pipeline_calls, self.compared, self.finite = 0, None, True
        self._patches = []

    def _sync_timed(self, fn, on_device):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            if on_device:
                self.device_s += time.perf_counter() - t0
            return out
        return timed

    def device(self, owner, name):
        self._patch(owner, name, self._sync_timed(getattr(owner, name),
                                                  True))

    def pipeline(self, compare):
        """Times BehaviorTransferPipeline.generate and reenact (which does
        not call generate); ``compare(generate, pipe, args, kwargs, out)``
        runs once, on the first generate call, outside the timing."""
        generate = BehaviorTransferPipeline.generate

        def counting(fn, compared):
            timed = self._sync_timed(fn, True)

            def counted(pipe, *a, **kw):
                out = timed(pipe, *a, **kw)
                self.pipeline_calls += 1
                self.finite &= bool(
                    torch.isfinite(out["frames"].float()).all())
                if compared and self.compared is None:
                    self.compared = compare(generate, pipe, a, kw, out)
                return out
            return counted
        self._patch(BehaviorTransferPipeline, "generate",
                    counting(generate, True))
        self._patch(BehaviorTransferPipeline, "reenact",
                    counting(BehaviorTransferPipeline.reenact, False))

    def hook(self, owner, name, what):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            d0, t0 = self.device_s, time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.rows.append((what, time.perf_counter() - t0,
                              self.device_s - d0))
            return out
        self._patch(owner, name, timed)

    def _patch(self, owner, name, fn):
        self._patches.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def uninstall(self):
        for owner, name, orig in reversed(self._patches):
            setattr(owner, name, orig)
        self._patches = []


def decoded(path, with_std=False):
    """(frames, height, width, the pixels' std with ``with_std``) of a
    video, or (None, height, width, std) of an image, as cv2 reads it;
    None if it does not decode."""
    import cv2

    if path.endswith(".png"):
        img = cv2.imread(path)
        return None if img is None else (None, *img.shape[:2],
                                         float(img.std()))
    cap = cv2.VideoCapture(path)
    n, shape, frames = 0, None, []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape
        if with_std:
            frames.append(frame)
    cap.release()
    if not n:
        return None
    return (n, *shape[:2],
            float(np.std(np.stack(frames))) if with_std else None)


def check_files(what, root, names, with_std=()):
    """Every named file under root exists and decodes; returns how each
    decodes (the pixels' std of the videos named in ``with_std``)."""
    out = {}
    for n in names:
        p = os.path.join(root, n)
        out[n] = decoded(p, n in with_std) if os.path.isfile(p) else None
        check(out[n] is not None, f"{what}: {n} is missing or does not "
                                  f"decode")
    return out


def figure_h36m_tree(base):
    """FIGURE_H36M's tree: each subject's action 2 filmed by the first
    camera, action 8 by the second; returns (root, frames)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_image_data as TI

    cols = TI.h36m_columns(**FIGURE_H36M)
    cam_a, cam_b = FIGURE_H36M["cameras"]
    keep = (((cols["camera"] == cam_a) & (cols["action"] == 2))
            | ((cols["camera"] == cam_b) & (cols["action"] == 8)))
    cols = {k: v[keep] for k, v in cols.items()}
    with ThreadPoolExecutor(8) as pool:
        jpegs = [f.result() for f in TI.h36m_frames(
            cols, image_hw=FIGURE_H36M["image_hw"],
            encode=lambda img: pool.submit(TI.encode_jpeg, img))]
    return (TI.write_h36m_tree(os.path.join(base, "h36m"), cols, jpegs),
            len(jpegs))


def first_call_rollout(generate, pipe, a, kw, out):
    """(kernel vs its plain version on the kernel's bf16 operands, kernel
    vs the pipeline without the kernel: the decoder's f32 loop) max abs
    errors of one pipeline call's rollout, in the rollout's normalized
    units (the poses unnormalized by the data's statistics)."""
    z, x_start = (pipe._tensor(v) for v in a[:2])
    T = kw["length"]
    d = pipe.behavior_model.decoder

    def normalized(world):
        flat = world.reshape(world.shape[0], T, -1)
        return ((flat - pipe.norm_mean) / pipe.norm_std)[..., pipe.dim_to_use]

    with torch.inference_mode():
        r = d.rnn
        ref = rollout.residual_lstm_rollout_plain(
            z, x_start, r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
            d.n_out.weight, d.n_out.bias, T,
            operand_dtype=torch.bfloat16).float()
    pipe.use_rollout_kernel = False
    try:
        plain = generate(pipe, *a, **kw)
    finally:
        pipe.use_rollout_kernel = True
    mine = normalized(out["poses_3d"])
    return (float((mine - ref).abs().max()),
            float((mine - normalized(plain["poses_3d"])).abs().max()))


def phase_figures(gan_base):
    """behavior_net with -v -s (phase [20]'s GAN run as the synthesis
    run) on a Human3.6M tree, then -m infer -v -s; the MT-VAE with -v,
    then -m infer -v; bdvs-data-smoke-torch in its three modes; returns
    the rollout launches."""
    from behavior_driven_video_synthesis_tpu_torch.data import smoke
    from behavior_driven_video_synthesis_tpu_torch.experiments import (
        visualize)

    base = tempfile.mkdtemp(prefix="chip_smoke_figures_")
    clock = HookClock()
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        root, n_frames = figure_h36m_tree(base)
        tree_s = time.perf_counter() - t0
        synth = os.path.join(gan_base, "cvbae")
        spatial = int(load_config(os.path.join(
            synth, "config", "chip_smoke", "config.yaml"))["data"][
                "spatial_size"])
        exp = behavior_net.BehaviorNetExperiment
        for name in ("transfer3d_rollouts", "interpolation_rollouts",
                     "startpose_grid_rollouts", "mtvae_rollouts"):
            clock.device(visualize, name)
        clock.pipeline(first_call_rollout)
        clock.hook(exp, "_epoch_figures", "behavior -v hook (an eval)")
        clock.hook(exp, "_infer_figures", "behavior -m infer -v hook")
        clock.hook(visualize, "load_synth_params", "-s VUNet load")
        clock.hook(visualize, "visualize_mtvae", "mtvae -v hook (an epoch)")
        clock.hook(mt_vae.MTVAEExperiment, "_write_eval_strips",
                   "mtvae -m infer -v strips")
        clock.device(smoke, "project_windows")
        clock.hook(smoke, "main", "bdvs-data-smoke-torch")

        # (a) behavior_net under -v -s, then -m infer -v -s
        cfg = deep_merge(behavior_config(os.path.join(base, "runs")), {
            "data": {"dataset": "human3.6m", "datapath": root}})
        path = write_config(base, "behavior.yaml", cfg)
        zero_kernel_launches()
        rollout.rollout_launches = 0    # counts start here: (a)'s runs
        t0 = time.perf_counter()
        run = train_cli.main(["-c", path, "--device", "cuda", "--debug",
                              "-v", "-s", synth])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        del run
        gc.collect()
        saved_iters = behavior_net.DEBUG_POSTHOC_ITERS
        behavior_net.DEBUG_POSTHOC_ITERS = FIGURE_POSTHOC_ITERS
        t0 = time.perf_counter()
        try:
            summary = train_cli.main(["-c", path, "--device", "cuda",
                                      "--debug", "-m", "infer", "-v", "-s",
                                      os.path.join(synth, "ckpt",
                                                   "chip_smoke")])
        finally:
            behavior_net.DEBUG_POSTHOC_ITERS = saved_iters
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        launches = rollout.rollout_launches
        other = kernel_launches()
        check(all(np.isfinite(v) for v in summary.values()),
              "figures: a -m infer summary value is not finite")
        check(launches == clock.pipeline_calls == 3 * 5,
              f"figures: {launches} rollout kernel launches for "
              f"{clock.pipeline_calls} pipeline calls (3 RGB hooks x 5)")
        check(clock.finite, "figures: a pipeline call's frames are not "
                            "finite")
        gen = os.path.join(base, "runs", "behavior_net", "generated",
                           "debug")
        names = ([f"e{e:03d}_{n}" for e in range(2)
                  for n in FIGURE_EPOCH + FIGURE_RGB]
                 + [f"infer_{n}" for n in FIGURE_RGB]
                 + list(FIGURE_INFER) + list(FIGURE_PAPER))
        rgb = [n for n in names if n.endswith(tuple(FIGURE_RGB))]
        files = check_files("behavior figures", gen, names, with_std=rgb)
        for n in rgb:
            t, h, w, std = files[n]
            check((t, h, w) == (50, spatial, 2 * spatial) and std > 1.0,
                  f"figures: {n} is {t} frames of {h} x {w}, std "
                  f"{std:.3g}")
        pose_err, pose_err_f32 = clock.compared
        check(pose_err_f32 == pose_err_f32 and pose_err <= 1e-2,
              f"figures: the first call's rollout through the kernel "
              f"{pose_err:.3g} off its plain version (normalized)")
        arch = cfg["architecture"]
        log(f"[23] on {RESULTS.get('card', 'the card')}: behavior_net "
            f"(configs/behavior_net.yaml: B={cfg['training']['batch_size']}"
            f", T={cfg['data']['seq_length'][0]}, dim_hidden_b "
            f"{arch['dim_hidden_b']}, {arch.get('n_flows', 15)} flows, "
            f"f32) --debug -v -s <phase [20]'s GAN run, an alter VUNet at "
            f"{spatial} px> on a Human3.6M tree of "
            f"{n_frames} JPEG frames of {FIGURE_H36M['image_hw']} px "
            f"(2 subjects x 2 actions x 100 frames, 2 cameras; written in "
            f"{tree_s:.1f} s): trained in {train_s:.1f} s, -m infer "
            f"--debug -v -s in {infer_s:.1f} s (post-hoc probes "
            f"{FIGURE_POSTHOC_ITERS} iterations); {len(names)} files, all "
            f"decode; the RGB videos 50 frames of {spatial} x "
            f"{2 * spatial} (stickman | frame); {launches} rollout launches = {clock.pipeline_calls} "
            f"pipeline calls, frames finite; the first call's rollout within "
            f"{pose_err:.2e} of its plain version on bf16 operands (atol "
            f"1e-2, rtol 1e-2, as in [3]), {pose_err_f32:.2e} of the "
            f"decoder's f32 loop (use_rollout_kernel false, reported; "
            f"normalized units); other kernels' launches "
            f"{other} (the VUNet in eval)")

        # (b) the MT-VAE under -v, then -m infer -v
        mcfg = mtvae_config(os.path.join(base, "runs"),
                            training={"n_epochs": 1})
        mpath = write_config(base, "mt_vae.yaml", mcfg)
        t0 = time.perf_counter()
        train_cli.main(["-c", mpath, "--device", "cuda", "-v"])
        saved_iters = mt_vae.DEBUG_POSTHOC_ITERS
        mt_vae.DEBUG_POSTHOC_ITERS = FIGURE_POSTHOC_ITERS
        try:
            train_cli.main(["-c", mpath, "--device", "cuda", "-m", "infer",
                            "-v"])
        finally:
            mt_vae.DEBUG_POSTHOC_ITERS = saved_iters
        torch.cuda.synchronize()
        mtvae_s = time.perf_counter() - t0
        mgen = os.path.join(base, "runs", "mtvae", "generated",
                            mcfg["general"]["project_name"])
        mnames = ["e000_mtvae_seq0.mp4", "e000_mtvae_seq1.mp4",
                  "mtvae_eval_0.png", "mtvae_eval_1.png"]
        mfiles = check_files("mtvae figures", mgen, mnames)
        check(mfiles["e000_mtvae_seq0.mp4"][0]
              == mcfg["data"]["seq_length"][0] + 1 - mcfg["training"].get(
                  "n_cond", 10),
              f"figures: the MT-VAE video has {mfiles['e000_mtvae_seq0.mp4']}")
        log(f"    mtvae (configs/mt_vae.yaml, B="
            f"{mcfg['training']['batch_size']}, 1 debug epoch) -v, then -m "
            f"infer -v: {mtvae_s:.1f} s; {len(mnames)} files, all decode")

        # (c) the smoke CLI: three modes on the Human3.6M tree, one on
        # phase [18]'s DeepFashion tree
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import torch_port_image_data as TI

        df_jpegs, index = TI.index_data(DF_IMAGES, DF_SIZE, seed=31)
        df_root = TI.write_index_tree(os.path.join(base, "deepfashion"),
                                      df_jpegs, index)
        smoke_out = {}
        for what, data, mode in (
                ("h36m", {"dataset": "human3.6m", "datapath": root,
                          "spatial_size": 256}, "visualize_projection"),
                ("h36m", {"dataset": "human3.6m", "datapath": root,
                          "spatial_size": 256}, "test_synth"),
                ("h36m", {"dataset": "human3.6m", "datapath": root,
                          "spatial_size": 256}, "default"),
                ("deepfashion", {"dataset": "deepfashion",
                                 "datapath": df_root, "spatial_size": 256},
                 "test_synth")):
            spath = write_config(base, "smoke.yaml", {
                "general": {"mode": mode}, "data": data})
            out = smoke.main(["--config", spath, "--out",
                              os.path.join(base, "smoke", what),
                              "--device", "cuda"])
            check(len(out) > 0, f"smoke {what} {mode}: no output")
            check_files(f"smoke {what} {mode}", "", out)
            smoke_out[f"{what} {mode}"] = [os.path.basename(p) for p in out]
        log("    bdvs-data-smoke-torch: " + "; ".join(
            f"{k}: {len(v)} files" for k, v in smoke_out.items())
            + ", all decode")
    finally:
        clock.uninstall()
        shutil.rmtree(base, ignore_errors=True)
    by_hook = {}
    for what, wall, dev in clock.rows:
        t = by_hook.setdefault(what, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += wall
        t[2] += dev
    phase_s = time.perf_counter() - t_phase
    log(f"    phase [23] {phase_s:.1f} s; figure hooks on "
        f"{RESULTS.get('card', 'the card')}: calls, wall s (device s + "
        f"host drawing and encoding s)")
    for what, (n, wall, dev) in by_hook.items():
        log(f"      {what}: {n} x, {wall:.3f} s ({dev:.3f} + "
            f"{wall - dev:.3f})")
    RESULTS["figures"] = dict(
        phase_s=phase_s, tree_frames=n_frames, train_s=train_s,
        infer_s=infer_s,
        mtvae_s=mtvae_s, rollout_launches=launches,
        pipeline_calls=clock.pipeline_calls, pose_err=pose_err,
        pose_err_f32=pose_err_f32,
        smoke=smoke_out, hooks={k: dict(calls=n, wall_s=w, device_s=d,
                                        host_s=w - d)
                                for k, (n, w, d) in by_hook.items()})
    return launches


# -- 24. quantized, transposed and l2/ln serving at full width ----------------
# the int8 conv's sites at a 125-frame chunk of an alter request (B=20,
# T=50: 8 chunks): (frames, H, W, Cin, Cout, stride, aux Cin); the 256 px
# ones run int8 only without quant_max_hw.  The first seven are the sites
# the kernel's first version was timed at; the aux calls (du's and dd's
# residual blocks with a skip), the 32 px subpixel upsample and an 8 px
# aux call follow.
INT8_SITES = [(125, 128, 128, 64, 64, 1, 0), (125, 128, 128, 64, 128, 1, 0),
              (125, 128, 128, 64, 128, 2, 0), (125, 64, 64, 128, 128, 1, 0),
              (125, 64, 64, 128, 256, 1, 0), (125, 256, 256, 32, 32, 1, 0),
              (125, 256, 256, 32, 64, 2, 0), (125, 128, 128, 64, 64, 1, 64),
              (125, 64, 64, 128, 128, 1, 128), (125, 32, 32, 128, 512, 1, 0),
              (125, 8, 8, 128, 128, 1, 128)]
# the site whose numbers stand in the kernels line: the most frequent
# int8 conv of the tpu-serving preset (du's and dd's 128 px blocks)
INT8_HEADLINE = INT8_SITES[0]
# NVIDIA's H100 SXM data sheet: dense int8 tensor-core peak, at 700 W
INT8_TENSOR_OPS = 1979e12
QUANT_REL_L2 = 5e-2           # a quantized request's frames vs bf16
TRANSPOSE_REL_L2 = 1e-2       # the transposed upsample vs subpixel


def int8_bound_ms(B, H, W, Cin, Cout, stride, aux_cin=0):
    """(bound ms, what bounds it) of one int8 NormConv2d call: x (and aux)
    read in bf16, the bf16 output written, W_q (both parts), aw, bias,
    gamma and beta read once; 2 M N K operations at the int8 tensor-core
    peak, K = 9 (Cin + aux Cin)."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    M, K = B * Ho * Wo, 9 * (Cin + aux_cin)
    nbytes = (2 * B * H * W * (Cin + aux_cin) + 2 * M * Cout + Cout * K
              + 4 * Cout * (2 if aux_cin else 1) + 4 * Cout + 2 * 2 * Cout)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * Cout * K / INT8_TENSOR_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def int_mm_conv(x, w_q, ax, stride):
    """The library route to the same int32 sums: quantize, F.unfold (in
    bf16, which holds int8 values exactly; unfold takes no int8), the
    patches to int8, then one cuBLASLt int8 GEMM (torch._int_mm)."""
    B, H, W, Cin = x.shape
    N = w_q.shape[0]
    xq = conv_int8.quantize_act(x, ax).permute(0, 3, 1, 2)
    cols = F.unfold(xq, 3, padding=1, stride=stride)       # (B, 9C, L)
    a = cols.transpose(1, 2).reshape(-1, 9 * Cin).to(torch.int8)
    acc = torch._int_mm(a, w_q.reshape(N, 9 * Cin).t())
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return acc.reshape(B, Ho, Wo, N)


def bf16_ulp_ok(out, ref):
    """|out - ref| <= one bf16 ulp at ref, 2^(floor(log2|ref|) - 7)."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                     - 7)
    return bool(((out.float() - ref).abs() <= ulp).all())


def int8_site(site, seed):
    """The kernel against its plain version at one site, as a NormConv2d
    call makes it (bias, gamma and beta, and aux where the site has one),
    each timed, with the _int_mm route (both convs with aux) and the
    cuDNN bf16 conv of the same shape (over x and aux concatenated)."""
    B, H, W, Cin, Cout, stride, Ca = site
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = (torch.randn(B, H, W, Cin, generator=g, device=DEV) * 2).to(
        torch.bfloat16)
    w = torch.randn(Cout, Cin + Ca, 3, 3, generator=g, device=DEV)
    bias = torch.randn(Cout, generator=g, device=DEV)
    gamma = torch.randn(Cout, generator=g, device=DEV).to(torch.bfloat16)
    beta = torch.randn(Cout, generator=g, device=DEV).to(torch.bfloat16)
    w_q, aw = conv_int8.quantize_weight(w[:, :Cin])
    ax = conv_int8.act_scale(x)
    packed = conv_int8.pack_weights(w_q, aw)
    kernel_kw, plain_kw = {}, {}
    if Ca:
        aux = (torch.randn(B, H, W, Ca, generator=g, device=DEV) * 2).to(
            torch.bfloat16)
        aux_w_q, aux_aw = conv_int8.quantize_weight(w[:, Cin:])
        ax_aux = conv_int8.act_scale(aux)
        kernel_kw = dict(aux=aux, ax_aux=ax_aux,
                         aux_packed=conv_int8.pack_weights(aux_w_q, aux_aw))
        plain_kw = dict(aux=aux, ax_aux=ax_aux, aux_w_q=aux_w_q,
                        aux_aw=aux_aw)
    acc = conv_int8.conv_int8_packed(x, packed, ax, stride=stride,
                                     accumulators=True, **kernel_kw)
    out = conv_int8.conv_int8_packed(x, packed, ax, bias, stride,
                                     gamma=gamma, beta=beta, **kernel_kw)
    torch.cuda.synchronize()
    ref_acc = conv_int8.conv_int8_plain(x, w_q, aw, ax, stride=stride,
                                        accumulators=True, **plain_kw)
    pairs = list(zip(acc, ref_acc)) if Ca else [(acc, ref_acc)]
    same_acc = all(torch.equal(a, r) for a, r in pairs)
    del ref_acc, pairs
    ref = conv_int8.conv_int8_plain(x, w_q, aw, ax, bias, stride,
                                    gamma=gamma, beta=beta, **plain_kw)
    err = float((out.float() - ref.float()).abs().max())
    ulp_ok = bf16_ulp_ok(out, ref)
    check(same_acc, f"int8 conv at {site}: the int32 sums differ from the "
          "plain version's")
    check(ulp_ok, f"int8 conv at {site}: outputs beyond 1 bf16 ulp of the "
          f"plain version (max abs {err:.3e})")
    del ref, acc
    iters = 20
    ms = cuda_ms(lambda: conv_int8.conv_int8_packed(
        x, packed, ax, bias, stride, gamma=gamma, beta=beta, **kernel_kw),
        iters)
    # x's conv and bias alone, as the kernel's first version was timed
    # (its NormConv2d added aux's conv and the affine in three more passes)
    conv_ms = cuda_ms(lambda: conv_int8.conv_int8_packed(
        x, packed, ax, bias, stride), iters)
    plain_ms = cuda_ms(lambda: conv_int8.conv_int8_plain(
        x, w_q, aw, ax, bias, stride, gamma=gamma, beta=beta, **plain_kw), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lib_acc = int_mm_conv(x, w_q, ax, stride)
    torch.cuda.synchronize()
    lib_peak = torch.cuda.max_memory_allocated() - base
    lib_ref = conv_int8.conv_int8_packed(x, packed, ax, stride=stride,
                                         accumulators=True, **kernel_kw)
    lib_same = torch.equal(lib_acc, lib_ref[0] if Ca else lib_ref)
    del lib_acc, lib_ref

    def library():
        acc = int_mm_conv(x, w_q, ax, stride)
        if Ca:
            acc = (acc, int_mm_conv(aux, aux_w_q, ax_aux, stride))
        return acc
    lib_ms = cuda_ms(library, 3)
    # the bf16 route's conv: channels-last NCHW views of x (and aux)
    xc = (torch.cat([x, aux], dim=-1) if Ca else x).permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn_ms = cuda_ms(lambda: F.conv2d(xc, wb, None, stride, 1), iters)
    plan = conv_int8.conv_int8_plan(B, H, W, Cin, Cout, stride=stride,
                                    aux_cin=Ca)
    bound, bound_by = int8_bound_ms(*site)
    return dict(site=list(site), ms=ms, conv_ms=conv_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_peak_mib=lib_peak / 2**20,
                library_equal=lib_same, cudnn_bf16_ms=cudnn_ms,
                bound_ms=bound, bound_by=bound_by, max_abs_err=err,
                plan=plan)


def int8_launch_counter(vunet):
    """Forward hooks that count, independently of the kernel's wrapper,
    the int8 NormConv2d calls the VUNet runs (one launch each, aux
    included), the input heights they run at and the calls by shape
    (frames, H, W, Cin, Cout, stride, aux Cin); returns (counts,
    remove)."""
    counts = {"calls": 0, "heights": set(), "shapes": {}}

    def hook(mod, args, kwargs, out):
        x = args[0]
        aux = args[1] if len(args) > 1 else kwargs.get("aux")
        if mod.route(x) == "int8":
            counts["calls"] += 1
            counts["heights"].add(int(x.shape[1]))
            shape = tuple(x.shape) + (mod.features, mod.stride,
                                      0 if aux is None else aux.shape[-1])
            counts["shapes"][shape] = counts["shapes"].get(shape, 0) + 1
    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in vunet.modules()
             if isinstance(m, ops_nn.NormConv2d) and m.quant != "none"]
    return counts, lambda: [h.remove() for h in hooks]


def log_site_launches(counts):
    """The preset request's int8 calls by shape, each beside the
    INT8_SITES entry it matches."""
    log("    int8 calls of one --preset tpu-serving request by shape "
        "(frames, H, W, Cin, Cout, stride, aux Cin): launches")
    rows = []
    for shape, n in sorted(counts["shapes"].items(),
                           key=lambda kv: (-kv[0][1], kv[0][3:])):
        site = INT8_SITES.index(shape) if shape in INT8_SITES else None
        log(f"      {shape}: {n}" + (f"  (INT8_SITES[{site}])"
                                     if site is not None else ""))
        rows.append(dict(shape=list(shape), launches=n, site=site))
    RESULTS["int8_preset_launches_by_shape"] = rows


def preset_device_time(pipe, x, vunet_stage):
    """torch.profiler over one --preset tpu-serving generate request and
    over its transfer_cached stage alone (stage_breakdown's closure): the
    int8 kernel's summed device time and launches, and each call's
    device-busy share."""
    rows = {}
    for what, fn in (("generate", lambda: serve(pipe, x)),
                     ("transfer_cached", vunet_stage)):
        fn()
        prof = profile_call(fn, match="conv_int8_kernel")
        rows[what] = prof
        if prof is None:
            log(f"    profiled {what} (--preset tpu-serving): no device "
                f"time seen; not measured")
            continue
        log(f"    profiled {what} (--preset tpu-serving): wall "
            f"{prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms (busy share "
            f"{prof['busy_share']:.3f}), {prof['launches']} launches; the "
            f"int8 kernel {prof['match_ms']:.3f} ms in "
            f"{prof['match_count']} launches")
    RESULTS["int8_preset_profile"] = rows


def int8_ptxas():
    """Registers, spills and the dynamic shared memory plan of the int8
    kernel's instantiations, from build.log (-Xptxas -v)."""
    report = ptxas_report(build_log("conv_int8"), "conv_int8_kernel")
    for np_, (regs, st, ld) in sorted(report.items()):
        log(f"    conv_int8_kernel<{np_}> ({4 * np_} threads): {regs} "
            f"registers, spill stores {st} B, spill loads {ld} B")
    RESULTS["int8_ptxas"] = {str(k): dict(registers=v[0], spill_stores=v[1],
                                          spill_loads=v[2])
                             for k, v in report.items()}


def calibrate_request(pipe, x, what):
    """One timed calibration of the request: (ms, its own peak device
    bytes, that peak above the bytes held before it as a multiple of the
    frames' du skips, whether it ran as one call).  A one-call pass must
    stay within the pipeline's estimate, CALIBRATION_PEAK_PER_SKIP."""
    T, S = SLICE["T"], SLICE["S"]
    n = x["z"].shape[0] * T
    decided = []
    fits = pipeline_mod.calibration_fits
    pipeline_mod.calibration_fits = (
        lambda v, s: decided.append(fits(v, s)) or decided[-1])
    g = torch.Generator(device=DEV).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        scales = pipe.calibrate(
            x["z"], x["x_start"], x["app_img"], x["extrinsics"],
            x["intrinsics"], x["image_size"], length=T, generator=g)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        pipeline_mod.calibration_fits = fits
    peak = torch.cuda.max_memory_allocated()
    check(len(scales) > 0, f"{what}: no scale calibrated")
    skips = pipeline_mod.calibration_skip_bytes(
        pipe.vunet, torch.empty((n, S, S, 3), device="meta"))
    per_skip = (peak - base) / skips
    one_call = decided == [True]
    if one_call:
        check(per_skip <= pipeline_mod.CALIBRATION_PEAK_PER_SKIP,
              f"{what}: one calibration call held {per_skip:.3f}x its "
              f"frames' du skips, above the pipeline's estimate "
              f"{pipeline_mod.CALIBRATION_PEAK_PER_SKIP}")
    return ms, peak, per_skip, one_call


def quantized_request(pipe, x, what, ref_frames, static, tol):
    """A warm-up and a timed request (calibrate, then generate, for an
    int8_static VUNet), each holding its kernel launches to the hooks'
    count; the timed one's frames against ref_frames (rel-L2 <= tol) and
    its stage breakdown."""
    rows, previous = [], None
    for note in ("warm-up", "timed"):
        counts, remove = int8_launch_counter(pipe.vunet)
        before = conv_int8.conv_int8_launches
        cal_ms, cal_peak, per_skip, one_call = 0.0, 0, 0.0, None
        try:
            if static:
                cal_ms, cal_peak, per_skip, one_call = calibrate_request(
                    pipe, x, what)
            out, ms, peak = serve(pipe, x)
        finally:
            remove()
        launches = conv_int8.conv_int8_launches - before
        frames = out["frames"]
        check(frames.shape == ref_frames.shape
              and bool(torch.isfinite(frames.float()).all()),
              f"{what}: frames")
        check(launches == counts["calls"],
              f"{what}: {launches} int8 conv launches, the VUNet ran "
              f"{counts['calls']} int8 NormConv2d calls")
        rel = rel_l2(frames, ref_frames)
        check(rel <= tol, f"{what}: rel-L2 {rel:.3e} to the reference "
              f"request > {tol}")
        if previous is not None:
            check(torch.equal(frames, previous), f"{what}: two servings "
                  f"of the request differ (rel-L2 "
                  f"{rel_l2(frames, previous):.3e})")
        previous = frames
        B, T = SLICE["B"], SLICE["T"]
        req_ms = cal_ms + ms
        log(f"    {what:34s} {note:7s}: request {req_ms:9.2f} ms "
            f"(calibrate {cal_ms:.2f} + generate {ms:.2f}), "
            f"{B * T * 1e3 / req_ms:8.1f} frames/s, peak "
            f"{peak / 2**30:.2f} GiB generating"
            + (f", {cal_peak / 2**30:.2f} GiB calibrating "
               f"({'one call' if one_call else 'chunks'}, {per_skip:.3f}x "
               f"the frames' du skips above what it started with)"
               if static else "")
            + f", {launches} int8 launches at input heights "
            f"{sorted(counts['heights'])}; rel-L2 {rel:.3e}")
        rows.append(dict(what=what, note=note, request_ms=req_ms,
                         calibrate_ms=cal_ms, generate_ms=ms,
                         calibrate_peak_gib=cal_peak / 2**30,
                         calibrate_peak_per_skip=per_skip,
                         calibrate_one_call=one_call,
                         fps=B * T * 1e3 / req_ms, peak_gib=peak / 2**30,
                         launches=launches,
                         heights=sorted(counts["heights"]), rel_l2=rel))
    return rows, counts


def served_twice_with_plain_rollout(pipe, x):
    """C18's source: the request served twice with the rollout's plain
    version on the kernel's bf16 operands in place of the kernel, the
    VUNet unchanged.  (frames bit-equal, their rel-L2)."""
    kernel = pipeline_mod.decoder_rollout_kernel

    def plain(decoder, b, x_start, length):
        return rollout.residual_lstm_rollout_prepared_plain(
            b.float(), x_start.float(), decoder.rollout_operands(), length)
    pipeline_mod.decoder_rollout_kernel = plain
    try:
        a = serve(pipe, x)[0]["frames"]
        b = serve(pipe, x)[0]["frames"]
    finally:
        pipeline_mod.decoder_rollout_kernel = kernel
    return torch.equal(a, b), rel_l2(a, b)


def chunked_calibration_gap(pipe, x):
    """The scales of one calibration call over all B*T frames against
    those of 125-frame chunks on the same stickmen and latents, and
    against one call on another serving of the same request (0 since the
    rollout kernel sums in a fixed order): the largest relative difference
    of a scale, each."""
    args = (x["z"], x["x_start"], x["app_img"], x["extrinsics"],
            x["intrinsics"], x["image_size"])

    def calibrate():
        g = torch.Generator(device=DEV).manual_seed(1)
        return pipe.calibrate(*args, length=SLICE["T"], generator=g)

    def gap(a, b):
        check(a.keys() == b.keys(), "chunked calibration: scales")
        return max(abs(float(a[k]) - float(b[k])) / float(a[k]) for k in a)

    front, fronts = pipe._front_stages, []

    def first_front(*a):
        if not fronts:
            fronts.append(front(*a))
        return fronts[0]

    pipe._front_stages = first_front
    fits = pipeline_mod.calibration_fits
    try:
        one = calibrate()
        pipeline_mod.calibration_fits = lambda *_: False
        chunked = calibrate()
    finally:
        pipeline_mod.calibration_fits = fits
        del pipe._front_stages
    return gap(one, chunked), gap(one, calibrate())


def quant_ablation_line():
    with open(os.path.join(ROOT, "QUANT_ABLATION.json")) as f:
        q = json.load(f)
    return ", ".join(f"{k} {v['rel_l2_vs_f32']}"
                     for k, v in q["paths"].items())


def phase_quant_serving():
    """Phase [24] (a)-(c); returns (conv_int8 kernel entry, int8 launches
    of the requests and the CLI, rollout launches)."""
    log(f"[24] on {RESULTS.get('card', 'the card')}: the int8 conv kernel "
        f"vs its plain version (int32 sums equal, outputs within 1 bf16 "
        f"ulp), timed beside the plain version, F.unfold + torch._int_mm "
        f"(library) and the cuDNN bf16 conv")
    int8_ptxas()
    sites = []
    for i, site in enumerate(INT8_SITES):
        r = int8_site(site, i)
        log(f"    {site}: kernel {r['ms']:.4f} ms (x's conv and bias alone "
            f"{r['conv_ms']:.4f}), bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} reached),"
            f" plain {r['plain_ms']:.3f} ms, _int_mm {r['library_ms']:.3f} "
            f"ms (peak {r['library_peak_mib']:.0f} MiB, sums equal: "
            f"{r['library_equal']}), cuDNN bf16 {r['cudnn_bf16_ms']:.4f} ms "
            f"({r['ms'] / r['cudnn_bf16_ms']:.2f}x); max|kernel-plain| "
            f"{r['max_abs_err']:.3e}; launch {r['plan']}")
        sites.append(r)
        torch.cuda.empty_cache()
    RESULTS["int8_sites"] = sites
    head = sites[INT8_SITES.index(INT8_HEADLINE)]

    # (b) requests at phase [4]'s alter shape
    pipe, g, _ = full_width_slice()
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    x = request_inputs(B, g)
    base_vunet = pipe.vunet
    plain_equal, plain_noise = served_twice_with_plain_rollout(pipe, x)
    log(f"    the request served twice with the rollout's plain version "
        f"(bf16 operands) and the VUNet unchanged: frames bit-equal "
        f"{plain_equal} (rel-L2 {plain_noise:.3e})")
    check(plain_equal, "the request served twice with the plain rollout "
          "gives other frames: a source of run-to-run differences besides "
          "the rollout kernel")
    first, _, _ = serve(pipe, x)
    ref, ref_ms, ref_peak = serve(pipe, x)
    # the same request twice: the rollout kernel sums in a fixed order, so
    # the frames are bit-equal
    noise = rel_l2(first["frames"], ref["frames"])
    check(torch.equal(first["frames"], ref["frames"]),
          f"the bf16 request served twice: frames differ (rel-L2 "
          f"{noise:.3e})")
    del first
    log(f"    bf16 reference request B={B} T={T}: {ref_ms:.2f} ms, "
        f"{B * T * 1e3 / ref_ms:.1f} frames/s, peak {ref_peak / 2**30:.2f} "
        f"GiB; rel-L2 to the same request served before it {noise:.3e} "
        f"(bit-equal); QUANT_ABLATION.json (TPU, a trained checkpoint, "
        f"rel-L2 vs f32, not this card's): {quant_ablation_line()}")
    RESULTS["quant_reference"] = dict(ms=ref_ms, peak_gib=ref_peak / 2**30,
                                      rel_l2_repeat=noise,
                                      plain_rollout_repeat_equal=plain_equal)
    rollout.rollout_launches = 0     # counts start here: [24]'s requests
    conv_int8.conv_int8_launches = 0
    modes = [("--preset tpu-serving", dict(quant="int8_static",
                                           quant_max_hw=128), True),
             ("--quant int8_static", dict(quant="int8_static"), True),
             ("quant int8 (dynamic)", dict(quant="int8"), False)]
    rows, stages = [], {}
    for what, kw, static in modes:
        pipe.vunet = served_copy(base_vunet, "alter", **kw)
        r, counts = quantized_request(pipe, x, what, ref["frames"], static,
                                      QUANT_REL_L2)
        rows += r
        if kw.get("quant_max_hw"):
            check(max(counts["heights"]) <= 128,
                  f"{what}: int8 at input heights {counts['heights']}")
        else:
            check(S in counts["heights"],
                  f"{what}: no int8 conv at {S} px")
        vunet_stage = stage_breakdown(pipe, x, g, "stages")
        stages[what] = RESULTS.pop("stages")
        if kw.get("quant_max_hw"):
            log_site_launches(counts)
            preset_device_time(pipe, x, vunet_stage)
        del vunet_stage
        if what == "--preset tpu-serving":
            gap, noise = chunked_calibration_gap(pipe, x)
            log(f"    calibration in 125-frame chunks vs one call over "
                f"{B * T} frames, on the same stickmen: largest relative "
                f"difference of a scale {gap:.3e} (one call vs one call on "
                f"another serving of the request: {noise:.3e})")
            check(noise == 0.0, f"calibration on another serving of the "
                  f"request: scales differ by {noise:.3e}")
            RESULTS["chunked_calibration_gap"] = gap
            RESULTS["calibration_request_gap"] = noise
    pipe.vunet = served_copy(base_vunet, "alter", upsample_transpose=True)
    for note in ("warm-up", "timed"):
        out, ms, peak = serve(pipe, x)
    check(out["frames"].shape == ref["frames"].shape
          and bool(torch.isfinite(out["frames"].float()).all()),
          "--upsample transpose: frames")
    # two servings of the request have the same stickmen now, so the two
    # upsample forms are held request against request (and, reported, on
    # this request's own stickmen)
    check(torch.equal(out["stickman"], ref["stickman"]),
          "--upsample transpose: the request's stickmen differ from the "
          "subpixel request's")
    rel_requests = rel_l2(out["frames"], ref["frames"])
    stick = out["stickman"].reshape((B * T, S, S, 3))
    rel = rel_l2(vunet_frames(pipe, pipe.vunet, x["app_img"], stick),
                 vunet_frames(pipe, base_vunet, x["app_img"], stick))
    check(rel_requests <= TRANSPOSE_REL_L2,
          f"--upsample transpose: rel-L2 {rel_requests:.3e} to the subpixel "
          f"request")
    log(f"    {'--upsample transpose':34s} timed  : request {ms:9.2f} ms, "
        f"{B * T * 1e3 / ms:8.1f} frames/s, peak {peak / 2**30:.2f} GiB; "
        f"rel-L2 to the subpixel request {rel_requests:.3e} (on its own "
        f"stickmen {rel:.3e}, reported)")
    rows.append(dict(what="--upsample transpose", note="timed",
                     request_ms=ms, fps=B * T * 1e3 / ms,
                     peak_gib=peak / 2**30, rel_l2=rel,
                     rel_l2_requests=rel_requests))
    stage_breakdown(pipe, x, g, "stages")
    stages["--upsample transpose"] = RESULTS.pop("stages")

    # the org request at phase [9]'s shape under int8_static
    org, g_org, _ = full_width_slice("org")
    xo = request_inputs(B, g_org, (S // 4, S // 4, 30))
    org_ref, _, _ = serve(org, xo)
    org_again, _, _ = serve(org, xo)
    check(torch.equal(org_ref["frames"], org_again["frames"]),
          f"the org request served twice: frames differ (rel-L2 "
          f"{rel_l2(org_again['frames'], org_ref['frames']):.3e})")
    log("    the org request served twice: frames bit-equal")
    del org_again
    org_base = org.vunet
    org.vunet = served_copy(org_base, "org", quant="int8_static")
    r, _ = quantized_request(org, xo, "org --quant int8_static",
                             org_ref["frames"], True, QUANT_REL_L2)
    rows += r
    stage_breakdown(org, xo, g_org, "stages")
    stages["org --quant int8_static"] = RESULTS.pop("stages")
    for what, st in stages.items():
        log(f"    transfer_cached stage, {what}: "
            f"{st['vunet_transfer_cached']:.2f} ms")
    RESULTS["quant_requests"] = rows
    RESULTS["quant_stages_ms"] = stages
    del org, org_ref, xo
    torch.cuda.empty_cache()

    # (c) the CLI on the slice's VUNet, written as a synth.npz
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant_cli_")
    try:
        rng = np.random.RandomState(0)
        K, HID = SLICE["K_USE"], 64
        net = init_random_(ResidualBehaviorNet(K, HID), rng)
        flow = init_random_(LatentFlow(HID, 2 * HID, n_flows=3), rng)
        convert.save_flax_npz(os.path.join(tmp, "behavior.npz"), {
            "net": convert.behavior_net_to_flax(net.state_dict()),
            "flow": convert.latent_flow_to_flax(flow.state_dict())})
        with open(os.path.join(tmp, "behavior.json"), "w") as f:
            json.dump({"architecture": {"dim_hidden_b": HID,
                                        "n_flows": 3}}, f)
        convert.save_flax_npz(os.path.join(tmp, "synth.npz"), {
            "vunet": convert.vunet_alter_to_flax(base_vunet.state_dict())})
        with open(os.path.join(tmp, "synth.json"), "w") as f:
            json.dump({"data": {"spatial_size": S}, "architecture": {
                "nf_start": SLICE["NF_START"],
                "nf_max": SLICE["NF_MAX"]}}, f)
        for flags, want in ((["--preset", "tpu-serving"],
                             ("int8_static", 128, "subpixel")),
                            (["--upsample", "transpose"],
                             ("none", 0, "transpose"))):
            before = conv_int8.conv_int8_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            man = cli.main(["--behavior_params",
                            os.path.join(tmp, "behavior.npz"),
                            "--synth_params", os.path.join(tmp, "synth.npz"),
                            "--batch", "4", "--length", "50", "--device",
                            "cuda", "--out", os.path.join(tmp, flags[1]),
                            *flags])
            wall = time.perf_counter() - t0
            n = conv_int8.conv_int8_launches - before
            got = (man["quant"], man["quant_max_hw"], man["upsample"])
            check(got == want and len(man["videos"]) == 4 and all(
                os.path.getsize(p) > 0 for p in man["videos"].values()),
                f"CLI {' '.join(flags)}: manifest {got}, videos "
                f"{man['videos']}")
            check((n > 0) == (want[0] != "none"),
                  f"CLI {' '.join(flags)}: {n} int8 conv launches")
            log(f"    CLI {' '.join(flags)}: manifest quant {got[0]}, "
                f"quant_max_hw {got[1]}, upsample {got[2]}; 4 videos of 50 "
                f"frames at {S} px in {wall:.1f} s, {n} int8 launches")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    int8_launches = conv_int8.conv_int8_launches
    rollout_launches = rollout.rollout_launches
    entry = {"name": "conv_int8", "route": "cuda",
             "source": ("behavior_driven_video_synthesis_tpu_torch/csrc/"
                        "conv_int8.cu"),
             "replaces": "behavior_driven_video_synthesis_tpu/ops/nn.py:111",
             "launches": int8_launches,
             "max_abs_err": max(r["max_abs_err"] for r in sites),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"]}
    del pipe
    torch.cuda.empty_cache()
    return entry, rollout_launches


def phase_conv_types():
    """Phase [24] (d): an l2 and an ln VUNet, each serving one alter
    request at phase [4]'s shape and training two cvbae steps at phase
    [7]'s configuration."""
    pipe, g, _ = full_width_slice()
    B, T, S = SLICE["B"], SLICE["T"], SLICE["S"]
    x = request_inputs(B, g)
    launches = 0
    for conv in ("l2", "ln"):
        pipe.vunet = on_device(serving_vunet("alter", conv_layer_type=conv),
                               torch.Generator(device=DEV).manual_seed(2))
        before = rollout.rollout_launches
        serve(pipe, x)
        out, ms, peak = serve(pipe, x)
        launches += rollout.rollout_launches - before
        check(out["frames"].shape == (B, T, S, S, 3)
              and bool(torch.isfinite(out["frames"].float()).all()),
              f"{conv} VUNet request: frames")
        base = tempfile.mkdtemp(prefix=f"chip_smoke_{conv}_")
        try:
            cfg = deep_merge(train_config(base), {
                "architecture": {"conv_layer_type": conv},
                "training": {"end_iteration": 2}})
            path = write_config(base, "config.yaml", cfg)
            recorder = StepRecorder()
            made = shape_and_pose_net.make_cvbae_train_step
            shape_and_pose_net.make_cvbae_train_step = recorder.make
            try:
                train_cli.main(["-c", path, "--device", "cuda"])
            finally:
                shape_and_pose_net.make_cvbae_train_step = made
        finally:
            shutil.rmtree(base, ignore_errors=True)
        steps = recorder.steps
        check(len(steps) == 2 and all(
            np.isfinite(r[k]) for r in steps
            for k in ("loss", "likelihood_loss", "kl_loss", "grad_norm")),
            f"{conv} cvbae training: steps {steps}")
        log(f"    conv_layer_type {conv}: request B={B} T={T} {ms:.2f} ms, "
            f"{B * T * 1e3 / ms:.1f} frames/s, peak {peak / 2**30:.2f} GiB;"
            f" 2 cvbae steps at phase [7]'s configuration: losses "
            + ", ".join(f"{r['loss']:.6g}" for r in steps)
            + "; step ms " + ", ".join(f"{r['ms']:.2f}" for r in steps))
        RESULTS[f"conv_type_{conv}"] = dict(
            request_ms=ms, fps=B * T * 1e3 / ms, peak_gib=peak / 2**30,
            steps=steps)
    del pipe
    torch.cuda.empty_cache()
    return launches


# -- 25. int8 convs of any kernel size and padding ---------------------------
# quantized NormConv2d shapes the int8 kernel does not take (it computes 3x3
# with padding 1): F.unfold + torch._int_mm on the card, at 64 px x 64
# channels of a 20-frame batch
C19_SHAPES = [(5, 2), (7, 3), (3, 0)]
C19_INPUT = (20, 64, 64, 64)


def phase_any_kernel_int8():
    log("[25] quantized NormConv2d of kernel 5x5 padding 2, 7x7 padding 3 "
        "and 3x3 padding 0 (int8, bf16) on the card: the library route "
        "(F.unfold + torch._int_mm, then the plain version's epilogue), "
        "its int32 sums equal to the plain version's, its outputs equal; "
        "no launch of the int8 kernel")
    B, H, W, C = C19_INPUT
    g = torch.Generator(device=DEV).manual_seed(25)
    rows = []
    for k, pad in C19_SHAPES:
        conv = ops_nn.NormConv2d(C, C, k, padding=pad, quant="int8",
                                 dtype=torch.bfloat16, device="meta")
        conv = on_device(conv, g)
        x = (torch.randn(B, H, W, C, generator=g, device=DEV) * 2).to(
            torch.bfloat16)
        calls, launches = (conv_int8.conv_int8_unfold_calls,
                           conv_int8.conv_int8_launches)
        with torch.no_grad():
            check(conv.route(x) == "int8", f"{k}x{k}: the conv does not "
                  f"quantize")
            y = conv(x)
            torch.cuda.synchronize()
            check(conv_int8.conv_int8_unfold_calls == calls + 1
                  and conv_int8.conv_int8_launches == launches,
                  f"{k}x{k} padding {pad}: not one call of the library "
                  f"route")
            w_q, aw = conv_int8.quantize_weight(conv.kernel().float())
            ax = conv_int8.act_scale(x)
            bias = conv.conv.bias.detach()
            gamma, beta = (conv.gamma.detach().reshape(-1),
                           conv.beta.detach().reshape(-1))
            kw = dict(padding=pad, gamma=gamma, beta=beta)
            sums = conv_int8.conv_int8_unfold(x, w_q, aw, ax, bias, 1,
                                              accumulators=True, **kw)
            ref_sums = conv_int8.conv_int8_plain(x, w_q, aw, ax, bias, 1,
                                                 accumulators=True, **kw)
            ref = conv_int8.conv_int8_plain(x, w_q, aw, ax, bias, 1,
                                            torch.bfloat16, **kw)
            check(torch.equal(sums, ref_sums), f"{k}x{k} padding {pad}: "
                  f"int32 sums differ from the plain version's")
            check(torch.equal(y, ref), f"{k}x{k} padding {pad}: outputs "
                  f"differ from the plain version's (max "
                  f"{float((y.float() - ref.float()).abs().max()):.3e})")
            route_ms = cuda_ms(lambda: conv(x), 5)
            plain_ms = cuda_ms(lambda: conv_int8.conv_int8_plain(
                x, w_q, aw, ax, bias, 1, torch.bfloat16, **kw), 2)
            wb = conv.kernel().to(torch.bfloat16)
            cudnn_ms = cuda_ms(lambda: ops_nn.conv2d_nhwc(
                x, wb, bias.to(torch.bfloat16), 1, pad), 5)
        log(f"    {k}x{k} padding {pad} at {C19_INPUT} -> {C}: output "
            f"{tuple(y.shape)}, sums and outputs equal; library route "
            f"{route_ms:.3f} ms, plain (float64 conv) {plain_ms:.3f} ms, "
            f"cuDNN bf16 conv {cudnn_ms:.4f} ms")
        rows.append(dict(kernel=k, padding=pad, input=list(C19_INPUT),
                         out_shape=list(y.shape), route_ms=route_ms,
                         plain_ms=plain_ms, cudnn_bf16_ms=cudnn_ms))
        del conv, x, y, sums, ref_sums, ref
        torch.cuda.empty_cache()
    RESULTS["int8_any_kernel"] = rows


# -- 26. multi-device training on a process group of one rank -----------------
MULTI_STEPS = 3


@contextlib.contextmanager
def deterministic_algorithms():
    """Within: torch's deterministic algorithms (cuDNN's convolution
    backward among them).  Yields a list that holds, on exit, the ops that
    ran without a deterministic implementation."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    ops = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield ops
        ops.extend(sorted({str(w.message).split("\n")[0][:160]
                           for w in caught
                           if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@contextlib.contextmanager
def recording(module, name):
    """The steps that ``module.name`` (a ``make_*_train_step``) makes,
    recorded by a StepRecorder while within."""
    made = getattr(module, name)
    recorder = StepRecorder(made)
    setattr(module, name, recorder.make)
    try:
        yield recorder
    finally:
        setattr(module, name, made)


def _flat_state(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def same_checkpoints(dir_a, dir_b, what):
    """The newest saves of two runs' roles: the same step, every tensor
    and value equal; returns the largest parameter and Adam moment
    differences, over 1 + the tensor's largest magnitude."""
    (a, sa), (b, sb) = (CheckpointManager(d).restore_latest()
                        for d in (dir_a, dir_b))
    check(sa == sb, f"{what}: saves at steps {sa} and {sb}")
    fa, fb = _flat_state(a), _flat_state(b)
    check(fa.keys() == fb.keys(), f"{what}: the saves hold other keys")
    worst = {"param": 0.0, "moment": 0.0}
    for k, v in fb.items():
        u = fa[k]
        if isinstance(v, torch.Tensor):   # FSDP saves gathered on the host
            u, v = u.cpu(), v.cpu()
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and v.numel():
            scale = 1 + float(v.float().abs().max())
            d = float((u.float() - v.float()).abs().max()) / scale
            kind = "moment" if "exp_avg" in k else "param"
            check(torch.equal(u, v), f"{what}: {k} differs by {d:.3e} of "
                  f"its scale")
            worst[kind] = max(worst[kind], d)
        elif isinstance(v, torch.Tensor):
            check(torch.equal(u, v), f"{what}: {k} differs")
        else:
            check(u == v, f"{what}: {k} differs")
    return worst


def phase_multi_device():
    """Phase [26]; returns the ELU+dropout launches of its cvbae runs."""
    import torch.distributed as dist
    from behavior_driven_video_synthesis_tpu_torch.parallel import mesh
    log(f"[26] multi-device training on a process group of one rank (NCCL, "
        f"a file:// store, in this process) against the same runs without "
        f"one, {MULTI_STEPS} steps each through bdvs-train-torch's main, "
        f"both with deterministic algorithms: every checkpoint bit-equal")
    base = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    launches = [0, 0]
    # Without deterministic algorithms two runs of this cvbae config differ
    # by up to 9.7e-06 of a parameter's scale, group or none, on an H100
    # (cuDNN's convolution backward; examples/torch_multi_device_probe.py);
    # with them a group of one rank changes nothing.
    stack = contextlib.ExitStack()
    try:
        nondeterministic = stack.enter_context(deterministic_algorithms())
        runs = {}
        for grouped in (False, True):
            sub = os.path.join(base, "group" if grouped else "plain")
            cvbae = deep_merge(train_config(sub), {"training": {
                "dropout_impl": "pallas_sharded",
                "end_iteration": MULTI_STEPS}})
            behavior = deep_merge(behavior_config(sub), {
                "data": {"n_samples": MULTI_STEPS * 64},
                "architecture": {"n_flows": 3},
                "training": {"n_epochs": 1, "fsdp": True}})
            paths = {}
            for name, cfg in (("cvbae", cvbae), ("behavior", behavior)):
                paths[name] = os.path.join(sub, f"{name}.yaml")
                os.makedirs(sub, exist_ok=True)
                with open(paths[name], "w") as f:
                    yaml.safe_dump(cfg, f)
            if grouped:
                dist.init_process_group(
                    "nccl", init_method=f"file://{base}/pg", rank=0,
                    world_size=1, device_id=torch.device("cuda", 0))
            try:
                check(mesh.initialized() == grouped, "the process group")
                elu_dropout.elu_dropout_fwd_launches = 0
                elu_dropout.elu_dropout_bwd_launches = 0
                with recording(shape_and_pose_net,
                               "make_cvbae_train_step") as t:
                    train_cli.main(["-c", paths["cvbae"], "--device",
                                    "cuda"])
                fwd = elu_dropout.elu_dropout_fwd_launches
                bwd = elu_dropout.elu_dropout_bwd_launches
                check(fwd == DROPOUT_SITES * MULTI_STEPS
                      and bwd == (DROPOUT_SITES - DEAD_BACKWARD_SITES)
                      * MULTI_STEPS, f"pallas_sharded: ELU+dropout "
                      f"launches {fwd}, {bwd}")
                launches[0] += fwd
                launches[1] += bwd
                buf = io.StringIO()
                with recording(behavior_net, "make_flow_train_step") as tf, \
                        contextlib.redirect_stdout(buf):
                    out = train_cli.main(["-c", paths["behavior"], "-d",
                                          "--device", "cuda"])
                printed = buf.getvalue()
                check(out["fsdp"] == grouped, f"the flow stage's layout: "
                      f"fsdp {out['fsdp']}")
                want = ("FSDP sharding of flow params" if grouped
                        else "falling back to the replicated layout")
                check(want in printed, f"the flow stage did not say "
                      f"{want!r}")
                if grouped:    # the moments live sharded, as DTensors
                    opt = out["flow_state"].optimizer
                    sharded = [v for st in opt.state.values()
                               for v in st.values() if mesh.is_dtensor(v)]
                    check(sharded, "no flow Adam moment is sharded")
            finally:
                if grouped:
                    dist.destroy_process_group()
            runs[grouped] = dict(dir=sub,
                                 cvbae_ms=[r["ms"] for r in t.steps],
                                 flow_ms=[r["ms"] for r in tf.steps])
            torch.cuda.empty_cache()
        ck = lambda g, exp, role: os.path.join(  # noqa: E731
            runs[g]["dir"], exp, "ckpt", "chip_smoke" if exp == "cvbae"
            else "debug", role)
        d_cvbae = same_checkpoints(ck(True, "cvbae", "reg_ckpt"),
                                   ck(False, "cvbae", "reg_ckpt"),
                                   "cvbae pallas_sharded")
        d_cvae = same_checkpoints(ck(True, "behavior_net", "reg_ckpt"),
                                  ck(False, "behavior_net", "reg_ckpt"),
                                  "behavior cVAE")
        d_flow = same_checkpoints(ck(True, "behavior_net", "flow_ckpt"),
                                  ck(False, "behavior_net", "flow_ckpt"),
                                  "behavior flow (FSDP)")
        med = {g: {k: float(np.median(runs[g][k][1:]))
                   for k in ("cvbae_ms", "flow_ms")} for g in runs}
        log(f"    cvbae (256 px, B=12, pallas_sharded) step ms after the "
            f"first: without a group {med[False]['cvbae_ms']:.2f}, on the "
            f"NCCL group {med[True]['cvbae_ms']:.2f} (all-reduce of the "
            f"gradients, the KL and the metrics); parameters and moments "
            f"bit-equal; ELU+dropout launches {launches[0]} forward, "
            f"{launches[1]} backward")
        log(f"    behavior flow stage (dim_hidden_b 1024, 3 flows of mid "
            f"width 2048, B=64) step ms after the first: replicated "
            f"{med[False]['flow_ms']:.2f}, FSDP over the group "
            f"{med[True]['flow_ms']:.2f}; the cVAE's and the flow's "
            f"parameters and moments bit-equal")
        RESULTS["multi_device"] = dict(
            steps=MULTI_STEPS, step_ms=med,
            cvbae_ms={str(g): runs[g]["cvbae_ms"] for g in runs},
            flow_ms={str(g): runs[g]["flow_ms"] for g in runs},
            max_diff=dict(cvbae=d_cvbae, cvae=d_cvae, flow=d_flow))
    finally:
        stack.close()
        shutil.rmtree(base, ignore_errors=True)
    log(f"    ops without a deterministic implementation: "
        f"{nondeterministic or 'none'}")
    return tuple(launches)


# -- 27. offline Human3.6M preparation without h5py ---------------------------
def phase_prep():
    from behavior_driven_video_synthesis_tpu_torch.data.prep import process
    log("[27] offline Human3.6M preparation on this machine: synthetic "
        "views through view_annotation_rows and write_annot_export "
        "(data/h5lite.py, no h5py), read back through Human36mDataset")
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    rng = np.random.RandomState(27)
    base = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        rows = []
        for pid in (1, 5, 9):
            for act in (2, 4):
                theta = 0.1 * pid
                R = np.array([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                              [-np.sin(theta), 0, np.cos(theta)]])
                world = rng.randn(30, 32, 3) * 250 + np.array([0, 0, 2500.])
                cam = world @ R.T + np.array([120., -40., 300.])
                rows.append(process.view_annotation_rows(
                    subject_id=pid, action_id=act, subaction_id=1,
                    camera_id=54138969,
                    frame_paths=[f"S{pid}/{act}/img_{i:06d}.jpg"
                                 for i in range(30)],
                    poses_3d_univ=cam, poses_3d_world=world,
                    intrinsics=[1145.0, 512.0, 1143.0, 515.0]))
        t0 = time.perf_counter()
        out = process.write_annot_export(os.path.join(base,
                                                      "annot_export.h5"),
                                         rows)
        write_ms = (time.perf_counter() - t0) * 1e3
        saved = sys.modules.get("h5py")
        sys.modules["h5py"] = None      # the port's reader, as without h5py
        try:
            ds = Human36mDataset(None, ["keypoints", "sample_ids"], (0, 0),
                                 mode="train", datapath=base,
                                 spatial_size=64,
                                 keypoint_type="keypoints_3d_world")
        finally:
            if saved is None:
                del sys.modules["h5py"]
            else:
                sys.modules["h5py"] = saved
        world = np.concatenate([r["pose_3d_world"] for r in rows
                                if r["subject"][0] in (1, 5)])
        check(len(ds) == 2 * 2 * 30, f"prep: {len(ds)} train items")
        check(np.allclose(ds.datadict["intrinsics_univ"][0],
                          [1145.0, 512.0, 1143.0, 515.0]),
              "prep: the intrinsics read back")
        check(np.isfinite(ds[0]["keypoints"]).all(), "prep: an item")
        log(f"    h5py on this machine: {has_h5py}; 6 views of 30 frames "
            f"written in {write_ms:.1f} ms ({os.path.getsize(out):,} bytes),"
            f" read back: {len(ds)} train items (subjects 1, 5), the "
            f"intrinsics and {world.shape[0]} world poses' frames")
        RESULTS["prep"] = dict(h5py=has_h5py, write_ms=write_ms,
                               bytes=os.path.getsize(out), items=len(ds))
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch "
                                 "port on one NVIDIA GPU")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke.json"),
                    help="where to write every measured value as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    phase_s = {}

    def timed(label, fn, *a):
        """fn(*a), its wall seconds kept under ``label``."""
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[label] = round(time.perf_counter() - t0, 1)
    name = timed("1", phase_card)
    timed("2", phase_build)
    max_err, ms, plain_ms = timed("3 rollout", phase_kernel)
    elu = timed("3 elu_dropout", phase_elu_dropout)
    rnb = timed("3 fused_rnb", phase_fused_rnb)
    epilogue = timed("3 conv_epilogue", phase_conv_epilogue)
    raster = timed("3 stickman", phase_stickman)
    launches, epilogue_launches, raster_launches = timed("4", phase_slice)
    timed("5", phase_cli)
    timed("6", phase_golden)
    timed("6 org", phase_org_golden)
    elu_launches, cvbae_base, cvbae_path = timed("7", phase_train)
    timed("8", phase_train_golden)
    rnb_launches = timed("9", phase_org)
    behavior_launches, behavior_base = timed("10", phase_behavior)
    launches += behavior_launches
    try:
        timed("11", phase_behavior_golden)
        timed("12", phase_behavior_rest, behavior_base)
    finally:
        shutil.rmtree(behavior_base, ignore_errors=True)
    timed("13", phase_infer_golden)
    vunet_launches = timed("14", phase_vunet, cvbae_base, cvbae_path)
    elu_launches = tuple(a + b for a, b in zip(elu_launches, vunet_launches))
    timed("15", phase_org_train_golden)
    timed("16", phase_mtvae)
    timed("17", phase_mtvae_golden)
    image_launches = timed("18", phase_image_files)
    elu_launches = tuple(a + b for a, b in zip(elu_launches, image_launches))
    timed("19", phase_image_golden)
    gan_launches, gan_base, gan_synth = timed("20", phase_gan)
    elu_launches = tuple(a + b for a, b in zip(elu_launches, gan_launches))
    try:
        timed("21", phase_gan_golden)
        launches += timed("22 bilinear", phase_bilinear)
        launches += timed("22 from_dataset", phase_from_dataset, gan_synth)
        launches += timed("23", phase_figures, gan_base)
    finally:
        shutil.rmtree(gan_base, ignore_errors=True)
    int8_entry, quant_launches = timed("24", phase_quant_serving)
    launches += quant_launches + timed("24 conv types", phase_conv_types)
    timed("25", phase_any_kernel_int8)
    multi_launches = timed("26", phase_multi_device)
    elu_launches = tuple(a + b for a, b in zip(elu_launches, multi_launches))
    timed("27", phase_prep)
    timed("28", phase_dormant)
    log(f"    wall seconds by phase: {phase_s}; "
        f"{sum(phase_s.values()):.1f} in all")
    RESULTS["phase_s"] = phase_s
    bound, bound_by = rollout_bound_ms(*ROLLOUT_SHAPES[0])
    source = "behavior_driven_video_synthesis_tpu_torch/csrc/"
    pallas = "behavior_driven_video_synthesis_tpu/ops/pallas/"
    kernels = {"kernels": [{
        "name": "residual_lstm_rollout", "route": "cuda",
        "source": source + "rollout.cu", "replaces": pallas + "rollout.py:26",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}] + [{
            "name": f"elu_dropout_{d}", "route": "cuda",
            "source": source + "elu_dropout.cu",
            "replaces": pallas + f"elu_dropout.py:{line}",
            "launches": n, **elu[d]}
        for d, line, n in (("fwd", 83, elu_launches[0]),
                           ("bwd", 95, elu_launches[1]))] + [{
            "name": "fused_rnb", "route": "cuda",
            "source": source + "fused_rnb.cu",
            "replaces": "attic/pallas_rnb.py:86",
            "launches": rnb_launches, **rnb}, int8_entry, {
            "name": "conv_epilogue", "route": "cuda",
            "source": source + "conv_epilogue.cu",
            "replaces": "behavior_driven_video_synthesis_tpu/ops/nn.py:282",
            "launches": epilogue_launches, **epilogue}, {
            "name": "stickman_raster", "route": "cuda",
            "source": source + "stickman.cu",
            "replaces": "behavior_driven_video_synthesis_tpu/geometry/"
                        "stickman.py:190",
            "launches": raster_launches, **raster}]}
    RESULTS.update(kernels)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
