#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xclip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure:

1. require CUDA, print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``xclip_tpu_torch/ops/csrc`` with nvcc;
3. hold every kernel against its plain PyTorch version at the shapes the
   main paths give it, in fp32, bf16 and fp16, and time the kernel, the
   plain version, one library call computing the same function (the
   yardstick, used nowhere in the port) and the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak rate): K1/K2 and
   K4 at the RN50 LSO evaluation's shapes (and K4 at the training
   microbatch of 128), K3 (``matmul_stats``) at the 16
   conv1 shapes of RN50 training at batch 128; log each shape's share of
   its bound and list, before the last line, the shapes at which a kernel
   is slower than its library call; then hold the backward of
   each autograd Function (K1, K2, K3, K4) against autograd of its plain
   version at one shape per ResNet stage (and the text attention, and
   non-causal the ViT-B-32 classifier's 256 x 12 heads at L = 50), in
   fp32 and bf16, and time both backwards;
   3c. K4 non-causal at the ViT paths' shapes, in fp32, bf16 and fp16,
   against its plain version, timed with the plain version,
   ``F.scaled_dot_product_attention(is_causal=False)`` and its bound:
   the eval batches of 250 at L = 257 of ViT-L-14 and of the towers at
   head dims 80 (ViT-H-14), 88 (ViT-g-14), 104 (ViT-bigG-14) and 112
   (ViT-e-14), ViT-B-16's training microbatch of 128 at L = 197 and at the
   99 tokens patch dropout 0.5 leaves, 64 images of ViT-L-14-336 at
   L = 577, and the ViT-B-32 classifier's training batch of 256 at L = 50;
   3e. K4 at head dim 72 (ViT-SO400M-14-SigLIP: its image eval batch of
   250 at 256 tokens and a 2048-prompt chunk of its 16-token text tower),
   as 3c, and held causal against the plain version as well;
   3d. K3, K1 and K2 in bf16 at the RN50 classifier's training shapes
   (batch 256, no accumulation: M up to 802,816 rows), against the plain
   versions, timed with the plain version, the library call and the bound;
4. drive the evaluation path at full width: a seeded random RN50 saved as an
   open_clip ``.pt``, a seeded synthetic ImageNet/DomainNet tree at 224 px,
   and ``xclip_tpu_torch.evals.run_lso.main(... --precision bf16 --topk 1
   5 10)`` (86 templates x (1000 + 345) classes, image batches of 250);
   check results.json (every top-k and macro-F1 key finite, top-1 equal
   to the accuracy), and that every kernel of the path was launched by that run
   (the counts are zeroed just before it and read just after); time one
   image batch and one text chunk; 4a. hold an 8-image fp32 batch (and a
   few prompts) encoded on the card against the port on the CPU;
   4b. the same evaluation for a seeded ViT-L-14 (24 image layers, 12
   text layers, head dim 64) and a seeded ViT-bigG-14 (48 image layers at
   width 1664, head dim 104; 32 text layers at width 1280; 2.5 B
   parameters, a 10 GB ``.pt`` deleted after the phase) at full width,
   K4 only, exact counts by head dim, one image batch and one text chunk
   timed and profiled, 4 images and 4 prompts in fp32 on the card against
   the port on the CPU;
   4c. seeded image towers of ViT-H-14 (32 layers, width 1280, head dim
   80), ViT-g-14 (40, 1408, 88) and ViT-e-14 (56, 1792, 112) encode 64
   images each through K4 in bf16 and fp32, against the same tower with
   the plain attention, one launch per layer: unit-norm features within
   1e-4 in fp32 in relative norm; in bf16 within 1e-2 or 1.25 times the
   distance of a witness (the plain route with P rounded to bf16 before
   P V: the tower's own bf16 noise), whichever is larger, and each
   block's update on its real input within 1e-2;
   4d. the same evaluation as 4b for a seeded EVA02-L-14 (24 image layers
   with RoPE, SwiGLU MLPs, head dim 64; ``custom_text``: the text tower's
   keys under ``text.``) and a seeded convnext_large_d (256 px, ``mlp``
   head, LayerScale gammas seeded by ``randomize_layer_scale``; K4 only in
   its 16-layer text tower), exact K4 counts by head dim, timed and
   profiled, 4 images and 4 prompts card vs CPU in fp32 within 1e-4;
   4e. seeded towers at full width, 64 images, bf16 and fp32: EVA02-E-14's
   image tower (64 post-norm layers at width 1792, head dim 112, 4.35 B
   parameters) and ViT-SO400M-14-SigLIP's image tower (MAP pool) and text
   tower (256 seeded token ids, 16 tokens, not causal), both at head dim
   72, through K4 against the same towers with the plain attention, one
   launch per layer, held as in 4c; and convnext_xxlarge's image tower (no
   attention: its bf16 batch timed) held in fp32 against the port on the
   CPU on 2 images within 1e-4;
5. drive the training path at full width: a seeded TSV of 1,024 random
   256-px JPEGs, ``xclip_tpu_torch.train.main.main`` for RN50 at batch 128,
   accum-freq 2, ``--precision amp``, ``--grad-checkpointing``, 2 epochs,
   then ``--resume latest`` to epoch 3 (12 steps); check the losses and log
   lines, the checkpoints (``epoch_3.pt`` loads into the eval model), and
   that K1-K4 were launched and every Function's backward ran in that run
   (counts zeroed before, read after, held to the path's exact counts);
   time one steady-state step with CUDA events after two warm-up steps and
   profile one step (``torch.profiler``, top device ops);
   5b. one fp32 train step of a tiny RN config on the card against the
   same step on the CPU (loss and every gradient);
   5c. run-to-run determinism, in a child process started with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (it calls
   :func:`determinism_child`): two amp train steps of the tiny RN config
   from one seed, twice as is and twice under
   ``torch.use_deterministic_algorithms(True)``; losses, step-1 gradients
   and parameters compared bit for bit within each pair (fails if either
   pair differs);
   5d. the data-parallel code path as a 1-rank NCCL group (tcp on a free
   localhost port, initialized and destroyed by the phase): two RN50 amp
   steps (batch 128 x accum 2, seed 0, one seeded batch) without and with
   the group, losses, parameters and BatchNorm buffers compared bit for
   bit; then ``train.main`` in that group for one epoch of 2 steps on the
   first 512 rows of phase 5's TSV, with ``--val-data`` (a seeded TSV of
   256 JPEGs), ``--imagenet-val`` (a seeded tree of 1,000 wnid folders, one
   256-px JPEG each) and ``--zeroshot-frequency 1``: ``results.jsonl``
   holds every zero-shot and retrieval key, finite; K1-K4 and the
   backwards launched exactly as many times as training and evaluation
   need (the 80,000-prompt head in 40 chunks through the 12 text layers);
   rank 0 wrote ``epoch_1.pt``; the head's build time and the eval wall
   are logged beside the card;
   5e. ``train.main`` for ViT-B-16 at batch 128 x accum-freq 2, amp, grad
   checkpointing, ``--force-patch-dropout 0.5``, one epoch (4 steps) of
   phase 5's TSV: finite losses, K4 launches and backward calls exactly as
   the path needs, ``epoch_1.pt`` loads into the eval model; then one fp32
   train step of a tiny ViT (head dim 80, LayerScale) on the card against
   the CPU, as 5b does for RN;
   5f. the supervised baseline: a seeded CombinedNet tree of 256-px JPEGs
   (wnid folders from ``data/imagenet_class_index.json``, some folded into
   DomainNet classes by ``data/in_to_dn_mapping.json``, DomainNet class
   folders; 1,024 train and 256 val rows);
   ``xclip_tpu_torch.scripts.train_combined_captions.main`` for
   ``rn50-clip`` at batch 256, ``--precision 16-mixed`` (bf16), 2 epochs
   (8 steps): finite logged losses, the checkpoints ``epoch=0-step=0.npz``,
   ``epoch=1.npz``, ``epoch=2.npz`` and ``last.npz``, the last one loads,
   exact K1/K2/K3 launches and backward calls (counts zeroed before, read
   after); one steady-state step timed with CUDA events after two
   warm-ups (images/s, peak memory) and one profiled; then
   ``evaluate_domainnet_supervised_lso.main`` over the three ``epoch=*``
   files on phase 4's DomainNet tree (sketch + real, a ragged tail batch):
   ``results.json`` keys, ``steps == [0, 1, 2]``, exact K1/K2 launches,
   and 8 images' fp32 logits on the card against the port on the CPU;
   then ``vit-b-32-clip`` for one epoch (4 steps): finite losses, exact K4
   launches and backward calls, ``epoch=1.npz`` loads; one step timed and
   profiled; last, one fp32 SGD step of a tiny RN classifier on the card
   against the CPU (loss, every gradient, the BatchNorm statistics);
6. K5 and the bandwidth probe: hold ``stream_scale`` bit for bit against
   its plain version, into fresh NaN-filled buffers, at the probe's (8192,
   8192), at (1000, 1003), at lengths on the kernel's block and wave
   boundaries, on views 1, 3, 7, 8 and 16 elements into a buffer and on
   all 65,536 bf16 bit patterns; log its registers and shared memory; time
   it, the plain version and ``torch.mul`` in turns (7 rounds of 200
   launches; medians and the spread between rounds), the bytes bound and
   the wrapper's host time per call; then run
   ``xclip_tpu_torch.tools.probe_bandwidth.main`` once per launch and with
   ``--chain 10`` (counts zeroed before, read after, exact);
7. the SAE path at full width: a seeded synthetic DomainNet tree (six
   domains, 8,400 train and 600 test JPEGs), a seeded RN50 ``.pt`` with
   random BatchNorms (``randomize_bn``); K1/K2
   against plain in fp32 at every shape of the path's image batches (1024,
   the ragged 208 and 600, and 256 and 88 of the feature CLI); then
   ``xclip_tpu_torch.scripts.train_sae.main`` (features cached in fp32
   through K1/K2, then the 1024 -> 4096 SAE at batch 4096, 4 epochs,
   resampling every 2) and ``save_domainnet_features.main``, each with
   exact launch counts; check the shards, what each resample wrote (unit
   store rows in the dead decoder columns, encoder rows at 0.2x the alive
   norm, zero biases and moments, the rest untouched), the checkpoint, the
   unit-norm decoder and that every epoch without a resample lowers the
   validation loss (the first one below its value at init); hold the fp32
   image tower through the kernels against its plain route at the cache's
   batch and its ragged tail; time that tower and a steady-state SAE step
   (CUDA events over 30 steps), and profile three SAE steps;
   7b. one fp32 SAE step at full width on the card against the CPU: the
   loss, the gradients (in norm), and the parameters after a step from the
   same gradients;
8. the interpretability path at full RN50 width, fp32: a seeded
   DomainNet tree (30 classes, each a colour and stripes of its own, 2
   images each in six domains, 16 of class 0 in real and sketch), a seed-0
   RN50 whose image weights pass through the JAX layout and back with
   seeded BatchNorms, and a copy with running statistics from the tree for
   the CKA (``interp_rn50_checkpoint``);
   ``xclip_tpu_torch.scripts.compute_circuits.main`` for class 0 in real
   and in sketch (22 submodules, 21 edge pairs, steps 10, node threshold
   0.1; 16 images, the protocol's 50 cut): every stage's mean IG gradient
   finite and not all zero, K1/K2 launches and MatmulAffineAct backward
   calls exactly as the attribution's chunking gives them
   (``interp_counts``), the nodes' and edges' CUDA-event times and the peak
   memory; K1/K2 in fp32 against plain at every shape the circuits launch
   (``interp_kernel_shapes``); 2 images' node effects at all 22 stages and
   one edge pair held against the port on the CPU; ``compute_node_similarity`` and
   ``compute_circuit_similarity`` (Jaccard, WL) over the two domains;
   ``representational_analysis`` with the calibrated copy on the card and
   on the CPU (``cka_linear.json`` compared value by value); ``analyze_sae_features`` with a seeded
   1024 -> 4096 SAE and ``name_concepts`` over a written 1,000-word
   vocabulary (exact K4 launches);
9. data fabrication at DomainNet's size (index files, no images, host
   only): seeded lists of DomainNet's 586,575 rows over 345 classes (the
   LSO classes at their indices), 10,000 ImageNet-Captions entries (the
   dataset's 463,622: cut), ImageNet-Sketch's 50,889 files and 300,000
   CC3M rows (of 3.3 M: cut); the three caption generators, the seven
   ``PAPER_MIXTURES`` through ``subsample_domainnet_lso``, ``merge_ccxm``,
   ``add_in_sketches`` and ``mix_in_sketches``, each timed (rows/s); row
   counts against the reference-size rule, no LSO class left in the
   excluded domain, the identifiers;
10. RN50 training from tar shards at full width: a seeded chain of
   256-px JPEGs (DomainNet captions, ImageNet-Captions with ``.json``
   sidecars, the ``lso-cipqrs-nosketchclasses`` mixture) written as
   ``.jpg`` + ``.json`` shards with one corrupt sample; a reader pass
   skips and logs exactly that one; the trainer's first batch (one worker)
   equals the reader's first samples; the loader's host rate; then
   ``train.main --json-captions`` at batch 128 x accum 2, amp, grad
   checkpointing, local loss, gather-with-grad, 4 steps, plain and
   resampled over two ``::`` sources with ``--train-data-upsampling-factors``:
   finite losses, ``epoch_1.pt`` loads, K1-K4 and the backwards launched
   exactly as the TSV path at 4 steps;
11. the embedding analysis: ``save_domainnet_features`` over phase 7's
   tree and RN50 (fp32, exact K1/K2) and ``embedding_analysis`` on it;
   then the script at its cap on seeded 20,000 x 1024 features in six
   clusters of different density: its wall; the kNN and the layout timed
   by CUDA events, the fuzzy set and the spectral initialisation on the
   host, in a replay that must equal the script's embedding bit for bit
   (and two layouts each other); at n = 2,000 the kNN card vs CPU and the
   layout gradient along 10 epochs with equal negatives;
12. print the kernels line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package. Per-shape numbers also go
to ``build/chip_smoke_report.json`` (nvcc's register/spill report is
``build/xclip_tpu_torch/build.log``); scratch files live in
``build/chip_smoke`` and are removed at the end.
"""

from __future__ import annotations

import ast
import itertools
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, "build", "chip_smoke")
REPORT = os.path.join(REPO, "build", "chip_smoke_report.json")

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16/fp16, fp32 FMA, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| allowed: fp32 differs by summation order only; the
# 16-bit types by one rounding of the same fp32 value (1 ulp: 2^-8 relative
# for bf16, 2^-11 for fp16), so atol = rtol at about 1 ulp
TOLERANCE = {"fp32": 1e-4, "bf16": 1e-2, "fp16": 2e-3}
BATCH = 250          # evaluate_checkpoint's image batch
TRAIN_BATCH = 128    # the paper's per-GPU batch (BASELINE.md:14), one microbatch
TRAIN_ACCUM = 2      # --accum-freq
TRAIN_IMAGES = 1024  # 4 optimizer steps per epoch
TRAIN_STEPS = 12     # 2 epochs, then --resume latest to epoch 3
TRAIN_CAPTIONS = ["a photo of a cat.", "a sketch of a barn.", "a painting of a lion.", "a clipart of a pizza.",
                  "a quickdraw of a tractor.", "an infograph of a map.", "a real photo of a dog.",
                  "a drawing of a house."]
# K3's fp32 column sums vs the plain version's: same fp32 values, another
# summation order, so within 1e-4 of the vector's largest element
STATS_TOL = 1e-4
# K1/K2/K3 shapes with K at or above this are summed apart ("deep_k"): the
# late layers, where the tensor cores and not the bytes set the pace
DEEP_K = 512
# backward of a Function vs autograd of its plain version, per gradient
# tensor as ||got - ref|| / ||ref||: fp32 differs by summation order; in
# bf16 the Function's products round their inputs and outputs to bf16 as
# the JAX backward does while the plain version's run in fp32 (a few bf16
# ulps). A norm, not the largest element: K2's relu mask comes from the
# kernel's rounded output, so at the few of 10^8 pre-activations that lie
# within rounding of 0 it may differ from the plain mask by a whole
# cotangent element.
BACKWARD_TOL = {"fp32": 1e-4, "bf16": 1e-2}
TRAIN_CHECK_TOL = 1e-3  # phase 5b: card vs CPU, fp32, per gradient tensor
K5_ROUNDS, K5_LAUNCHES = 7, 200  # phase 6: K5, plain and torch.mul timed in turns
TEXT_CHUNK = 2048    # OpenAIZeroShotClassifier's prompt chunk
N_TEMPLATES = 86
N_IMAGENET_CLASSES, N_DOMAINNET_CLASSES = 1000, 345
IMAGENET_WNIDS, IMAGES_PER_WNID = 10, 5
MAIN_CHECK_TOL = 1e-3
# phase 5d: the data-parallel path as a 1-rank NCCL group
DDP_STEPS = 2                # one epoch on the first DDP_STEPS * 256 rows of the training TSV
DDP_VAL_IMAGES = 256         # --val-data
DDP_IMAGENET_CLASSES = 1000  # --imagenet-val: one JPEG per wnid folder
ZERO_SHOT_TEMPLATES = 80     # OPENAI_IMAGENET_TEMPLATES of the in-training ImageNet head
# the SAE path (scripts/train_sae.py defaults: 1024 -> 4x, batch 4096, one hook point)
SAE_D, SAE_M, SAE_BATCH = 1024, 4096, 4096
SAE_TRAIN_PER_DOMAIN, SAE_TEST_PER_DOMAIN = 1400, 100  # 8,400 train: two steps per epoch
SAE_EPOCHS, SAE_RESAMPLE_FREQ, SAE_TIMED_STEPS = 4, 2, 30
SAE_CACHE_BS, SAE_FEATURES_BS = 1024, 256  # --activations_bs default; save_domainnet_features' batch
SAE_RESAMPLE_ROWS = 8192  # --resample_dataset_size: at most the 8,400 cached train rows
SAE_STEP_RTOL = 1e-5     # phase 7b: loss, card vs CPU (fp32 summation order)
SAE_PARAM_TOL = 1e-4     # phase 7b: gradients (in norm) and parameters after the step (of each tensor's scale)


# the ViT paths: phase 4b's LSO evaluations (ViT-L-14, head dim 64; ViT-bigG-14,
# head dim 104), phase 4c's towers at head dims 80, 88 and 112, phase 5e's
# training; phase 3c times K4 at their attention shapes
VIT_EVAL = "ViT-L-14"
VIT_BIGG = "ViT-bigG-14"
VIT_LSO_MODELS = (VIT_EVAL, VIT_BIGG)
VIT_TOWERS = ("ViT-H-14", "ViT-g-14", "ViT-e-14")  # head dims 80, 88, 112: image towers alone
VIT_TOWER_BATCH = 64
VIT_TRAIN = "ViT-B-16"
VIT_PATCH_DROPOUT = 0.5
VIT_336 = "ViT-L-14-336"
VIT_336_BATCH = 64
VIT_CHECK = 4  # phase 4b: images and prompts held card vs CPU in fp32
# phase 4b: fp32 card vs CPU on unit-norm features; the two differ by
# summation order only (ViT-L-14 measured 1.7e-7)
VIT_CHECK_TOL = 1e-4
# phases 4c and 4e: a tower through K4 against the same tower with the
# plain attention, ||got - ref|| / ||ref|| of the unit-norm features. In
# fp32 the routes differ by summation order. In bf16 any difference between
# two routes, even a few roundings flipped in one layer, grows through a
# deep random tower to the tower's own bf16 noise: the plain route with P
# rounded to bf16 (the witness, no kernel; ``attention_routes``) lands as
# far from the plain route as K4 does (EVA02-E-14 4.05e-2 and 4.06e-2,
# ViT-e-14 1.46e-2 both), and a K4 whose every output was the plain fp32
# result rounded once moved ViT-H-14 only from 1.02e-2 to 0.999e-2 (H100).
# So bf16 holds the features within 1e-2 or TOWER_NOISE_RATIO times the
# witness's distance, whichever is larger, and each block's update within
# BLOCK_UPDATE_TOL
VIT_TOWER_TOL = {"fp32": 1e-4, "bf16": 1e-2}
TOWER_NOISE_RATIO = 1.25
# phases 4c and 4e, bf16: each block's residual update (output - input)
# through K4 against the plain route's on the same input, ||got - ref|| /
# ||ref - input||: one block's rounding without the tower's amplification
# (7.1e-3 at most, EVA02-E-14 on an H100)
BLOCK_UPDATE_TOL = 1e-2
# phases 3e, 4d, 4e: the timm-tower families. 4d scores EVA02-L-14 (RoPE,
# head dim 64) and convnext_large_d (256 px, mlp head; no attention in the
# image tower) through run_lso; 4e runs EVA02-E-14's image tower (head dim
# 112, 64 layers, post-norm), both towers of ViT-SO400M-14-SigLIP (head dim
# 72: the image tower at 256 tokens, the text tower at 16, not causal) and
# convnext_xxlarge's image tower
TIMM_LSO_MODELS = ("EVA02-L-14", "convnext_large_d")
SIGLIP = "ViT-SO400M-14-SigLIP"
TIMM_TOWERS = ("EVA02-E-14", SIGLIP, "convnext_xxlarge")
TIMM_TEXT_BATCH = 256   # phase 4e: seeded token ids through the SigLIP text tower
CONVNEXT_CPU_CHECK = 2  # phase 4e: convnext_xxlarge images held card vs CPU in fp32 (the CPU side is slow)
# phase 5f: the supervised baseline (launchers/train-supervised.sh: global
# batch 256, 16-mixed = bf16), 1345-way RN50 and ViT-B-32 classifiers
SUP_BATCH = 256
SUP_TRAIN_ROWS, SUP_VAL_ROWS = 1024, 256  # 4 steps an epoch; one validation batch
SUP_RN_EPOCHS, SUP_VIT_EPOCHS = 2, 1
SUP_WNIDS, SUP_FOLDED, SUP_DN_CLASSES = 32, 8, 32  # the tree's 64 class folders: 16 train + 4 val images each
SUP_VIT = "ViT-B-32"
SUP_CHECK = 8           # images whose fp32 logits are held card vs CPU
SUP_CHECK_TOL = 1e-4
TOPK = (1, 5, 10)       # phase 4's LSO run also reports these


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, min_total_ms: float = 30.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(max_iters, int(min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rounds_ms(fns: dict, rounds: int, launches: int) -> dict:
    """Per name, the mean device ms of one call in each round: every round
    times ``launches`` calls of each function between CUDA events, in an
    order rotated by one from round to round, after one warm-up call each."""
    import torch

    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start.record()
            for _ in range(launches):
                fns[name]()
            end.record()
            end.synchronize()
            out[name].append(start.elapsed_time(end) / launches)
    return out


def bound(rec: dict, flops: float, nbytes: float, dtype: str) -> None:
    """Least time for the work: operations over the peak rate or bytes (each
    input read once, each output written once) over the memory rate."""
    rec["ops_ms"] = flops / PEAK_FLOPS[dtype] * 1e3
    rec["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
    rec["bound_by"] = "operations" if rec["ops_ms"] > rec["bytes_ms"] else "bytes"


def share(rec: dict) -> None:
    """The kernel's share of its bound (bound_ms / kernel_ms: 1 is the card's
    limit) and whether one library call computes the same function faster."""
    rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
    rec["slower_than_library"] = rec["kernel_ms"] > rec["library_ms"]


def shape_name(rec: dict) -> str:
    if "M" in rec:
        return f"{rec['kernel']} {rec['dtype']} M={rec['M']} K={rec['K']} C={rec['C']}"
    if "B" in rec:
        return f"{rec['kernel']} {rec['dtype']} B={rec['B']} H={rec['H']} L={rec['L']} D={rec['D']}"
    return f"{rec['kernel']} {rec['dtype']} {'x'.join(map(str, rec['shape']))}"


def slower_list(recs) -> list:
    """The timed shapes at which the kernel is slower than its library call."""
    return [f"{shape_name(r)}: {r['kernel_ms']:.4f} > {r['library_ms']:.4f} ms"
            for r in recs if r.get("slower_than_library")]


def close(got, ref, tol: float):
    """(ok, max_abs_err) for |got - ref| <= tol + tol * |ref|."""
    diff = (got.float() - ref.float()).abs()
    ok = bool(torch_all_finite(got) and (diff <= tol + tol * ref.float().abs()).all())
    return ok, float(diff.max())


def ptxas_usage(build_log: str, kernel: str) -> str:
    """What ``nvcc -Xptxas -v`` reports after "Used" (registers, barriers,
    static shared memory) for the first entry function whose name holds
    ``kernel``."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and kernel in line:
            for nxt in lines[i + 1:]:
                if "entry function" in nxt:
                    break
                if "Used" in nxt:
                    return "Used " + nxt.split("Used", 1)[1].strip()
    return "not in the build log"


def torch_all_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def block_conv_shapes(cfg, batch: int):
    """For each bottleneck of the ModifiedResNet in order, the (role, M, K,
    C, identity, relu) of its fused 1x1-conv launches for one image batch
    (the Bottleneck's eval path)."""
    blocks_ = []
    hw = cfg.image_size // 4  # stride-2 stem conv + 2x2 avgpool
    inplanes = cfg.width
    for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), cfg.layers)):
        planes = cfg.width * mult
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ohw = hw // stride
            shapes = [("conv1", batch * hw * hw, inplanes, planes, False, True)]
            if stride > 1 or inplanes != planes * 4:
                shapes.append(("downsample", batch * ohw * ohw, inplanes, planes * 4, False, False))
            shapes.append(("conv3", batch * ohw * ohw, planes, planes * 4, True, True))
            blocks_.append(shapes)
            hw, inplanes = ohw, planes * 4
    return blocks_


def fused_conv_shapes(cfg, batch: int):
    """(role, M, K, C, identity, relu) of every fused 1x1-conv launch of one
    image batch through the ModifiedResNet's eval path."""
    return [s for block in block_conv_shapes(cfg, batch) for s in block]


def phase_kernels(torch, fused_conv, flash_attention, rn50, dtypes):
    """Kernel vs plain at the main path's shapes; per-shape timings."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"fused_conv": [], "flash_attention": []}
    errs = {"K1": {}, "K2": {}, "K4": {}}

    shapes = fused_conv_shapes(rn50.vision, BATCH)
    if len(shapes) != 36:
        fail(f"expected 36 fused-conv launches per RN50 batch, derived {len(shapes)}")
    unique = {}
    for role, m, k, c, ident, relu in shapes:
        unique.setdefault((m, k, c, ident, relu), []).append(role)

    def library_maa(z, w, g, b, identity, relu):
        y = torch.matmul(z, w)
        y.mul_(g.to(y.dtype)).add_(b.to(y.dtype))
        if identity is not None:
            y.add_(identity)
        return y.relu_() if relu else y

    for dname, dt in dtypes.items():
        esize = torch.finfo(dt).bits // 8
        for (m, k, c, ident, relu), roles in unique.items():
            z = torch.randn(m, k, device="cuda", generator=gen).to(dt)
            w = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dt)
            g = torch.rand(c, device="cuda", generator=gen) + 0.5
            b = torch.randn(c, device="cuda", generator=gen) * 0.1
            idn = torch.randn(m, c, device="cuda", generator=gen).to(dt) if ident else None
            got = fused_conv.matmul_affine_act(z, w, g, b, idn, relu=relu)
            ref = fused_conv.matmul_affine_act_plain(z, w, g, b, idn, relu=relu)
            torch.cuda.synchronize()
            ok, err = close(got, ref, TOLERANCE[dname])
            kid = "K2" if ident else "K1"
            errs[kid][dname] = max(errs[kid].get(dname, 0.0), err)
            if not ok:
                fail(f"matmul_affine_act {dname} M={m} K={k} C={c} id={ident}: max_abs_err {err}")
            del got, ref
            rec = {
                "kernel": kid, "dtype": dname, "M": m, "K": k, "C": c, "identity": ident, "relu": relu,
                "roles": roles, "count_per_batch": len(roles), "max_abs_err": err,
                "kernel_ms": time_ms(lambda: fused_conv.matmul_affine_act(z, w, g, b, idn, relu=relu)),
                "plain_ms": time_ms(lambda: fused_conv.matmul_affine_act_plain(z, w, g, b, idn, relu=relu)),
                "library_ms": time_ms(lambda: library_maa(z, w, g, b, idn, relu)),
            }
            nbytes = (m * k + k * c + m * c * (2 if ident else 1)) * esize + 2 * c * 4
            bound(rec, 2.0 * m * k * c, nbytes, dname)
            share(rec)
            report["fused_conv"].append(rec)
            log(f"  {kid} {dname} M={m} K={k} C={c} id={int(ident)} relu={int(relu)} x{len(roles)}: "
                f"kernel_ms={rec['kernel_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
                f"({rec['bound_by']}) share_of_bound={rec['share_of_bound']:.3f} max_abs_err={err:.3g}")
            del z, w, g, b, idn
            torch.cuda.empty_cache()

    heads, seq, width = rn50.text.heads, rn50.text.context_length, rn50.text.width
    hd = width // heads
    n_prompts = N_TEMPLATES * (N_IMAGENET_CLASSES + N_DOMAINNET_CLASSES)
    # full chunk, the two tail chunks of the two classifiers, and the
    # training path's 128-caption microbatch
    tails = {(N_TEMPLATES * N_IMAGENET_CLASSES) % TEXT_CHUNK, (N_TEMPLATES * N_DOMAINNET_CLASSES) % TEXT_CHUNK}
    batches = sorted({TEXT_CHUNK, TRAIN_BATCH} | tails - {0}, reverse=True)
    for dname, dt in dtypes.items():
        esize = torch.finfo(dt).bits // 8
        for bsz in batches:
            q, k, v = (torch.randn(bsz, heads, seq, hd, device="cuda", generator=gen).to(dt) for _ in range(3))
            got = flash_attention.flash_attention(q, k, v, causal=True)
            ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            ok, err = close(got, ref, TOLERANCE[dname])
            errs["K4"][dname] = max(errs["K4"].get(dname, 0.0), err)
            if not ok:
                fail(f"flash_attention {dname} B={bsz}: max_abs_err {err}")
            del got, ref
            rec = {"kernel": "K4", "dtype": dname, "B": bsz, "H": heads, "L": seq, "D": hd,
                   "causal": True, "max_abs_err": err}
            if bsz == TEXT_CHUNK:
                rec["kernel_ms"] = time_ms(lambda: flash_attention.flash_attention(q, k, v, causal=True))
                rec["plain_ms"] = time_ms(lambda: flash_attention.flash_attention_plain(q, k, v, causal=True))
                rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
                pairs = seq * (seq + 1) // 2  # causal (query, key) pairs this mask keeps
                bound(rec, 4.0 * bsz * heads * pairs * hd, 4 * bsz * heads * seq * hd * esize, dname)
                share(rec)
                log(f"  K4 {dname} B={bsz} H={heads} L={seq} D={hd} causal: kernel_ms={rec['kernel_ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                    f"share_of_bound={rec['share_of_bound']:.3f} max_abs_err={err:.3g}")
            else:
                role = "tail chunk" if bsz in tails else "training microbatch"
                log(f"  K4 {dname} B={bsz} ({role}) max_abs_err={err:.3g}")
            report["flash_attention"].append(rec)
            del q, k, v
            torch.cuda.empty_cache()
    report["prompts"] = n_prompts
    return report, errs


def vit_attention_shapes(factory) -> list:
    """(role, B, H, L, D) of K4's non-causal launches on the ViT paths: the
    eval batches of ViT-L-14 and of the towers at head dims 80 (ViT-H-14),
    88 (ViT-g-14), 104 (ViT-bigG-14) and 112 (ViT-e-14), ViT-B-16's
    training microbatch at full length and at the length patch dropout
    leaves, a 336-px tower, and the ViT-B-32 classifier's training batch of
    256 at L = 50."""
    shapes = []
    for role, name, batch, dropout in (
            (f"{VIT_EVAL} eval batch", VIT_EVAL, BATCH, 0.0),
            ("ViT-H-14 eval batch (head dim 80)", "ViT-H-14", BATCH, 0.0),
            ("ViT-g-14 eval batch (head dim 88)", "ViT-g-14", BATCH, 0.0),
            (f"{VIT_BIGG} eval batch (head dim 104)", VIT_BIGG, BATCH, 0.0),
            ("ViT-e-14 eval batch (head dim 112)", "ViT-e-14", BATCH, 0.0),
            (f"{VIT_TRAIN} training microbatch", VIT_TRAIN, TRAIN_BATCH, 0.0),
            (f"{VIT_TRAIN} training microbatch, patch dropout {VIT_PATCH_DROPOUT}", VIT_TRAIN, TRAIN_BATCH,
             VIT_PATCH_DROPOUT),
            (f"{VIT_336} eval (336 px)", VIT_336, VIT_336_BATCH, 0.0),
            (f"{SUP_VIT} classifier training batch", SUP_VIT, SUP_BATCH, 0.0)):
        v = factory.get_clip_cfg(name).vision
        patches = v.grid * v.grid
        seq = 1 + (max(1, int(patches * (1.0 - dropout))) if dropout else patches)
        shapes.append((role, batch, v.heads, seq, v.width // v.heads))
    return shapes


def timm_attention_shapes(factory) -> list:
    """(role, B, H, L, D) of K4 at head dim 72: ViT-SO400M-14-SigLIP's
    image eval batch of 250 at 256 tokens (no class token) and its text
    tower over a 2048-prompt chunk at 16 tokens, both non-causal."""
    cfg = factory.get_clip_cfg(SIGLIP)
    v, t = cfg.vision, cfg.text
    return [(f"{SIGLIP} eval batch (head dim 72)", BATCH, v.heads, v.seq_len, v.width // v.heads),
            (f"{SIGLIP} text chunk (head dim 72)", TEXT_CHUNK, t.heads, t.context_length, t.width // t.heads)]


def phase_vit_attention(torch, flash_attention, factory, dtypes, shapes=None, causal_check=False):
    """K4 non-causal at the ViT paths' shapes (or ``shapes``), in fp32, bf16
    and fp16: against its plain version, timed with the plain version,
    ``F.scaled_dot_product_attention(is_causal=False)`` and its bound; with
    ``causal_check`` also held causal against the plain version."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    records, errs = [], {}
    for role, bsz, heads, seq, hd in shapes or vit_attention_shapes(factory):
        for dname, dt in dtypes.items():
            esize = torch.finfo(dt).bits // 8
            q, k, v = (torch.randn(bsz, heads, seq, hd, device="cuda", generator=gen).to(dt) for _ in range(3))
            got = flash_attention.flash_attention(q, k, v)
            ref = flash_attention.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            ok, err = close(got, ref, TOLERANCE[dname])
            errs[dname] = max(errs.get(dname, 0.0), err)
            if not ok:
                fail(f"flash_attention {dname} non-causal B={bsz} H={heads} L={seq} D={hd}: max_abs_err {err}")
            del got, ref
            if causal_check:
                c_err = close(flash_attention.flash_attention(q, k, v, causal=True),
                              flash_attention.flash_attention_plain(q, k, v, causal=True), TOLERANCE[dname])
                errs[dname] = max(errs[dname], c_err[1])
                if not c_err[0]:
                    fail(f"flash_attention {dname} causal B={bsz} H={heads} L={seq} D={hd}: max_abs_err {c_err[1]}")
            rec = {"kernel": "K4", "role": role, "dtype": dname, "B": bsz, "H": heads, "L": seq, "D": hd,
                   "causal": False, "max_abs_err": err,
                   "kernel_ms": time_ms(lambda: flash_attention.flash_attention(q, k, v)),
                   "plain_ms": time_ms(lambda: flash_attention.flash_attention_plain(q, k, v)),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=False))}
            bound(rec, 4.0 * bsz * heads * seq * seq * hd, 4 * bsz * heads * seq * hd * esize, dname)
            share(rec)
            records.append(rec)
            log(f"  K4 {dname} B={bsz} H={heads} L={seq} D={hd} non-causal ({role}): "
                f"kernel_ms={rec['kernel_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                f"share_of_bound={rec['share_of_bound']:.3f} max_abs_err={err:.3g}"
                + (f", causal {c_err[1]:.3g}" if causal_check else ""))
            del q, k, v
            torch.cuda.empty_cache()
    return records, errs


def rel_err(got, ref) -> float:
    """max |got - ref| over the largest |ref| (0 when both are 0)."""
    scale = float(ref.float().abs().max())
    diff = float((got.float() - ref.float()).abs().max())
    return diff / scale if scale > 0 else diff


def norm_rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| in fp32 (0 when both are 0)."""
    scale = float(ref.float().norm())
    diff = float((got.float() - ref.float()).norm())
    return diff / scale if scale > 0 else diff


def conv1_shapes(cfg, batch: int):
    """(M, K, C) of the 16 conv1 matmuls (K3) of one RN50 training forward."""
    return [(m, k, c) for role, m, k, c, _, _ in fused_conv_shapes(cfg, batch) if role == "conv1"]


def phase_stats_kernel(torch, fused_conv, rn50, dtypes):
    """K3 vs plain at the training path's conv1 shapes; per-shape timings."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = conv1_shapes(rn50.vision, TRAIN_BATCH)
    if len(shapes) != 16:
        fail(f"expected 16 conv1 launches per RN50 forward, derived {len(shapes)}")
    unique = {}
    for shape in shapes:
        unique[shape] = unique.get(shape, 0) + 1
    records, errs = [], {}

    def library_ms(z, w):
        y = torch.matmul(z, w)
        return y, y.sum(dim=0, dtype=torch.float32), (y * y).sum(dim=0, dtype=torch.float32)

    for dname, dt in dtypes.items():
        esize = torch.finfo(dt).bits // 8
        for (m, k, c), count in unique.items():
            z = torch.randn(m, k, device="cuda", generator=gen).to(dt)
            w = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dt)
            y, s1, s2 = fused_conv.matmul_stats(z, w)
            ry, r1, r2 = fused_conv.matmul_stats_plain(z, w)
            torch.cuda.synchronize()
            ok, err = close(y, ry, TOLERANCE[dname])
            err_s = max(rel_err(s1, r1), rel_err(s2, r2))
            errs[dname] = max(errs.get(dname, 0.0), err)
            if not ok or err_s > STATS_TOL or not (torch_all_finite(s1) and torch_all_finite(s2)):
                fail(f"matmul_stats {dname} M={m} K={k} C={c}: y max_abs_err {err}, sums rel err {err_s}")
            y2, s1b, s2b = fused_conv.matmul_stats(z, w)
            if not (torch.equal(y, y2) and torch.equal(s1, s1b) and torch.equal(s2, s2b)):
                fail(f"matmul_stats {dname} M={m} K={k} C={c}: two runs differ")
            del y, s1, s2, ry, r1, r2, y2, s1b, s2b
            rec = {"kernel": "K3", "dtype": dname, "M": m, "K": k, "C": c, "count_per_batch": count,
                   "max_abs_err": err, "sums_rel_err": err_s,
                   "kernel_ms": time_ms(lambda: fused_conv.matmul_stats(z, w)),
                   "plain_ms": time_ms(lambda: fused_conv.matmul_stats_plain(z, w)),
                   "library_ms": time_ms(lambda: library_ms(z, w))}
            bound(rec, 2.0 * m * k * c, (m * k + k * c + m * c) * esize + 2 * c * 4, dname)
            share(rec)
            records.append(rec)
            log(f"  K3 {dname} M={m} K={k} C={c} x{count}: kernel_ms={rec['kernel_ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
                f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                f"share_of_bound={rec['share_of_bound']:.3f} max_abs_err={err:.3g} sums_rel_err={err_s:.3g}")
            del z, w
            torch.cuda.empty_cache()
    return records, errs


def phase_backward(torch, fused_conv, flash_attention, rn50, vit_b32):
    """Each Function's backward vs autograd of its plain version: K3 at each
    stage's first conv1, K1 at each downsample, K2 at each stage's first
    conv3 (batch 128), K4 at the text attention of one 128-caption
    microbatch and, non-causal, at the ViT-B-32 classifier's batch of 256
    (L = 50); fp32 and bf16. Times both backwards (retain_graph, CUDA
    events)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = fused_conv_shapes(rn50.vision, TRAIN_BATCH)
    stage_firsts = [i for i, s in enumerate(shapes) if s[0] == "downsample"]  # block 0 of each stage
    heads, seq, hd = rn50.text.heads, rn50.text.context_length, rn50.text.width // rn50.text.heads
    records, errs = [], {}

    def grads_and_ms(fn, inputs):
        xs = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ct_gen = torch.Generator(device="cuda").manual_seed(7)  # the same cotangents for both versions
        cts = [torch.randn(o.shape, device="cuda", generator=ct_gen).to(o.dtype) for o in outs]
        diff = [x for x in xs if x.requires_grad]
        grads = torch.autograd.grad(outs, diff, cts, retain_graph=True)
        ms = time_ms(lambda: torch.autograd.grad(outs, diff, cts, retain_graph=True), 30, 20)
        return grads, ms

    def one(kid, fn, plain, inputs, dname, desc):
        got, ms = grads_and_ms(fn, inputs)
        ref, plain_ms = grads_and_ms(plain, inputs)
        torch.cuda.synchronize()
        err = max(norm_rel_err(a, b) for a, b in zip(got, ref))
        if err > BACKWARD_TOL[dname] or not all(torch_all_finite(a) for a in got):
            fail(f"{kid} backward {dname} {desc}: rel err {err}")
        errs.setdefault(kid, {})[dname] = max(errs.get(kid, {}).get(dname, 0.0), err)
        records.append({"kernel": kid, "dtype": dname, "shape": desc, "rel_err": err, "backward_ms": ms,
                        "plain_backward_ms": plain_ms})
        log(f"  {kid} backward {dname} {desc}: ms={ms:.4f} plain_ms={plain_ms:.4f} rel_err={err:.3g}")

    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for i in stage_firsts:
            for role, m, k, c, ident, relu in (shapes[i - 1], shapes[i], shapes[i + 1]):
                z = torch.randn(m, k, device="cuda", generator=gen).to(dt)
                w = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dt)
                desc = f"{role} M={m} K={k} C={c}"
                if role == "conv1":
                    one("K3", fused_conv.MatmulStats.apply, fused_conv.matmul_stats_plain, [z, w], dname, desc)
                else:
                    g = torch.rand(c, device="cuda", generator=gen) + 0.5
                    b = torch.randn(c, device="cuda", generator=gen) * 0.1
                    inputs = [z, w, g, b] + ([torch.randn(m, c, device="cuda", generator=gen).to(dt)] if ident else [])
                    no_id = () if ident else (None,)  # MatmulAffineAct takes identity positionally
                    fn = lambda *t, _r=relu, _n=no_id: fused_conv.MatmulAffineAct.apply(*t, *_n, _r)
                    plain = lambda *t, _r=relu: fused_conv.matmul_affine_act_plain(*t, relu=_r)
                    one("K2" if ident else "K1", fn, plain, inputs, dname, desc)
                torch.cuda.empty_cache()
        q, k_, v = (torch.randn(TRAIN_BATCH, heads, seq, hd, device="cuda", generator=gen).to(dt) for _ in range(3))
        one("K4", lambda *t: flash_attention.FlashAttention.apply(*t, True),
            lambda *t: flash_attention.flash_attention_plain(*t, causal=True), [q, k_, v], dname,
            f"B={TRAIN_BATCH} H={heads} L={seq} D={hd} causal")
        sv = vit_b32.vision  # the ViT-B-32 classifier's training batch, non-causal
        q, k_, v = (torch.randn(SUP_BATCH, sv.heads, sv.seq_len, sv.width // sv.heads, device="cuda",
                                generator=gen).to(dt) for _ in range(3))
        one("K4", lambda *t: flash_attention.FlashAttention.apply(*t, False),
            lambda *t: flash_attention.flash_attention_plain(*t, causal=False), [q, k_, v], dname,
            f"B={SUP_BATCH} H={sv.heads} L={sv.seq_len} D={sv.width // sv.heads}")
        torch.cuda.empty_cache()
    return records, errs


def make_tree(root: str, classnames, lso_class_to_idx) -> int:
    """Seeded synthetic ImageNet-val + DomainNet-val (real, sketch) tree of
    JPEGs at 224-ish px (sides 224..320, so resize and crop both act)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    n = 0

    def save(path):
        nonlocal n
        os.makedirs(os.path.dirname(path), exist_ok=True)
        h, w = rng.randint(224, 321, size=2)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(path, quality=90)
        n += 1

    for ci in range(IMAGENET_WNIDS):
        for j in range(IMAGES_PER_WNID):
            save(os.path.join(root, "imagenet", "val", f"n{ci:08d}", f"im{j}.jpg"))
    names = list(classnames)
    for cls, idx in lso_class_to_idx.items():
        names[idx] = cls
    for domain in ("real", "sketch"):
        rows = []
        for ci, cls in enumerate(names):
            cls_dir = cls.replace(" ", "_")
            save(os.path.join(root, "domainnet", domain, cls_dir, "0.jpg"))
            rows.append(f"{domain}/{cls_dir}/0.jpg\t{ci}\ta photo.")
        with open(os.path.join(root, "domainnet", f"{domain}_test.tsv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return n


def check_results(results: dict, topk=()) -> None:
    """results.json of one checkpoint on phase 4's tree; with ``topk``, every
    ``top-{k}-accuracy`` and ``f1-score`` key finite and top-1 equal to the
    accuracy."""
    acc = results["domainnet-val"]["accuracy"]
    if results["steps"] != [1] or results["domain"] != "sketch":
        fail(f"results.json steps/domain: {results['steps']} {results['domain']}")
    for key in ("sketch-lso-ood", "sketch-lso-id", "real-lso-ood", "real-lso-id",
                "sketch-lso-unweighted-id", "sketch-lso-unweighted-ood",
                "sketch-banana-ood", "real-traffic light-ood"):
        vals = acc.get(key)
        if not vals or len(vals) != 1 or not (math.isfinite(vals[0]) and 0.0 <= vals[0] <= 1.0):
            fail(f"results.json accuracy[{key!r}] = {vals}")
    total = results["imagenet-val"]["accuracy"]["total"]
    if len(total) != 1 or not (math.isfinite(total[0]) and 0.0 <= total[0] <= 1.0):
        fail(f"results.json imagenet-val total = {total}")
    if results["domainnet-val"]["num-samples"]["sketch-lso-ood"] != [15]:
        fail(f"num-samples sketch-lso-ood = {results['domainnet-val']['num-samples']['sketch-lso-ood']}")
    split_keys = [f"{d}-lso-{s}" for d in ("sketch", "real") for s in ("ood", "id")]
    for k in topk:
        for split, keys in (("imagenet-val", ["total"]), ("domainnet-val", split_keys)):
            vals = results[split].get(f"top-{k}-accuracy", {})
            if set(vals) != set(keys) or not all(len(v) == 1 and math.isfinite(v[0]) for v in vals.values()):
                fail(f"results.json {split} top-{k}-accuracy = {vals}")
    if topk:
        for split, keys in (("imagenet-val", ["total"]), ("domainnet-val", split_keys)):
            vals = results[split].get("f1-score", {})
            if set(vals) != set(keys) or not all(len(v) == 1 and math.isfinite(v[0]) for v in vals.values()):
                fail(f"results.json {split} f1-score = {vals}")
        top1 = {**results["domainnet-val"]["top-1-accuracy"], **results["imagenet-val"]["top-1-accuracy"]}
        ref = {**acc, **results["imagenet-val"]["accuracy"]}
        if any(top1[k] != ref[k] for k in top1):
            fail(f"top-1 accuracy {top1} differs from the accuracy")


def phase_main_path(torch, factory, run_lso, fused_conv, flash_attention, tokenizer_mod, classnames,
                    lso_class_to_idx):
    tree = os.path.join(SCRATCH, "tree")
    t0 = time.perf_counter()
    n_images = make_tree(tree, [f"thing {i}" for i in range(N_DOMAINNET_CLASSES)], lso_class_to_idx)
    log(f"  synthetic tree: {n_images} JPEGs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model = factory.create_model("RN50", seed=0, device="cuda")
    ckpt = os.path.join(SCRATCH, "epoch_1.pt")
    torch.save({"epoch": 1, "name": "chip_smoke", "state_dict": model.state_dict()}, ckpt)
    log(f"  RN50 seed 0 created and saved in {time.perf_counter() - t0:.1f} s")

    n_val = IMAGENET_WNIDS * IMAGES_PER_WNID
    n_dn = 2 * N_DOMAINNET_CLASSES
    image_batches = math.ceil(n_val / BATCH) + math.ceil(n_dn / BATCH)
    n_in, n_dnp = N_TEMPLATES * N_IMAGENET_CLASSES, N_TEMPLATES * N_DOMAINNET_CLASSES
    text_chunks = math.ceil(n_in / TEXT_CHUNK) + math.ceil(n_dnp / TEXT_CHUNK)

    out = os.path.join(SCRATCH, "eval")
    argv = ["--model", "RN50", "--domain", "sketch", "--ckpt_files", ckpt, "--out_path", out,
            "--imagenet_path", os.path.join(tree, "imagenet"),
            "--domainnet_path", os.path.join(tree, "domainnet"),
            "--num_workers", "8", "--precision", "bf16", "--topk", *map(str, TOPK)]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc = run_lso.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"K1": fused_conv.launches - fused_conv.launches_with_identity,
              "K2": fused_conv.launches_with_identity, "K4": flash_attention.launches}
    if rc != 0:
        fail(f"run_lso.main returned {rc}")
    with open(os.path.join(out, "results.json")) as fh:
        results = json.load(fh)
    check_results(results, TOPK)
    log(f"  top-k (k = {list(TOPK)}) and macro F1 keys present and finite; sketch-lso-id top-"
        + ", top-".join(f"{k} {results['domainnet-val'][f'top-{k}-accuracy']['sketch-lso-id'][0]:.4f}" for k in TOPK)
        + f", f1 {results['domainnet-val']['f1-score']['sketch-lso-id'][0]:.4f}")
    for f in ("val_pred.npy", "domain_pred.npy", "domain_labels.npy", "domain_ids.npy", "val_labels.npy"):
        if not os.path.exists(os.path.join(out, f)):
            fail(f"{f} not written")
    want = {"K1": 20 * image_batches, "K2": 16 * image_batches, "K4": 12 * text_chunks}
    log(f"  LSO eval (RN50, bf16, {n_val + n_dn} images, {n_in + n_dnp} prompts): wall {wall:.2f} s; "
        f"launches {counts} (expected {want})")
    if any(counts[k] == 0 for k in counts):
        fail(f"a kernel of the main path was never launched: {counts}")
    if counts != want:
        fail(f"launch counts {counts} differ from the path's {want}")

    # throughput of one image batch and one text chunk on the same model, bf16
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(BATCH, 224, 224, 3, device="cuda", generator=gen)
    ids = torch.from_numpy(tokenizer_mod.tokenize(
        [f"a photo of a {classnames[i % len(classnames)]}." for i in range(TEXT_CHUNK)])).cuda()
    with torch.inference_mode():
        img_ms = time_ms(lambda: model.encode_image(images, normalize=True, dtype=torch.bfloat16), 200, 10)
        txt_ms = time_ms(lambda: model.encode_text(ids, normalize=True, dtype=torch.bfloat16), 200, 10)
    rates = {"eval_wall_s": wall, "image_batch_ms": img_ms, "images_per_s": BATCH / img_ms * 1e3,
             "text_chunk_ms": txt_ms, "prompts_per_s": TEXT_CHUNK / txt_ms * 1e3,
             "images": n_val + n_dn, "prompts": n_in + n_dnp}
    log(f"  encode_image bf16 batch {BATCH}: {img_ms:.2f} ms ({rates['images_per_s']:.1f} img/s); "
        f"encode_text bf16 chunk {TEXT_CHUNK}: {txt_ms:.2f} ms ({rates['prompts_per_s']:.1f} prompts/s)")
    rates["device_time_by_kernel"] = profile_towers(torch, model, images, ids)
    return model, counts, rates


def profile_towers(torch, model, images, ids, top: int = 12):
    """Device time by kernel over one text chunk and one image batch (bf16),
    from torch.profiler (CUPTI); only kernel rows, not the operators that
    launched them, so nothing is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.encode_text(ids, normalize=True, dtype=torch.bfloat16)
            model.encode_image(images, normalize=True, dtype=torch.bfloat16)
            torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(f"  profiler: device time over one text chunk + one image batch: {total:.2f} ms")
    for key, ms, count in rows[:top]:
        log(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f} % x{count:<5d} {key[:110]}")
    return {"total_ms": total, "top": [{"kernel": k, "ms": ms, "count": c} for k, ms, c in rows[:top]]}


def randomize_bn(torch, sd: dict, gen) -> dict:
    """Seeded random BatchNorm scales, biases and running statistics in an
    RN50 state dict, in place: the random init zeroes bn3's scale, which
    would hide the conv1/conv3 kernels' contribution to the features."""
    for key, val in sd.items():
        if ".bn" in key or "downsample.1" in key or key.startswith("visual.bn"):
            if key.endswith(("weight", "running_var")):
                sd[key] = torch.rand(val.shape, generator=gen) + 0.5
            elif key.endswith(("bias", "running_mean")):
                sd[key] = torch.randn(val.shape, generator=gen) * 0.1
    return sd


def phase_card_vs_cpu(torch, factory, tokenizer_mod, model_gpu):
    """8 images and 4 prompts in fp32: card vs the port on the CPU, same
    weights, BatchNorms randomized (``randomize_bn``)."""
    model_cpu = factory.create_model("RN50", seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    sd = randomize_bn(torch, model_cpu.state_dict(), gen)
    model_cpu.load_state_dict(sd)
    model_gpu.load_state_dict(sd)
    x = torch.randn(8, 224, 224, 3, generator=gen)
    ids = torch.from_numpy(tokenizer_mod.tokenize(["a photo of a cat.", "a sketch of a barn.",
                                                   "a quickdraw of a tractor.", "an infograph of a lion."]))
    with torch.inference_mode():
        img_cpu = model_cpu.encode_image(x, normalize=True)
        img_gpu = model_gpu.encode_image(x.cuda(), normalize=True).cpu()
        txt_cpu = model_cpu.encode_text(ids, normalize=True)
        txt_gpu = model_gpu.encode_text(ids.cuda(), normalize=True).cpu()
    err_img = float((img_gpu - img_cpu).abs().max())
    err_txt = float((txt_gpu - txt_cpu).abs().max())
    log(f"  fp32 card vs CPU, unit-norm features: image max_abs_err {err_img:.3g}, "
        f"text max_abs_err {err_txt:.3g} (tolerance {MAIN_CHECK_TOL}: fp32 summation order "
        f"through 53 convs / 12 blocks)")
    if not (torch_all_finite(img_gpu) and torch_all_finite(txt_gpu)):
        fail("non-finite features on the card")
    if err_img > MAIN_CHECK_TOL or err_txt > MAIN_CHECK_TOL:
        fail("card and CPU disagree in fp32")
    return {"image_max_abs_err": err_img, "text_max_abs_err": err_txt}


def vit_lso_counts(cfg):
    """Phase 4b's (and 4d's) exact launches: K4 once per image layer and
    image batch (phase 4's tree in batches of BATCH, non-causal at the image
    head dim; none for a ConvNeXt tower, which has no attention) and once
    per text layer and prompt chunk (the 86-template heads in chunks of
    TEXT_CHUNK, causal at the text head dim); no K1/K2. Returns the counts
    by kernel and K4's by head dim and mask."""
    image_batches = math.ceil(IMAGENET_WNIDS * IMAGES_PER_WNID / BATCH) + math.ceil(2 * N_DOMAINNET_CLASSES / BATCH)
    text_chunks = (math.ceil(N_TEMPLATES * N_IMAGENET_CLASSES / TEXT_CHUNK)
                   + math.ceil(N_TEMPLATES * N_DOMAINNET_CLASSES / TEXT_CHUNK))
    v, t = cfg.vision, cfg.text
    by_shape = {}
    if not is_convnext(v):
        by_shape[f"D={v.width // v.heads}"] = v.layers * image_batches
    key = f"D={t.width // t.heads}{'' if t.no_causal_mask else ' causal'}"
    by_shape[key] = by_shape.get(key, 0) + t.layers * text_chunks
    return {"K1": 0, "K2": 0, "K4": sum(by_shape.values())}, by_shape


def is_convnext(v) -> bool:
    """Whether the vision config ``v`` is a ConvNeXt tower's (no attention)."""
    from xclip_tpu_torch.models import convnext

    return isinstance(v, convnext.ConvNeXtCfg)


def tower_depth(v) -> int:
    """Blocks of an image tower: a transformer's layers, a ConvNeXt's blocks."""
    return sum(v.depths) if is_convnext(v) else v.layers


def randomize_layer_scale(torch, model, gen) -> None:
    """Seeded LayerScale gammas in [0.5, 1.5) in every ConvNeXt block of
    ``model``, in place: the init's 1e-6 would keep the blocks out of the
    features (as ``randomize_bn`` does for RN50's bn3)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma") and ".stages." in name:
                p.copy_(torch.rand(p.shape, generator=gen).to(p.device) + 0.5)


def phase_vit_lso(torch, factory, run_lso, fused_conv, flash_attention, tokenizer_mod, classnames, name: str):
    """Phase 4b (and 4d): the zero-shot DomainNet-LSO evaluation of a seeded
    ViT, EVA or ConvNeXt CLIP (``name``) at full width, bf16, on phase 4's
    tree, through ``run_lso.main`` with exact K4 counts (split by head dim
    and mask, from the calls that launched); one image batch and one text
    chunk timed and profiled; 4 images and 4 prompts in fp32 on the card
    against the port on the CPU, within VIT_CHECK_TOL. A ConvNeXt's
    LayerScale gammas are seeded (``randomize_layer_scale``) before the
    ``.pt`` is written. The ``.pt`` (about 10 GB for ViT-bigG-14) is
    deleted at the end."""
    cfg = factory.get_clip_cfg(name)
    work = os.path.join(SCRATCH, f"vit_eval_{name}")
    ckpt = os.path.join(work, "epoch_1.pt")
    os.makedirs(work)
    t0 = time.perf_counter()
    model = factory.create_model(name, seed=0, device="cuda")
    if is_convnext(cfg.vision):
        randomize_layer_scale(torch, model, torch.Generator().manual_seed(15))
    n_params = sum(p.numel() for p in model.parameters())
    torch.save({"epoch": 1, "name": "chip_smoke", "state_dict": model.state_dict()}, ckpt)
    log(f"  {name} ({n_params / 1e9:.2f} B parameters) seed 0 created and saved "
        f"({os.path.getsize(ckpt) / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f} s")
    tree = os.path.join(SCRATCH, "tree")
    out = os.path.join(work, "eval")
    argv = ["--model", name, "--domain", "sketch", "--ckpt_files", ckpt, "--out_path", out,
            "--imagenet_path", os.path.join(tree, "imagenet"), "--domainnet_path", os.path.join(tree, "domainnet"),
            "--num_workers", "8", "--precision", "bf16"]
    by_shape = {}  # (head dim, causal) -> launches, tallied from the calls that launched
    kernel = flash_attention.flash_attention

    def tally(q, k, v, causal=False, sm_scale=None):
        before = flash_attention.launches
        out = kernel(q, k, v, causal=causal, sm_scale=sm_scale)
        key = f"D={q.shape[-1]}{' causal' if causal else ''}"
        by_shape[key] = by_shape.get(key, 0) + flash_attention.launches - before
        return out

    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    flash_attention.flash_attention = tally
    t0 = time.perf_counter()
    try:
        rc = run_lso.main(argv)
        torch.cuda.synchronize()
    finally:
        flash_attention.flash_attention = kernel
    wall = time.perf_counter() - t0
    counts = {"K1": fused_conv.launches - fused_conv.launches_with_identity,
              "K2": fused_conv.launches_with_identity, "K4": flash_attention.launches}
    if rc != 0:
        fail(f"run_lso.main ({name}) returned {rc}")
    with open(os.path.join(out, "results.json")) as fh:
        check_results(json.load(fh))
    want, want_by_shape = vit_lso_counts(cfg)
    log(f"  LSO eval ({name}, bf16): wall {wall:.2f} s; launches {counts} (expected {want}), "
        f"by head dim {by_shape} (expected {want_by_shape})")
    if counts["K4"] == 0 or counts != want or by_shape != want_by_shape:
        fail(f"{name} LSO launch counts {counts} {by_shape} differ from the path's {want} {want_by_shape}")

    gen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn(BATCH, cfg.image_size, cfg.image_size, 3, device="cuda", generator=gen)
    ids = torch.from_numpy(tokenizer_mod.tokenize(
        [f"a photo of a {classnames[i % len(classnames)]}." for i in range(TEXT_CHUNK)])).cuda()
    with torch.inference_mode():
        img_ms = time_ms(lambda: model.encode_image(images, normalize=True, dtype=torch.bfloat16), 200, 10)
        txt_ms = time_ms(lambda: model.encode_text(ids, normalize=True, dtype=torch.bfloat16), 200, 10)
    rates = {"eval_wall_s": wall, "image_batch_ms": img_ms, "images_per_s": BATCH / img_ms * 1e3,
             "text_chunk_ms": txt_ms, "prompts_per_s": TEXT_CHUNK / txt_ms * 1e3, "parameters": n_params,
             "launches_by_head_dim": by_shape}
    log(f"  {name} encode_image bf16 batch {BATCH}: {img_ms:.2f} ms ({rates['images_per_s']:.1f} img/s); "
        f"encode_text bf16 chunk {TEXT_CHUNK}: {txt_ms:.2f} ms ({rates['prompts_per_s']:.1f} prompts/s)")
    rates["device_time_by_kernel"] = profile_towers(torch, model, images, ids)
    del images, ids

    model_cpu = factory.create_model(name, pretrained=ckpt, device="cpu")
    shutil.rmtree(work)
    x = torch.randn(VIT_CHECK, cfg.image_size, cfg.image_size, 3, generator=torch.Generator().manual_seed(13))
    ids = torch.from_numpy(tokenizer_mod.tokenize(["a photo of a cat.", "a sketch of a barn.",
                                                   "a quickdraw of a tractor.", "an infograph of a lion."]))
    with torch.inference_mode():
        feats = {"image": (model.encode_image(x.cuda(), normalize=True).cpu(),
                           model_cpu.encode_image(x, normalize=True)),
                 "text": (model.encode_text(ids.cuda(), normalize=True).cpu(),
                          model_cpu.encode_text(ids, normalize=True))}
    errs = {k: float((gpu - cpu).abs().max()) for k, (gpu, cpu) in feats.items()}
    log(f"  {name} fp32 card vs CPU, unit-norm features of {VIT_CHECK} images / prompts: max_abs_err {errs} "
        f"(tolerance {VIT_CHECK_TOL}: fp32 summation order through {tower_depth(cfg.vision)} + {cfg.text.layers} "
        f"blocks)")
    if not all(torch_all_finite(gpu) for gpu, _ in feats.values()) or max(errs.values()) > VIT_CHECK_TOL:
        fail(f"{name}: card and CPU disagree in fp32")
    rates["card_vs_cpu"] = errs
    del model, model_cpu
    torch.cuda.empty_cache()
    return counts, rates


def attention_routes(torch, flash_attention, fn, witness: bool = False):
    """``fn()`` through K4, then with K4's wrapper swapped for its plain
    version and, with ``witness``, for the plain version with P rounded to
    q's dtype before P V (fp32 accumulation): what rounding P alone does to
    a tower. Returns ({"kernel" | "plain" | "p_rounded": output}, K4
    launches of the kernel route)."""
    kernel = flash_attention.flash_attention

    def plain(q, k, v, causal=False, sm_scale=None):
        return flash_attention.flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)

    def p_rounded(q, k, v, causal=False, sm_scale=None):
        seq_len, head_dim = q.shape[-2], q.shape[-1]
        s = (q.float() * (sm_scale or 1.0 / math.sqrt(head_dim))) @ k.float().transpose(-1, -2)
        if causal:
            s = s.masked_fill(torch.ones(seq_len, seq_len, dtype=torch.bool, device=q.device).triu(1), -math.inf)
        return (torch.softmax(s, dim=-1).to(q.dtype).float() @ v.float()).to(q.dtype)

    torch.cuda.synchronize()
    before = flash_attention.launches
    out = {"kernel": fn()}
    torch.cuda.synchronize()
    launched = flash_attention.launches - before
    routes = {"plain": plain, **({"p_rounded": p_rounded} if witness else {})}
    try:
        for name, route in routes.items():
            flash_attention.flash_attention = route
            out[name] = fn()
    finally:
        flash_attention.flash_attention = kernel
    return out, launched


def unit_rows(t):
    return t / t.norm(dim=-1, keepdim=True)


def block_update_err(torch, flash_attention, blocks, run) -> float:
    """Each block's residual update (output - input) on K4's route against
    the plain route's, on the input ``run()`` feeds that block through K4:
    the largest ||got - ref|| / ||ref - input|| over ``blocks``. Unlike the
    tower's output, this holds each launch at its real shapes and data
    without the amplification of a deep tower."""
    calls = []
    hooks = [b.register_forward_pre_hook(lambda m, args, kwargs: calls.append((m, args, kwargs)), with_kwargs=True)
             for b in blocks]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    worst = 0.0
    for m, args, kwargs in calls:
        outs, _ = attention_routes(torch, flash_attention, lambda: m(*args, **kwargs))
        x, got, ref = args[0].float(), outs["kernel"].float(), outs["plain"].float()
        worst = max(worst, float((got - ref).norm() / (ref - x).norm()))
    return worst


def hold_tower_routes(torch, flash_attention, label: str, fn, dname: str, want: int, head_dim: int,
                      blocks) -> dict:
    """Phases 4c and 4e: a tower's unit-norm features (``fn()``) through K4
    against the plain route, with ``want`` K4 launches at ``head_dim``. In
    fp32 within VIT_TOWER_TOL in relative norm. In bf16 within
    VIT_TOWER_TOL or TOWER_NOISE_RATIO times the witness's distance from
    the plain route (the tower's own bf16 noise), whichever is larger, and
    each of ``blocks``' updates within BLOCK_UPDATE_TOL
    (``block_update_err``); the kernel route's batch is timed."""
    outs, launched = attention_routes(torch, flash_attention, fn, witness=dname == "bf16")
    outs = {route: unit_rows(o) for route, o in outs.items()}
    got, ref = outs["kernel"], outs["plain"]
    err = norm_rel_err(got, ref)
    rec = {"launches": launched, "rel_err": err, "max_abs_err": float((got - ref).abs().max())}
    tol, more, block_bad = VIT_TOWER_TOL[dname], "", False
    if "p_rounded" in outs:
        rec["p_rounded_rel_err"] = norm_rel_err(outs["p_rounded"], ref)
        rec["kernel_vs_p_rounded_rel_err"] = norm_rel_err(got, outs["p_rounded"])
        tol = max(tol, TOWER_NOISE_RATIO * rec["p_rounded_rel_err"])
        rec["block_update_rel_err"] = block_update_err(torch, flash_attention, blocks, fn)
        block_bad = rec["block_update_rel_err"] > BLOCK_UPDATE_TOL
        rec["batch_ms"] = time_ms(fn, 200, 10)
        more = (f"; witness (P rounded to bf16) vs plain {rec['p_rounded_rel_err']:.3g}, kernel vs witness "
                f"{rec['kernel_vs_p_rounded_rel_err']:.3g}; worst block update rel err "
                f"{rec['block_update_rel_err']:.3g} (tolerance {BLOCK_UPDATE_TOL}); {rec['batch_ms']:.2f} ms per batch")
    rec["tolerance"] = tol
    log(f"  {label} {dname} batch {got.shape[0]}: {launched} K4 launches at D={head_dim} (expected {want}); "
        f"kernel vs plain attention, unit-norm features: rel err {err:.3g} (tolerance {tol:.3g}), "
        f"max_abs_err {rec['max_abs_err']:.3g}" + more)
    if launched != want or not torch_all_finite(got) or err > tol or block_bad:
        fail(f"{label} {dname}: {launched} launches (expected {want}), rel err {err} (tolerance {tol}), "
             f"block update rel err {rec.get('block_update_rel_err')}")
    return rec


def phase_vit_tower(torch, factory, flash_attention, name: str):
    """Phase 4c: a seeded image tower of ``name`` (ViT-H-14, -g-14, -e-14:
    head dims 80, 88, 112) encodes one batch through K4, in bf16 and fp32,
    against the same tower with the plain attention on the card
    (``hold_tower_routes``); K4's launches counted."""
    from xclip_tpu_torch.models.transformer import VisionTransformer

    cfg = factory.get_clip_cfg(name).vision
    hd = cfg.width // cfg.heads
    t0 = time.perf_counter()
    with torch.device("cuda"):
        tower = VisionTransformer(cfg)
    with torch.no_grad():
        tower.init_parameters(torch.Generator(device="cuda").manual_seed(0))
    tower.eval()
    images = torch.randn(VIT_TOWER_BATCH, cfg.image_size, cfg.image_size, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(14))
    n_params = sum(p.numel() for p in tower.parameters())
    log(f"  {name} tower ({n_params / 1e6:.1f} M parameters, {cfg.layers} layers, width {cfg.width}, head dim {hd}) "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    res = {"head_dim": hd, "parameters": n_params}
    with torch.inference_mode():
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
            res[dname] = hold_tower_routes(torch, flash_attention, name, lambda: tower(images, dtype=dt), dname,
                                           cfg.layers, hd, tower.transformer.resblocks)
    del tower, images
    torch.cuda.empty_cache()
    return res


def phase_timm_tower(torch, factory, flash_attention, name: str):
    """Phase 4e: seeded timm towers at full width on the card, 64 images,
    bf16 and fp32. EVA02-E-14's image tower and both towers of
    ViT-SO400M-14-SigLIP (the text tower on TIMM_TEXT_BATCH seeded token
    ids) through K4, one launch per layer, against the same towers with the
    plain attention (``hold_tower_routes``, as phase 4c). convnext_xxlarge's
    image tower has no attention, so both routes would be one computation:
    its gammas are seeded, its bf16 batch timed, and it is held in fp32
    against the port on the CPU on CONVNEXT_CPU_CHECK images."""
    from xclip_tpu_torch.models import native_timm
    from xclip_tpu_torch.models.clip import CLIP

    cfg = factory.get_clip_cfg(name)
    v = cfg.vision
    with_text = name == SIGLIP
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = CLIP(cfg) if with_text else native_timm.build(v)
    model.init_parameters(torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    tower = model.visual if with_text else model
    n_params = sum(p.numel() for p in tower.parameters())
    log(f"  {name} image tower ({n_params / 1e9:.2f} B parameters, {tower_depth(v)} blocks, width {v.width}) "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(17)
    images = torch.randn(VIT_TOWER_BATCH, v.image_size, v.image_size, 3, device="cuda", generator=gen)
    res = {"parameters": n_params}
    if is_convnext(v):
        randomize_layer_scale(torch, model, torch.Generator().manual_seed(16))
        with torch.inference_mode():
            res["bf16"] = {"launches": 0, "image": {"batch_ms": time_ms(lambda: model(images, dtype=torch.bfloat16),
                                                                        200, 10)}}
            res["fp32"] = {"launches": 0}
            with torch.device("meta"):
                cpu = native_timm.build(v)
            cpu = cpu.to_empty(device="cpu")
            cpu.load_state_dict({k: p.cpu() for k, p in model.state_dict().items()})
            x = images[:CONVNEXT_CPU_CHECK].cpu()
            t0 = time.perf_counter()
            want = unit_rows(cpu.eval()(x))
            cpu_s = time.perf_counter() - t0
            got = unit_rows(model(x.cuda())).cpu()
        err = float((got - want).abs().max())
        res["card_vs_cpu"] = {"max_abs_err": err, "cpu_s": cpu_s}
        log(f"  {name} bf16 batch {VIT_TOWER_BATCH}: {res['bf16']['image']['batch_ms']:.2f} ms per batch; fp32 "
            f"card vs CPU, unit-norm features of {CONVNEXT_CPU_CHECK} images: max_abs_err {err:.3g} (tolerance "
            f"{VIT_CHECK_TOL}: fp32 summation order through {tower_depth(v)} blocks of convolutions; CPU "
            f"{cpu_s:.1f} s)")
        if not torch_all_finite(got) or err > VIT_CHECK_TOL:
            fail(f"{name}: card and CPU disagree in fp32")
        del cpu, model, tower, images
        torch.cuda.empty_cache()
        return res
    # part -> (run in a dtype, K4 launches a run, head dim, the blocks that launch)
    parts = {"image": (lambda dt: tower(images, dtype=dt), v.layers, v.width // v.heads, tower.trunk.blocks)}
    if with_text:
        t = cfg.text
        ids = torch.randint(1, t.vocab_size, (TIMM_TEXT_BATCH, t.context_length), device="cuda", generator=gen)
        parts["text"] = (lambda dt: model.encode_text(ids, dtype=dt), t.layers, t.width // t.heads,
                         model.text_tower().transformer.resblocks)
    res["head_dims"] = {part: hd for part, (_, _, hd, _) in parts.items()}
    with torch.inference_mode():
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
            res[dname] = {"launches": 0}
            for part, (fn, want, hd, blocks) in parts.items():
                res[dname][part] = hold_tower_routes(torch, flash_attention, f"{name} {part}",
                                                     lambda: fn(dt), dname, want, hd, blocks)
                res[dname]["launches"] += res[dname][part]["launches"]
    del model, tower, images
    torch.cuda.empty_cache()
    return res


def make_train_tsv(root: str, n: int, seed: int = 0) -> str:
    """Seeded ``filepath\ttitle`` TSV of n random 256 x 256 JPEGs with
    captions from a fixed list."""
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = ["filepath\ttitle"]
    for i in range(n):
        path = os.path.join(root, f"{i:04d}.jpg")
        Image.fromarray(rng.randint(0, 256, (256, 256, 3), np.uint8)).save(path, quality=90)
        rows.append(f"{path}\t{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}")
    tsv = os.path.join(root, "train.tsv")
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tsv


def train_counts(fused_conv, flash_attention) -> dict:
    return {"K1": fused_conv.launches - fused_conv.launches_with_identity,
            "K2": fused_conv.launches_with_identity, "K3": fused_conv.stats_launches,
            "K4": flash_attention.launches,
            "K1/K2 backward": fused_conv.affine_act_backward_calls,
            "K3 backward": fused_conv.stats_backward_calls, "K4 backward": flash_attention.backward_calls}


def zero_counts(fused_conv, flash_attention) -> None:
    """Every kernel's launch count and every Function's backward count to 0."""
    from xclip_tpu_torch.ops import stream_scale

    fused_conv.launches = fused_conv.launches_with_identity = fused_conv.stats_launches = 0
    fused_conv.affine_act_backward_calls = fused_conv.stats_backward_calls = 0
    flash_attention.launches = flash_attention.backward_calls = 0
    stream_scale.launches = 0


def train_path_counts(cfg, steps: int, accum: int) -> dict:
    """Launches and backward calls of ``steps`` training steps with grad
    checkpointing: each microbatch runs the cache forward, the grad forward
    and the per-block recomputation (K1 for the downsamples, K2 and K3 for
    every bottleneck, K4 for every text layer), and each Function's
    backward once."""
    blocks, stages = sum(cfg.vision.layers), len(cfg.vision.layers)
    micro = steps * accum
    per_fwd = {"K1": stages, "K2": blocks, "K3": blocks, "K4": cfg.text.layers}
    counts = {k: micro * 3 * v for k, v in per_fwd.items()}
    counts.update({"K1/K2 backward": micro * (blocks + stages), "K3 backward": micro * blocks,
                   "K4 backward": micro * cfg.text.layers})
    return counts


def phase_train(torch, factory, train_main, fused_conv, flash_attention, rn50):
    """The training CLI at full RN50 width, 12 steps across a resume."""
    t0 = time.perf_counter()
    tsv = make_train_tsv(os.path.join(SCRATCH, "train_data"), TRAIN_IMAGES)
    log(f"  training TSV: {TRAIN_IMAGES} JPEGs (256 px) in {time.perf_counter() - t0:.1f} s")
    logs = os.path.join(SCRATCH, "train_logs")
    argv = ["--model", "RN50", "--dataset-type", "tsv", "--train-data", tsv,
            "--batch-size", str(TRAIN_BATCH), "--accum-freq", str(TRAIN_ACCUM), "--precision", "amp",
            "--grad-checkpointing", "--warmup", "2", "--lr", "1e-3", "--save-frequency", "1",
            "--log-every-n-steps", "1", "--seed", "0", "--workers", "8", "--logs", logs,
            "--name", "chip_smoke", "--device", "cuda"]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc1 = train_main.main(argv + ["--epochs", "2"])
    t1 = time.perf_counter()
    rc2 = train_main.main(argv + ["--epochs", "3", "--resume", "latest"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = train_counts(fused_conv, flash_attention)
    if rc1 != 0 or rc2 != 0:
        fail(f"train.main returned {rc1}, {rc2}")
    with open(os.path.join(logs, "chip_smoke", "out.log")) as fh:
        lines = [ln for ln in fh.read().splitlines() if "Train Epoch:" in ln]
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in lines]
    if len(lines) != TRAIN_STEPS or not all("Batch (t):" in ln and "/s/gpu Scale:" in ln for ln in lines):
        fail(f"expected {TRAIN_STEPS} reference-format log lines, found {len(lines)}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite losses {losses}")
    ckpt_dir = os.path.join(logs, "chip_smoke", "checkpoints")
    for e in (1, 2, 3):
        if not os.path.exists(os.path.join(ckpt_dir, f"epoch_{e}.pt")):
            fail(f"epoch_{e}.pt not written")
    want = train_path_counts(rn50, TRAIN_STEPS, TRAIN_ACCUM)
    log(f"  train.main RN50 b{TRAIN_BATCH} x accum {TRAIN_ACCUM}, amp, grad checkpointing: "
        f"{TRAIN_STEPS} steps in {t2 - t0:.1f} s ({t1 - t0:.1f} s for epochs 0-1 incl. model and loader "
        f"start, {t2 - t1:.1f} s for the resumed epoch 2); losses {[round(v, 4) for v in losses]}")
    log(f"  launches {counts} (expected {want})")
    if any(counts[k] == 0 for k in counts):
        fail(f"a kernel or backward of the training path never ran: {counts}")
    if counts != want:
        fail(f"training counts {counts} differ from the path's {want}")
    model = factory.create_model("RN50", pretrained=os.path.join(ckpt_dir, "epoch_3.pt"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        feats = model.encode_image(torch.randn(4, 224, 224, 3, device="cuda", generator=gen), normalize=True,
                                   dtype=torch.bfloat16)
    if feats.shape != (4, rn50.embed_dim) or not torch_all_finite(feats):
        fail("epoch_3.pt does not give finite features in the eval model")
    del model
    torch.cuda.empty_cache()
    return counts, {"losses": losses, "train_wall_s": t2 - t0, "first_run_s": t1 - t0, "resumed_run_s": t2 - t1,
                    "log_lines": lines}


def phase_train_step_timing(torch, factory, tokenizer_mod):
    """Steady-state step of the training path (RN50, batch 128 x accum 2,
    amp, grad checkpointing) on fixed device batches: CUDA events over one
    step after two warm-up steps, then torch.profiler over one more."""
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    model = factory.create_model("RN50", device="cuda", seed=0).train()
    opt = optim.adamw(model, lr=1e-3)
    step = make_train_step(model, opt, schedule.const_lr(1e-3, 1),
                           TrainStepCfg(precision="amp", grad_checkpointing=True, accum_freq=TRAIN_ACCUM))
    n = TRAIN_BATCH * TRAIN_ACCUM
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randint(0, 256, (n, 224, 224, 3), device="cuda", dtype=torch.uint8, generator=gen)
    texts = torch.from_numpy(tokenizer_mod.tokenize([TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)] for i in range(n)]))
    texts = texts.cuda()
    for i in range(2):
        step(images, texts, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    m = step(images, texts, 2)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    step_ms = start.elapsed_time(end)
    if not math.isfinite(float(m["loss"])):
        fail("non-finite loss in the timed step")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  steady-state step: {step_ms:.1f} ms (CUDA events; host {host_ms:.1f} ms), "
        f"{n / step_ms * 1e3:.1f} img/s, peak memory {peak_gb:.1f} GB")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images, texts, 3)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CPU and evt.self_device_time_total > 0:
            rows.append((evt.key, evt.self_device_time_total / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(f"  profiler: device time over one step: {total:.1f} ms ({100 * total / step_ms:.1f} % of the step)")
    for key, ms, count in rows[:15]:
        log(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f} % x{count:<5d} {key[:110]}")
    del model, opt, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "host_step_ms": host_ms, "images_per_s": n / step_ms * 1e3,
            "peak_memory_gb": peak_gb, "profiled_device_ms": total,
            "top": [{"kernel": k, "ms": ms, "count": c} for k, ms, c in rows[:15]]}


TINY_RN = "TinyRN-chip-smoke"  # phases 5b and 5c: a seeded tiny RN CLIP, two microbatches of 8 images
TINY_RN_CFG = {
    "embed_dim": 64, "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2}}


def tiny_batch(torch):
    """Phases 5b and 5c's seeded batch: 16 images of 64 x 64 and their texts."""
    import numpy as np

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (16, 64, 64, 3)).astype(np.uint8))
    texts = torch.from_numpy(rng.randint(1, 49407, (16, 77)).astype(np.int32))
    return images, texts


def phase_train_card_vs_cpu(torch, factory, name=TINY_RN, cfg=TINY_RN_CFG, through="15 BatchNorms"):
    """One fp32 train step (accum 2, grad checkpointing) of a seeded tiny
    CLIP (RN, or phase 5e's ViT) on the card and on the CPU: loss and every
    gradient."""
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    factory._MODEL_CONFIGS[name] = cfg
    images, texts = tiny_batch(torch)
    results = []
    for device in ("cpu", "cuda"):
        model = factory.create_model(name, device=device, seed=0).train()
        step = make_train_step(model, optim.adamw(model, lr=1e-4), schedule.const_lr(1e-4, 1),
                               TrainStepCfg(precision="fp32", accum_freq=2, grad_checkpointing=True))
        m = step(images.to(device), texts.to(device), 0)
        results.append((float(m["loss"]), {n: p.grad.float().cpu() for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    # largest |difference| over the tensor's largest |value|, floored at 1e-4:
    # some gradients are 0 up to rounding (the attention pool's key bias)
    grad_err = max(float((g_gpu[n] - g_cpu[n]).abs().max()) / max(float(g_cpu[n].abs().max()), 1e-4)
                   for n in g_cpu)
    log(f"  fp32 {name} train step, card vs CPU: loss rel err {loss_err:.3g}, worst gradient rel err "
        f"{grad_err:.3g} (tolerance {TRAIN_CHECK_TOL}: fp32 summation order through {through})")
    if not math.isfinite(loss_gpu) or loss_err > TRAIN_CHECK_TOL or grad_err > TRAIN_CHECK_TOL:
        fail("card and CPU disagree on the fp32 train step")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


DETERMINISM_MODES = ("as_is", "deterministic")


def determinism_child() -> dict:
    """Phase 5c's child (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts).

    Two amp train steps (accum 2, grad checkpointing) of the tiny RN config
    from seed 0 on phase 5b's batch, run twice in each mode: as is and
    under ``torch.use_deterministic_algorithms(True)`` (an op without a
    deterministic implementation then raises, naming the op). Per pair:
    the losses' bits, the gradients whose bits differ after the first step
    and the parameters that differ after both."""
    import torch

    sys.path.insert(0, REPO)
    from xclip_tpu_torch.core import precision
    from xclip_tpu_torch.models import factory
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    precision.disable_tf32()  # as the training CLI's main() does
    factory._MODEL_CONFIGS[TINY_RN] = TINY_RN_CFG
    images, texts = (t.cuda() for t in tiny_batch(torch))

    def bits(t):
        return t.detach().reshape(-1).view(torch.uint8)

    def two_steps():
        model = factory.create_model(TINY_RN, device="cuda", seed=0).train()
        step = make_train_step(model, optim.adamw(model, lr=1e-4), schedule.const_lr(1e-4, 1),
                               TrainStepCfg(precision="amp", accum_freq=2, grad_checkpointing=True))
        losses = [float(step(images, texts, 0)["loss"])]
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        losses.append(float(step(images, texts, 1)["loss"]))
        torch.cuda.synchronize()
        return losses, grads, {n: p.detach().clone() for n, p in model.named_parameters()}

    out = {}
    for mode in DETERMINISM_MODES:
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            (l1, g1, p1), (l2, g2, p2) = two_steps(), two_steps()
        finally:
            torch.use_deterministic_algorithms(False)
        grads = [n for n in g1 if not torch.equal(bits(g1[n]), bits(g2[n]))]
        params = [n for n in p1 if not torch.equal(bits(p1[n]), bits(p2[n]))]
        out[mode] = {"losses": [l1, l2], "same_losses": l1 == l2, "grads_differ_step1": grads, "grads": len(g1),
                     "params_differ": len(params), "params": len(p1)}
    return out


def phase_determinism():
    """Phase 5c: runs :func:`determinism_child` in a child process, logs
    each pair, fails if the two runs of either mode differ."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = "import json, chip_smoke; print(json.dumps(chip_smoke.determinism_child()), flush=True)"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"the determinism child exited {res.returncode}: {res.stderr[-3000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for mode, m in out.items():
        log(f"  tiny RN amp, {mode}: losses {m['losses'][0]} / {m['losses'][1]} "
            f"({'same bits' if m['same_losses'] else 'DIFFER'}); gradients differing after step 1: "
            f"{len(m['grads_differ_step1'])} of {m['grads']} {m['grads_differ_step1'][:8]}; parameters "
            f"differing after step 2: {m['params_differ']} of {m['params']}")
    bad = [mode for mode, m in out.items() if not m["same_losses"] or m["params_differ"]]
    if bad:
        fail(f"two runs of the amp train step from one seed differ: {bad}")
    return out


TINY_VIT = "TinyViT-chip-smoke"  # phase 5e: a seeded tiny ViT, head dim 80 (K4's second instance), LayerScale
TINY_VIT_CFG = {
    "embed_dim": 64, "vision_cfg": {"image_size": 64, "patch_size": 16, "width": 160, "layers": 2, "head_width": 80,
                                    "ls_init_value": 0.1},
    "text_cfg": TINY_RN_CFG["text_cfg"]}
VIT_TRAIN_STEPS = TRAIN_IMAGES // (TRAIN_BATCH * TRAIN_ACCUM)  # one epoch of phase 5's TSV


def vit_train_counts(cfg, steps: int, accum: int) -> dict:
    """Phase 5e's exact counts: K4 in every ViT and text layer of each
    microbatch's three forwards (cache, grad, recomputation), its backward
    once per layer and microbatch; no K1/K2/K3."""
    micro, layers = steps * accum, cfg.vision.layers + cfg.text.layers
    return {"K1": 0, "K2": 0, "K3": 0, "K4": micro * 3 * layers, "K1/K2 backward": 0, "K3 backward": 0,
            "K4 backward": micro * layers}


def phase_vit_train(torch, factory, train_main, fused_conv, flash_attention):
    """Phase 5e: ``train.main`` for ViT-B-16 at batch 128 x accum 2, amp,
    grad checkpointing and patch dropout 0.5, one epoch (4 steps) of phase
    5's TSV: finite losses, exact counts, ``epoch_1.pt`` in the eval model;
    then one fp32 step of a tiny ViT (head dim 80), card vs CPU."""
    cfg = factory.get_clip_cfg(VIT_TRAIN, force_patch_dropout=VIT_PATCH_DROPOUT)
    logs = os.path.join(SCRATCH, "vit_train_logs")
    argv = ["--model", VIT_TRAIN, "--dataset-type", "tsv", "--train-data", os.path.join(SCRATCH, "train_data", "train.tsv"),
            "--batch-size", str(TRAIN_BATCH), "--accum-freq", str(TRAIN_ACCUM), "--precision", "amp",
            "--grad-checkpointing", "--force-patch-dropout", str(VIT_PATCH_DROPOUT), "--epochs", "1",
            "--warmup", "2", "--lr", "1e-3", "--log-every-n-steps", "1", "--seed", "0", "--workers", "8",
            "--logs", logs, "--name", "vit", "--device", "cuda"]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc = train_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = train_counts(fused_conv, flash_attention)
    if rc != 0:
        fail(f"train.main {VIT_TRAIN} returned {rc}")
    with open(os.path.join(logs, "vit", "out.log")) as fh:
        lines = [ln for ln in fh.read().splitlines() if "Train Epoch:" in ln]
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in lines]
    batch_s = [float(ln.split("Batch (t): ")[1].split(",")[0]) for ln in lines]
    if len(lines) != VIT_TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{VIT_TRAIN}: expected {VIT_TRAIN_STEPS} finite losses, found {losses}")
    want = vit_train_counts(cfg, VIT_TRAIN_STEPS, TRAIN_ACCUM)
    log(f"  train.main {VIT_TRAIN} b{TRAIN_BATCH} x accum {TRAIN_ACCUM}, amp, grad checkpointing, patch dropout "
        f"{VIT_PATCH_DROPOUT}: {VIT_TRAIN_STEPS} steps in {wall:.1f} s incl. model and loader start; losses "
        f"{[round(v, 4) for v in losses]}; Batch (t) {batch_s} s")
    log(f"  launches {counts} (expected {want})")
    if counts != want:
        fail(f"{VIT_TRAIN} training counts {counts} differ from the path's {want}")
    model = factory.create_model(VIT_TRAIN, pretrained=os.path.join(logs, "vit", "checkpoints", "epoch_1.pt"),
                                 device="cuda")
    with torch.inference_mode():
        feats = model.encode_image(torch.randn(4, cfg.image_size, cfg.image_size, 3, device="cuda"),
                                   normalize=True, dtype=torch.bfloat16)
    if feats.shape != (4, cfg.embed_dim) or not torch_all_finite(feats):
        fail(f"{VIT_TRAIN} epoch_1.pt does not give finite features in the eval model")
    del model
    torch.cuda.empty_cache()
    tiny = phase_train_card_vs_cpu(torch, factory, TINY_VIT, TINY_VIT_CFG, "2 + 2 blocks")
    return counts, {"losses": losses, "batch_s": batch_s, "wall_s": wall, "log_lines": lines,
                    "tiny_card_vs_cpu": tiny}


def eval_tower_counts(cfg, n_images: int, batch: int, text: bool) -> dict:
    """K1/K2/K4 launches of the eval-mode towers over ``n_images`` in
    batches of ``batch`` (the ragged tail is one more batch): K1 for every
    conv1 and downsample, K2 for every conv3, K4 per text layer when the
    batch has captions."""
    batches = math.ceil(n_images / batch)
    roles = [s[0] for s in fused_conv_shapes(cfg.vision, batch)]
    return {"K1": batches * (roles.count("conv1") + roles.count("downsample")),
            "K2": batches * roles.count("conv3"), "K4": batches * cfg.text.layers if text else 0}


def ddp_path_counts(cfg) -> dict:
    """Phase 5d's exact counts: DDP_STEPS training steps, then the
    zero-shot head (1,000 classes x 80 templates in chunks of TEXT_CHUNK
    prompts), the ImageNet tree and the val TSV at the CLI's batch."""
    counts = train_path_counts(cfg, DDP_STEPS, TRAIN_ACCUM)
    head_chunks = math.ceil(DDP_IMAGENET_CLASSES * ZERO_SHOT_TEMPLATES / TEXT_CHUNK)
    counts["K4"] += head_chunks * cfg.text.layers
    for n, text in ((DDP_IMAGENET_CLASSES, False), (DDP_VAL_IMAGES, True)):
        for k, v in eval_tower_counts(cfg, n, TRAIN_BATCH, text).items():
            counts[k] += v
    return counts


def ddp_eval_batches() -> list:
    """Phase 5d's fp32 image batches: the CLI's batch, and the ImageNet
    tree's and the val TSV's ragged tails."""
    tails = {n % TRAIN_BATCH for n in (DDP_IMAGENET_CLASSES, DDP_VAL_IMAGES)}
    return sorted({TRAIN_BATCH} | tails - {0}, reverse=True)


def make_imagenet_val(root: str, n_classes: int) -> str:
    """Seeded ``root/val/<wnid>/0.jpg``: one random 256 x 256 JPEG per class."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(2)
    for c in range(n_classes):
        d = os.path.join(root, "val", f"n{c:08d}")
        os.makedirs(d)
        Image.fromarray(rng.randint(0, 256, (256, 256, 3), np.uint8)).save(os.path.join(d, "0.jpg"), quality=90)
    return os.path.join(root, "val")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_step_bits(torch, factory, tokenizer_mod, group) -> dict:
    """Phase 5d (a): two RN50 amp steps (batch 128 x accum 2, grad
    checkpointing, seed 0) on one seeded batch, without a group and with
    ``group``; the losses' bits, and the parameters and buffers whose bits
    differ."""
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    n = TRAIN_BATCH * TRAIN_ACCUM
    gen = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randint(0, 256, (n, 224, 224, 3), device="cuda", dtype=torch.uint8, generator=gen)
    texts = torch.from_numpy(tokenizer_mod.tokenize([f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]} {i}"
                                                     for i in range(n)])).cuda()
    runs = []
    for g in (None, group):
        model = factory.create_model("RN50", device="cuda", seed=0).train()
        opt = optim.adamw(model, lr=1e-3)
        step = make_train_step(model, opt, schedule.const_lr(1e-3, 1),
                               TrainStepCfg(precision="amp", grad_checkpointing=True, accum_freq=TRAIN_ACCUM),
                               group=g)
        losses = [float(step(images, texts, i)["loss"]) for i in range(2)]
        torch.cuda.synchronize()
        runs.append((losses, {k: v.detach().reshape(-1).view(torch.uint8).clone()
                              for k, v in model.state_dict().items()}))
        del model, opt, step
    (l_none, s_none), (l_group, s_group) = runs
    differ = [k for k in s_none if not torch.equal(s_none[k], s_group[k])]
    torch.cuda.empty_cache()
    return {"losses": l_none, "losses_group": l_group, "same_losses": l_none == l_group,
            "state_differ": differ, "state_tensors": len(s_none)}


def phase_ddp(torch, factory, train_main, fused_conv, flash_attention, rn50, tokenizer_mod, card: str):
    """Phase 5d: the data-parallel code path as a 1-rank NCCL group."""
    import torch.distributed as dist

    shape_check = fp32_kernel_shapes(torch, fused_conv, rn50, ddp_eval_batches(), "per-epoch evaluation")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        bits = ddp_step_bits(torch, factory, tokenizer_mod, group)
        log(f"  RN50 amp, 2 steps without / with the 1-rank NCCL group: losses {bits['losses']} / "
            f"{bits['losses_group']} ({'same bits' if bits['same_losses'] else 'DIFFER'}); "
            f"{len(bits['state_differ'])} of {bits['state_tensors']} state tensors differ {bits['state_differ'][:8]}")
        if not bits["same_losses"] or bits["state_differ"]:
            fail("the 1-rank NCCL group changed the train step's bits")

        t0 = time.perf_counter()
        with open(os.path.join(SCRATCH, "train_data", "train.tsv")) as fh:
            rows = fh.read().splitlines()[:1 + DDP_STEPS * TRAIN_BATCH * TRAIN_ACCUM]
        tsv = os.path.join(SCRATCH, "train_data", "train_ddp.tsv")
        with open(tsv, "w") as fh:
            fh.write("\n".join(rows) + "\n")
        val_tsv = make_train_tsv(os.path.join(SCRATCH, "val_data"), DDP_VAL_IMAGES, seed=1)
        imagenet = make_imagenet_val(os.path.join(SCRATCH, "imagenet_ddp"), DDP_IMAGENET_CLASSES)
        log(f"  val TSV ({DDP_VAL_IMAGES}) and ImageNet tree ({DDP_IMAGENET_CLASSES} wnids) in "
            f"{time.perf_counter() - t0:.1f} s")
        logs = os.path.join(SCRATCH, "ddp_logs")
        argv = ["--model", "RN50", "--dataset-type", "tsv", "--train-data", tsv, "--val-data", val_tsv,
                "--imagenet-val", imagenet, "--zeroshot-frequency", "1", "--batch-size", str(TRAIN_BATCH),
                "--accum-freq", str(TRAIN_ACCUM), "--precision", "amp", "--grad-checkpointing", "--epochs", "1",
                "--warmup", "2", "--lr", "1e-3", "--log-every-n-steps", "1", "--seed", "0", "--workers", "8",
                "--logs", logs, "--name", "ddp", "--device", "cuda", "--local-loss", "--gather-with-grad"]
        evaluate, eval_s = train_main.evaluate, []

        def timed_evaluate(*args, **kwargs):
            t = time.perf_counter()
            out = evaluate(*args, **kwargs)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            return out

        train_main.evaluate = timed_evaluate
        try:
            torch.cuda.synchronize()
            zero_counts(fused_conv, flash_attention)
            t0 = time.perf_counter()
            rc = train_main.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = train_counts(fused_conv, flash_attention)
        finally:
            train_main.evaluate = evaluate
    finally:
        dist.destroy_process_group()
    if rc != 0:
        fail(f"train.main in the 1-rank NCCL group returned {rc}")
    run = os.path.join(logs, "ddp")
    with open(os.path.join(run, "out.log")) as fh:
        out_log = fh.read()
    with open(os.path.join(run, "checkpoints", "results.jsonl")) as fh:
        results = [json.loads(ln) for ln in fh.read().splitlines()]
    keys = ["imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5", "clip_val_loss"] + [
        f"{d}_{m}" for d in ("image_to_text", "text_to_image")
        for m in ("R@1", "R@5", "R@10", "mean_rank", "median_rank")]
    if len(results) != 1 or any(not math.isfinite(results[0].get(k, float("nan"))) for k in keys):
        fail(f"results.jsonl: {results}")
    if results[0]["num_samples"] != DDP_VAL_IMAGES or results[0]["epoch"] != 1:
        fail(f"results.jsonl num_samples/epoch: {results[0]}")
    if not os.path.exists(os.path.join(run, "checkpoints", "epoch_1.pt")):
        fail("epoch_1.pt not written by rank 0")
    if "1 process(es), rank 0, nccl" not in out_log:
        fail("train.main did not run in the NCCL group")
    lines = [ln for ln in out_log.splitlines() if "Train Epoch:" in ln]
    if len(lines) != DDP_STEPS:
        fail(f"expected {DDP_STEPS} log lines, found {len(lines)}")
    head = [ln for ln in out_log.splitlines() if "Finished zero-shot imagenet in" in ln]
    head_s = float(head[0].split("built in ")[1].split(" s")[0]) if head else float("nan")
    want = ddp_path_counts(rn50)
    log(f"  {card}: train.main RN50 in a 1-rank NCCL group, {DDP_STEPS} steps + eval: {wall_s:.1f} s; "
        f"zero-shot head ({DDP_IMAGENET_CLASSES} x {ZERO_SHOT_TEMPLATES} prompts, fp32) built in {head_s:.2f} s; "
        f"eval wall {eval_s[0]:.2f} s; top-1 {results[0]['imagenet-zeroshot-val-top1']:.4f}, "
        f"val loss {results[0]['clip_val_loss']:.4f}")
    log(f"  launches {counts} (expected {want})")
    if counts != want:
        fail(f"phase 5d counts {counts} differ from the path's {want}")
    return counts, {"kernel_shapes": shape_check, "step_bits": bits, "wall_s": wall_s, "eval_wall_s": eval_s[0], "head_build_s": head_s,
                    "results": results[0], "log_lines": lines}


def phase_stream_scale(torch, stream_scale, probe_bandwidth):
    """K5 vs plain bit for bit (fresh NaN-filled output, another buffer than
    x) at the probe's shape, at lengths on the kernel's block and wave
    boundaries, on views off and on 16-byte boundaries and on all 65,536 bf16
    bit patterns; its times in turns with the plain version and torch.mul,
    and the wrapper's host time per call; then the probe's entry point in
    both modes with exact launch counts."""
    from xclip_tpu_torch.ops import _build

    geometry = stream_scale.geometry()
    build_log = _build.BUILD_DIR / "build.log"
    usage = ptxas_usage(build_log.read_text() if build_log.exists() else "", "stream_scale_vec")
    log(f"  K5 ptxas (stream_scale_vec): {usage}; no dynamic shared memory; {geometry['threads']} threads "
        f"x {geometry['vecs_per_thread']} loads of 16 bytes, {geometry['blocks_per_sm']} blocks per SM, "
        f"{geometry['sms']} SMs")
    gen = torch.Generator(device="cuda").manual_seed(8)
    side = probe_bandwidth.SIDE

    def check(x, scale, what):
        got = stream_scale.stream_scale(x, scale, nan_fill_output=True)
        ref = stream_scale.stream_scale_plain(x, scale)
        torch.cuda.synchronize()
        if got.data_ptr() == x.data_ptr():
            fail(f"stream_scale {what} returned its input buffer")
        differ = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        if differ:
            fail(f"stream_scale {what} scale {scale}: {differ} elements differ in bits from the plain version")

    checked = []
    for shape, scale in (((1000, 1003), 1.5), ((1000, 1003), stream_scale.PROBE_SCALE),
                         ((side, side), stream_scale.PROBE_SCALE)):  # x stays at the probe's shape
        x = (torch.rand(shape, device="cuda", generator=gen) * 4 - 2).to(torch.bfloat16)
        check(x, scale, f"{shape[0]}x{shape[1]}")
        checked.append(f"{shape[0]}x{shape[1]} scale {scale}")
    log(f"  K5 bit-identical to torch.mul into fresh NaN-filled buffers: {', '.join(checked)}")
    edges = stream_scale.edge_lengths(**geometry)
    for case, n in edges.items():
        check((torch.randn(n, device="cuda", generator=gen) * 30).to(torch.bfloat16), 1.5, f"{case} (n={n})")
    wave = edges["wave_plus_8"]
    for offset in (1, 3, 7, 8, 16):  # 8 and 16 elements: on 16-byte boundaries, the vector kernel
        base = torch.randn(offset + wave, device="cuda", generator=gen).to(torch.bfloat16)
        check(base[offset:], -0.3, f"view at +{offset} (n={wave})")
    patterns = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).cuda()
    tiled = patterns.repeat(-(-edges["wave_plus_7"] // patterns.numel()))[:edges["wave_plus_7"]]
    for scale in (stream_scale.PROBE_SCALE, 1.5, -0.3, 2.0 ** -126, 3.0e38):
        check(patterns, scale, "all bf16 bit patterns")
        check(tiled, scale, "all bf16 bit patterns across a wave")
    log(f"  K5 bit-identical also at {len(edges)} edge lengths ({', '.join(f'{c} n={n}' for c, n in edges.items())}), "
        f"views at +1/3/7/8/16 elements, all 65,536 bf16 bit patterns (NaN, +-Inf, -0, subnormals) at 5 scales")
    del base, patterns, tiled

    s = torch.tensor(stream_scale.PROBE_SCALE, dtype=torch.bfloat16)
    per_round = rounds_ms({"kernel": lambda: stream_scale.stream_scale(x),
                           "plain": lambda: stream_scale.stream_scale_plain(x),
                           "library": lambda: torch.mul(x, s)}, K5_ROUNDS, K5_LAUNCHES)
    nbytes = 2 * x.numel() * x.element_size()  # read x once, write the output once
    timing = {name: {"median_ms": statistics.median(ms), "spread_ms": max(ms) - min(ms), "rounds_ms": ms}
              for name, ms in per_round.items()}
    rec = {"kernel": "K5", "dtype": "bf16", "shape": [side, side], "max_abs_err": 0.0,
           "kernel_ms": timing["kernel"]["median_ms"], "plain_ms": timing["plain"]["median_ms"],
           "library_ms": timing["library"]["median_ms"], "timing": timing, "edges": edges,
           "ptxas": usage, "geometry": geometry}
    bound(rec, float(x.numel()), nbytes, "fp32")  # one fp32 multiply per element
    share(rec)
    rec["kernel_gbps"] = nbytes / rec["kernel_ms"] / 1e6
    rec["library_gbps"] = nbytes / rec["library_ms"] / 1e6
    host = {}
    for name, fn in (("kernel", lambda: stream_scale.stream_scale(x)), ("library", lambda: torch.mul(x, s))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e3 / 100  # enqueue only: the card has not caught up
        torch.cuda.synchronize()
    rec["host_ms_per_call"] = host
    log(f"  K5 bf16 {side}x{side}, {K5_ROUNDS} rounds x {K5_LAUNCHES} launches in turns: median "
        f"kernel_ms={rec['kernel_ms']:.4f} (spread {timing['kernel']['spread_ms']:.4f}, {rec['kernel_gbps']:.1f} GB/s) "
        f"plain_ms={rec['plain_ms']:.4f} (spread {timing['plain']['spread_ms']:.4f}) "
        f"library_ms={rec['library_ms']:.4f} (spread {timing['library']['spread_ms']:.4f}, "
        f"{rec['library_gbps']:.1f} GB/s) bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}, "
        f"share {rec['share_of_bound']:.3f}); host per call: wrapper {host['kernel']:.4f} ms, "
        f"torch.mul {host['library']:.4f} ms")
    del x
    torch.cuda.empty_cache()

    from xclip_tpu_torch.ops import flash_attention, fused_conv

    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    single = probe_bandwidth.main([])
    chained = probe_bandwidth.main(["--chain", "10"])
    torch.cuda.synchronize()
    launches = stream_scale.launches
    others = fused_conv.launches + fused_conv.stats_launches + flash_attention.launches
    want = (1 + 20) + (1 + 5) * 10  # warm-up + timed calls, one launch each, then 10 per chained call
    log(f"  probe: {single['kernel_stream_gbps']:.1f} vs torch {single['torch_stream_gbps']:.1f} GB/s; "
        f"chain=10: {chained['kernel_stream_gbps']:.1f} vs {chained['torch_stream_gbps']:.1f} GB/s; "
        f"launches {launches} (expected {want})")
    if launches != want or others:
        fail(f"the probe launched K5 {launches} times (expected {want}) and other kernels {others} times")
    for res in (single, chained):
        if not all(math.isfinite(res[k]) and res[k] > 0 for k in ("torch_ms", "kernel_ms")):
            fail(f"probe timings {res}")
    rec.update(probe=single, probe_chain=chained, launches=launches)
    return rec


def make_domainnet_tree(root: str) -> int:
    """Seeded DomainNet tree of small JPEGs (48 x 64 random colours, 512
    distinct images, resized to 224 by the eval transform): six domains,
    ``{domain}_{train,test}.tsv`` rows path<TAB>label<TAB>caption."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    pool = []
    for _ in range(512):
        img = rng.randint(0, 256, (48, 64, 3)).astype(np.int32) // 2 + rng.randint(0, 128, (1, 1, 3))
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG", quality=90)
        pool.append(buf.getvalue())
    n = 0
    for domain in ("clipart", "infograph", "painting", "quickdraw", "real", "sketch"):
        for split, count in (("train", SAE_TRAIN_PER_DOMAIN), ("test", SAE_TEST_PER_DOMAIN)):
            rows = []
            for i in range(count):
                label = int(rng.randint(0, N_DOMAINNET_CLASSES))
                rel = f"{domain}/c{label}/{split}{i}.jpg"
                os.makedirs(os.path.join(root, domain, f"c{label}"), exist_ok=True)
                with open(os.path.join(root, rel), "wb") as fh:
                    fh.write(pool[rng.randint(len(pool))])
                rows.append(f"{rel}\t{label}\ta {domain} of thing {label}.")
                n += 1
            with open(os.path.join(root, f"{domain}_{split}.tsv"), "w") as fh:
                fh.write("\n".join(rows) + "\n")
    return n


class _LogCollector(logging.Handler):
    """Messages of the root logger while in a ``with`` block."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def fp32_kernel_shapes(torch, fused_conv, rn50, batches, path: str) -> dict:
    """K1/K2 vs plain in fp32 at every fused-conv shape of a path's fp32
    image batches, full and ragged: phase 3 checks the eval batch of 250
    only."""
    unique = {s[1:] for bsz in batches for s in fused_conv_shapes(rn50.vision, bsz)}
    return check_fp32_shapes(torch, fused_conv, unique, path, f"image batches {batches}") | {"batches": batches}


def check_fp32_shapes(torch, fused_conv, shapes, path: str, note: str) -> dict:
    """K1/K2 vs plain in fp32 at each (M, K, C, identity, relu) of
    ``shapes``, on seeded inputs, at the fp32 tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    unique = sorted(shapes, reverse=True)
    errs = {"K1": 0.0, "K2": 0.0}
    for m, k, c, ident, relu in unique:
        z = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)
        g = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen) * 0.1
        idn = torch.randn(m, c, device="cuda", generator=gen) if ident else None
        got = fused_conv.matmul_affine_act(z, w, g, b, idn, relu=relu)
        ref = fused_conv.matmul_affine_act_plain(z, w, g, b, idn, relu=relu)
        ok, err = close(got, ref, TOLERANCE["fp32"])
        kid = "K2" if ident else "K1"
        errs[kid] = max(errs[kid], err)
        if not ok:
            fail(f"matmul_affine_act fp32 M={m} K={k} C={c} id={ident} ({path}): max_abs_err {err}")
        del z, w, g, b, idn, got, ref
    torch.cuda.empty_cache()
    log(f"  K1/K2 fp32 vs plain at the {path}'s {len(unique)} shapes ({note}, largest M "
        f"{unique[0][0]}): max_abs_err K1 {errs['K1']:.3g}, K2 {errs['K2']:.3g} (tolerance {TOLERANCE['fp32']})")
    return {"shapes": len(unique), "largest_m": unique[0][0], "max_abs_err": errs}


def check_tower_routes(torch, fused_conv, enc, images, tail: int, per_batch: int) -> dict:
    """The fp32 image tower through the kernels against the same model with
    its 1x1 convs on the plain route, at the cache's batch and its ragged
    tail; the kernel route launches ``per_batch`` kernels, the plain none."""
    errs = {}
    with torch.inference_mode():
        for n in (len(images), tail):
            before = fused_conv.launches
            got = enc.encode_image(images[:n], normalize=True)
            kernel_route = fused_conv.matmul_affine_act
            fused_conv.matmul_affine_act = fused_conv.matmul_affine_act_plain
            try:
                ref = enc.encode_image(images[:n], normalize=True)
            finally:
                fused_conv.matmul_affine_act = kernel_route
            torch.cuda.synchronize()
            launched = fused_conv.launches - before
            ok, errs[n] = close(got, ref, TOLERANCE["fp32"])
            if launched != per_batch or not ok:
                fail(f"encode_image fp32 batch {n}: {launched} kernel launches (expected {per_batch}), kernel route vs "
                     f"plain route max_abs_err {errs[n]}")
    log(f"  encode_image fp32, kernel route vs plain route: max_abs_err {errs} by batch "
        f"(tolerance {TOLERANCE['fp32']})")
    return errs


class _ResampleRecorder:
    """Copies of the SAE parameters and Adam moments just before and after
    each ``Pipeline.update_parameters`` (one per resample), with its dead
    indices, while in a ``with`` block."""

    def __init__(self, torch, pipeline_mod, sae_model):
        self.torch, self.cls, self.tree_map = torch, pipeline_mod.Pipeline, sae_model.tree_map
        self.records = []

    def _state(self, pipe):
        return self.tree_map(self.torch.clone, {"p": pipe.params, "mu": pipe.opt_state.mu, "nu": pipe.opt_state.nu})

    def __enter__(self):
        self.orig = self.cls.update_parameters

        def update_parameters(pipe, updates):
            before = self._state(pipe)
            self.orig(pipe, updates)
            self.records.append((updates.dead_neuron_indices.copy(), before, self._state(pipe)))

        self.cls.update_parameters = update_parameters
        return self

    def __exit__(self, *exc):
        self.cls.update_parameters = self.orig


def check_resample(torch, dead, before, after, store) -> dict:
    """What one resample wrote (component 0 of the components layout): at
    the dead neurons, decoder columns that are unit rows of the feature
    store, encoder rows in the same directions at 0.2x the mean alive
    encoder-row norm, zero encoder biases and zero Adam moments; every
    other parameter and moment unchanged, bit for bit."""
    m = before["p"]["encoder"]["bias"].shape[-1]
    dead_t = torch.as_tensor(dead, device="cuda")
    alive = torch.ones(m, dtype=torch.bool, device="cuda")
    alive[dead_t] = False
    untouched = all(torch.equal(after[part]["tied_bias"], before[part]["tied_bias"]) and
                    torch.equal(after[part]["encoder"]["weight"][0][alive], before[part]["encoder"]["weight"][0][alive])
                    and torch.equal(after[part]["encoder"]["bias"][0][alive], before[part]["encoder"]["bias"][0][alive])
                    and torch.equal(after[part]["decoder"]["weight"][0][:, alive],
                                    before[part]["decoder"]["weight"][0][:, alive]) for part in ("p", "mu", "nu"))
    if not len(dead):
        if not untouched:
            fail("a resample of no neurons changed the parameters or moments")
        return {"dead": 0}
    dec = after["p"]["decoder"]["weight"][0][:, dead_t].T.double()  # (n_dead, d)
    dec_norm = dec.norm(dim=1)
    unit_store = torch.from_numpy(store).to("cuda", torch.float64)
    unit_store /= unit_store.norm(dim=1, keepdim=True)
    best_cos = ((dec / dec_norm[:, None]) @ unit_store.T).max(dim=1).values
    enc = after["p"]["encoder"]["weight"][0][dead_t].double()
    enc_norm = enc.norm(dim=1)
    want_norm = 0.2 * float(before["p"]["encoder"]["weight"][0][alive].double().norm(dim=1).mean())
    enc_cos = ((enc / enc_norm[:, None]) * (dec / dec_norm[:, None])).sum(dim=1)
    res = {"dead": len(dead), "decoder_norm_err": float((dec_norm - 1).abs().max()),
           "decoder_store_cos_min": float(best_cos.min()),
           "encoder_norm_rel_err": float((enc_norm / want_norm - 1).abs().max()),
           "encoder_decoder_cos_min": float(enc_cos.min()),
           "dead_bias_max": float(after["p"]["encoder"]["bias"][0][dead_t].abs().max())}
    moments_zero = all(not after[part][a][b][0][dead_t].any() for part in ("mu", "nu")
                       for a, b in (("encoder", "weight"), ("encoder", "bias"))) and \
        all(not after[part]["decoder"]["weight"][0][:, dead_t].any() for part in ("mu", "nu"))
    if not (res["decoder_norm_err"] < 1e-3 and res["decoder_store_cos_min"] > 1 - 1e-5
            and res["encoder_norm_rel_err"] < 1e-3 and res["encoder_decoder_cos_min"] > 1 - 1e-5
            and res["dead_bias_max"] == 0.0 and moments_zero and untouched):
        fail(f"resample of {len(dead)} neurons wrote {res}; dead moments zero: {moments_zero}; "
             f"the rest unchanged: {untouched}")
    return res


def sae_path_counts(fused_conv, flash_attention) -> dict:
    from xclip_tpu_torch.ops import stream_scale

    return {"K1": fused_conv.launches - fused_conv.launches_with_identity,
            "K2": fused_conv.launches_with_identity, "K3": fused_conv.stats_launches,
            "K4": flash_attention.launches, "K5": stream_scale.launches}


def phase_sae(torch, factory, fused_conv, flash_attention, rn50):
    """The SAE CLI and the feature CLI at full width, with exact counts."""
    import numpy as np

    from xclip_tpu_torch.sae import losses, model as sae_model, optim as sae_optim, pipeline
    from xclip_tpu_torch.scripts import save_domainnet_features, train_sae

    t0 = time.perf_counter()
    tree = os.path.join(SCRATCH, "domainnet")
    n_images = make_domainnet_tree(tree)
    log(f"  synthetic DomainNet tree: {n_images} JPEGs in {time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(SCRATCH, "sae_rn50.pt")
    # BatchNorms randomized, so that every 1x1 conv of the tower reaches the cached features
    sd = randomize_bn(torch, factory.create_model("RN50", seed=0, device="cpu").state_dict(),
                      torch.Generator().manual_seed(11))
    torch.save({"epoch": 1, "name": "chip_smoke", "state_dict": sd}, ckpt)
    out = os.path.join(SCRATCH, "sae")
    n_train, n_val = 6 * SAE_TRAIN_PER_DOMAIN, 6 * SAE_TEST_PER_DOMAIN
    # the image batches of the path: full and ragged, cache (1024) and save_domainnet_features (256)
    batches = sorted({size for n, bs in ((n_train, SAE_CACHE_BS), (n_val, SAE_CACHE_BS), (n_val, SAE_FEATURES_BS))
                      for size in (bs if n >= bs else 0, n % bs) if size}, reverse=True)
    shape_check = fp32_kernel_shapes(torch, fused_conv, rn50, batches, "SAE path")
    argv = ["--out_dir", out, "--ckpt_path", ckpt, "--domainnet_path", tree, "--domainnet_only",
            "--img_enc_name", "RN50", "--input_dim", str(SAE_D), "--expansion_factor", str(SAE_M // SAE_D),
            "--train_sae_bs", str(SAE_BATCH), "--hook_points", "out", "--activations_bs", str(SAE_CACHE_BS),
            "--num_workers", "8", "--resample_freq", str(SAE_RESAMPLE_FREQ), "--resample_dataset_size", str(SAE_RESAMPLE_ROWS),
            "--val_freq", str(n_train), "--num_epochs", str(SAE_EPOCHS), "--device", "cuda"]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    with _LogCollector() as logs, _ResampleRecorder(torch, pipeline, sae_model) as resamples:
        rc = train_sae.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sae_path_counts(fused_conv, flash_attention)
    if rc != 0:
        fail(f"train_sae.main returned {rc}")
    per_batch = fused_conv_shapes(rn50.vision, 1)
    k1_per, k2_per = sum(not s[4] for s in per_batch), sum(s[4] for s in per_batch)  # 20 and 16 for RN50
    batches = math.ceil(n_train / SAE_CACHE_BS) + math.ceil(n_val / SAE_CACHE_BS)
    want = {"K1": k1_per * batches, "K2": k2_per * batches, "K3": 0, "K4": 0, "K5": 0}
    # the CLI logs each phase's time: "cached ... in X s", "trained ... in X s"
    cache_s = sum(float(m.split(" in ")[-1].split()[0]) for m in logs.messages if m.startswith("cached"))
    train_s = sum(float(m.split(" in ")[-1].split()[0]) for m in logs.messages if m.startswith("trained"))
    log(f"  train_sae.main: wall {wall:.2f} s; feature cache (RN50 fp32, batch {SAE_CACHE_BS}) {n_train + n_val} "
        f"images in {cache_s:.2f} s ({(n_train + n_val) / cache_s:.1f} img/s, decode included); SAE training "
        f"{train_s:.2f} s; launches {counts} (expected {want})")
    if counts != want:
        fail(f"feature-cache launch counts {counts} differ from the path's {want}")
    acts = os.path.join(out, "activations")
    shards = {f: np.load(os.path.join(acts, f)) for f in sorted(os.listdir(acts))}
    shapes = {f: (a.shape, str(a.dtype)) for f, a in shards.items()}
    if shapes != {"train_activations.npy": ((n_train, SAE_D), "float16"),
                  "train_val_activations.npy": ((n_val, SAE_D), "float16")}:
        fail(f"feature shards {shapes}")
    norms = np.linalg.norm(np.concatenate(list(shards.values())).astype(np.float32), axis=1)
    if not (np.isfinite(norms).all() and np.abs(norms - 1).max() < 2e-3):
        fail(f"cached features are not unit-norm fp16: |norm - 1| up to {np.abs(norms - 1).max()}")
    resampled = [int(m.split()[1]) for m in logs.messages if m.startswith("Resampling")]
    if len(resampled) != SAE_EPOCHS // SAE_RESAMPLE_FREQ or [len(r[0]) for r in resamples.records] != resampled:
        fail(f"expected {SAE_EPOCHS // SAE_RESAMPLE_FREQ} resamples, logged {resampled}, recorded "
             f"{[len(r[0]) for r in resamples.records]}")
    resample_checks = [check_resample(torch, *rec, shards["train_activations.npy"]) for rec in resamples.records]
    log(f"  resamples at full width: {resample_checks}")
    sd = torch.load(os.path.join(out, "checkpoints", "sparse_autoencoder_final.pt"), weights_only=True)
    want_shapes = {"tied_bias": (1, SAE_D), "encoder._weight": (1, SAE_M, SAE_D), "encoder._bias": (1, SAE_M),
                   "decoder._weight": (1, SAE_D, SAE_M)}
    if {k: tuple(v.shape) for k, v in sd.items()} != want_shapes:
        fail(f"SAE checkpoint keys/shapes {[(k, tuple(v.shape)) for k, v in sd.items()]}")
    # the last resample follows the last epoch's steps: the final checkpoint holds what it wrote
    last = sae_model.sae_params_to_state_dict(resamples.records[-1][2]["p"])
    if not all(torch.equal(sd[k].cpu(), last[k].cpu()) for k in want_shapes):
        fail("the final checkpoint differs from the parameters the last resample wrote")
    col_err = float((torch.linalg.vector_norm(sd["decoder._weight"], dim=-2) - 1).abs().max())
    if col_err > 1e-4:
        fail(f"decoder columns off unit norm by {col_err}")
    # validation loss: at the CLI's initial parameters (seed 49), after each
    # epoch (the CLI's log; an epoch validates after its resample), and of
    # the final checkpoint. Each epoch without a resample must lower it: the
    # first below its value at init, a later one below the epoch before.
    cfg = sae_model.SAECfg(SAE_D, SAE_M, n_components=1)
    init = sae_model.sae_init(torch.Generator().manual_seed(49), cfg, device="cuda")
    val_store = shards["train_val_activations.npy"][:, None, :]
    loss_cfg = losses.SAELossCfg(3e-4)
    val_init = pipeline.Pipeline(init, loss_cfg, sae_optim.adam(), SCRATCH).validation(val_store, SAE_BATCH)
    final = sae_model.sae_state_dict_to_params(sd, device="cuda")
    val_final = pipeline.Pipeline(final, loss_cfg, sae_optim.adam(), SCRATCH).validation(val_store, SAE_BATCH)
    per_epoch = [ast.literal_eval(m.split("validation: ", 1)[1])["total_loss"]
                 for m in logs.messages if m.startswith("epoch ") and " validation: " in m]
    resample_epochs = {e for e in range(SAE_EPOCHS) if (e + 1) % SAE_RESAMPLE_FREQ == 0}
    log(f"  SAE {SAE_D} -> {SAE_M}, batch {SAE_BATCH}, {SAE_EPOCHS} epochs ({SAE_EPOCHS * (n_train // SAE_BATCH)} "
        f"steps): resampled {resampled} dead neurons after epochs {sorted(resample_epochs)}; val total loss "
        f"{val_init['total_loss']:.6g} at init, {[round(v, 6) for v in per_epoch]} after each epoch, "
        f"{val_final['total_loss']:.6g} from the final checkpoint (below init: "
        f"{val_final['total_loss'] < val_init['total_loss']}); decoder columns unit norm within {col_err:.2g}")
    if len(per_epoch) != SAE_EPOCHS or abs(per_epoch[-1] - val_final["total_loss"]) > 1e-5 * abs(val_final["total_loss"]):
        fail(f"logged validations {per_epoch} vs the final checkpoint's {val_final['total_loss']}")
    before = [val_init["total_loss"]] + per_epoch[:-1]
    for e in range(SAE_EPOCHS):
        if e not in resample_epochs and not per_epoch[e] < before[e]:
            fail(f"epoch {e} (no resample) did not lower the validation loss: {before[e]} -> {per_epoch[e]}")

    # the image tower alone at the cache's batch (fp32, device time): the
    # cache's rate above adds JPEG decode and the host-to-device copy
    enc = factory.create_model("RN50", pretrained=ckpt, device="cuda")
    images = torch.randn(SAE_CACHE_BS, rn50.image_size, rn50.image_size, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(9))
    with torch.inference_mode():
        encode_ms = time_ms(lambda: enc.encode_image(images, normalize=True), 300, 5)
    log(f"  encode_image fp32 batch {SAE_CACHE_BS}: {encode_ms:.2f} ms ({SAE_CACHE_BS / encode_ms * 1e3:.1f} img/s "
        f"on the device)")
    route_errs = check_tower_routes(torch, fused_conv, enc, images, n_train % SAE_CACHE_BS, len(per_batch))
    del enc, images
    torch.cuda.empty_cache()

    feats_out = os.path.join(SCRATCH, "dn_features")
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc = save_domainnet_features.main(["--model", "RN50", "--ckpt_files", ckpt, "--out_path", feats_out,
                                       "--domainnet_path", tree, "--num_workers", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    fcounts = sae_path_counts(fused_conv, flash_attention)
    fb = math.ceil(n_val / SAE_FEATURES_BS)
    fwant = {"K1": k1_per * fb, "K2": k2_per * fb, "K3": 0, "K4": 0, "K5": 0}
    log(f"  save_domainnet_features: {n_val} images in {feat_s:.2f} s; launches {fcounts} (expected {fwant})")
    if rc != 0 or fcounts != fwant:
        fail(f"save_domainnet_features rc {rc}, launch counts {fcounts} (expected {fwant})")
    img_feat = np.load(os.path.join(feats_out, "img_feat.npy"))
    ids = np.load(os.path.join(feats_out, "domain_ids.npy"))
    labels = np.load(os.path.join(feats_out, "domain_labels.npy"))
    if img_feat.shape != (1, n_val, rn50.embed_dim) or ids.shape != (n_val,) or labels.shape != (n_val,) \
            or np.unique(ids).size != 6 or not np.isfinite(img_feat).all():
        fail(f"features {img_feat.shape}, ids {ids.shape} ({np.unique(ids).size} domains), labels {labels.shape}")
    # the first 8 validation images, encoded in fp32 by the port on the CPU
    from xclip_tpu_torch.data.datasets import DomainNetCaptions
    from xclip_tpu_torch.data.transforms import image_transform

    ds = DomainNetCaptions(tree, "val", image_transform(rn50.image_size), mode="none")
    cpu_model = factory.create_model("RN50", pretrained=ckpt, device="cpu")
    with torch.inference_mode():
        ref = cpu_model.encode_image(torch.from_numpy(np.stack([ds[i] for i in range(8)])), normalize=True)
    feat_err = float(np.abs(img_feat[0, :8] - ref.numpy()).max())
    log(f"  fp32 features, card vs CPU on 8 images: max_abs_err {feat_err:.3g} (tolerance {MAIN_CHECK_TOL})")
    if feat_err > MAIN_CHECK_TOL:
        fail("saved DomainNet features disagree with the CPU")
    del cpu_model
    sae = {"cache_s": cache_s, "cache_images": n_train + n_val, "cache_images_per_s": (n_train + n_val) / cache_s,
           "encode_fp32_batch_ms": encode_ms, "encode_fp32_images_per_s": SAE_CACHE_BS / encode_ms * 1e3,
           "train_s": train_s, "cli_wall_s": wall, "resampled": resampled, "val_loss_init": val_init, "val_total_per_epoch": per_epoch,
           "val_loss_final": val_final,
           "decoder_unit_norm_err": col_err, "features_s": feat_s, "features_card_vs_cpu": feat_err,
           "kernel_shapes": shape_check, "tower_kernel_vs_plain_route": route_errs, "resamples": resample_checks}
    return {"cache": counts, "features": fcounts}, sae, shards["train_activations.npy"]


def phase_sae_step_timing(torch, store):
    """Steady-state SAE step at 1024 -> 4096, batch 4096 (components layout)
    on cached features: CUDA events over 30 steps after 3 warm-up steps,
    then torch.profiler over 3 more."""
    from xclip_tpu_torch.sae import losses, model as sae_model, optim as sae_optim, pipeline

    params = sae_model.sae_init(torch.Generator().manual_seed(0), sae_model.SAECfg(SAE_D, SAE_M, 1), device="cuda")
    adam = sae_optim.adam(1e-4)
    state = adam.init(params)
    loss_cfg = losses.SAELossCfg(3e-4)
    batch = torch.from_numpy(store[:SAE_BATCH, None, :]).to("cuda", torch.float32)
    for _ in range(3):
        params, metrics, _ = pipeline.train_step(params, adam, state, loss_cfg, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(SAE_TIMED_STEPS):
        params, metrics, _ = pipeline.train_step(params, adam, state, loss_cfg, batch)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / SAE_TIMED_STEPS
    step_ms = start.elapsed_time(end) / SAE_TIMED_STEPS
    if not math.isfinite(float(metrics["total_loss"])):
        fail("non-finite SAE loss in the timed steps")
    flops = 6 * 2.0 * SAE_BATCH * SAE_D * SAE_M  # 2 forward products, 4 backward (dW_dec, dlearned, dW_enc, dx)
    bound_ms = flops / PEAK_FLOPS["fp32"] * 1e3
    log(f"  steady-state SAE step: {step_ms:.3f} ms (CUDA events, mean of {SAE_TIMED_STEPS}; host {host_ms:.3f} ms), "
        f"{1e3 / step_ms:.1f} steps/s, {SAE_BATCH * 1e3 / step_ms:.0f} activations/s; fp32 bound "
        f"{bound_ms:.3f} ms ({flops / 1e9:.1f} GFLOP at 67 TFLOP/s)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            params, metrics, _ = pipeline.train_step(params, adam, state, loss_cfg, batch)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(f"  profiler: device time over 3 SAE steps: {total:.2f} ms ({100 * total / (3 * step_ms):.1f} % of 3 steps)")
    for key, ms, count in rows[:10]:
        log(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f} % x{count:<5d} {key[:110]}")
    del params, state, batch
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "host_step_ms": host_ms, "steps_per_s": 1e3 / step_ms,
            "activations_per_s": SAE_BATCH * 1e3 / step_ms, "bound_ms": bound_ms, "gflop_per_step": flops / 1e9,
            "profiled_device_ms_3_steps": total,
            "top": [{"kernel": k, "ms": ms, "count": c} for k, ms, c in rows[:10]]}


class _GradTap:
    """The optimizer handed to ``train_step``: keeps a CPU copy of the
    gradients it receives and steps with ``replace`` instead when set."""

    def __init__(self, adam, tree_map, replace=None):
        self.adam, self.tree_map, self.replace, self.grads = adam, tree_map, replace, None

    def update(self, grads, state, params):
        self.grads = self.tree_map(lambda t: t.detach().cpu().clone(), grads)
        if self.replace is not None:
            device = params["tied_bias"].device
            grads = self.tree_map(lambda t: t.to(device), self.replace)
        return self.adam.update(grads, state, params)


def phase_sae_card_vs_cpu(torch, store):
    """One fp32 SAE step at full width from the same parameters and batch on
    the card and on the CPU: the loss; the gradients Adam receives (after
    ``remove_parallel_gradient``) per tensor as ||card - CPU|| / ||CPU||;
    the parameters after the card's step taken with the CPU's gradients, as
    the largest difference over each tensor's largest magnitude. A norm for
    the gradients, as in phase 3b: a pre-activation within rounding of 0
    fires on one device and not the other, which moves its neuron's
    gradient by one item's whole contribution. Adam's first step is about
    lr x sign(gradient), so it turns such a difference into a step of up to
    2 x lr: the card's step on its own gradients is reported beside."""
    import numpy as np

    from xclip_tpu_torch.sae import losses, model as sae_model, optim as sae_optim, pipeline

    params = sae_model.sae_init(torch.Generator().manual_seed(1), sae_model.SAECfg(SAE_D, SAE_M, 1))
    batch = torch.from_numpy(store[-SAE_BATCH:, None, :]).float()
    tree_map, leaves = sae_model.tree_map, sae_model.tree_leaves

    def step(device, tap):
        p = tree_map(lambda t: t.to(device), params)
        adam = sae_optim.adam(1e-4)
        tap.adam = adam
        new, metrics, fired = pipeline.train_step(p, tap, adam.init(p), losses.SAELossCfg(3e-4), batch.to(device))
        return float(metrics["total_loss"]), sae_model.sae_params_to_numpy(new), fired.cpu()

    def scale_err(got, want):
        return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(leaves(got), leaves(want)))

    cpu_tap, own_tap = _GradTap(None, tree_map), _GradTap(None, tree_map)
    loss_cpu, p_cpu, fired_cpu = step("cpu", cpu_tap)
    loss_card, p_own, fired_card = step("cuda", own_tap)
    _, p_card, _ = step("cuda", _GradTap(None, tree_map, replace=cpu_tap.grads))
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_errs = {name: norm_rel_err(a, b) for name, a, b in zip(("tied_bias", "encoder.weight", "encoder.bias",
                                                                 "decoder.weight"),
                                                                leaves(own_tap.grads), leaves(cpu_tap.grads))}
    grad_max_errs = [rel_err(a, b) for a, b in zip(leaves(own_tap.grads), leaves(cpu_tap.grads))]
    param_err = scale_err(p_card, p_cpu)
    own_err = scale_err(p_own, p_cpu)
    fired_diff = int((fired_card - fired_cpu).abs().sum())
    log(f"  fp32 SAE step {SAE_D} -> {SAE_M}, batch {SAE_BATCH}, card vs CPU: loss rel err {loss_err:.3g} "
        f"(tolerance {SAE_STEP_RTOL}); gradients ||card - CPU|| / ||CPU|| "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} } (tolerance {SAE_PARAM_TOL}; largest element "
        f"{max(grad_max_errs):.3g} of scale; {fired_diff} (item, neuron) firings differ); parameters after the step "
        f"from the same gradients {param_err:.3g} of scale (tolerance {SAE_PARAM_TOL}), from each device's own "
        f"{own_err:.3g}")
    if not math.isfinite(loss_card) or loss_err > SAE_STEP_RTOL or max(grad_errs.values()) > SAE_PARAM_TOL \
            or param_err > SAE_PARAM_TOL:
        fail("card and CPU disagree on the fp32 SAE step")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_errs, "grad_max_rel_err": max(grad_max_errs),
            "fired_differences": fired_diff, "param_rel_err": param_err, "param_rel_err_own_gradients": own_err}


def phase_supervised_kernels(torch, fused_conv, rn50):
    """Phase 3d: K3, K1 and K2 in bf16 at the RN50 classifier's training
    shapes (batch 256, no accumulation: layer 1 reaches M = 256 x 56 x 56 =
    802,816 rows, a 411 MB operand): against the plain versions, timed with
    the plain version, one library call and the bound. K3 runs every conv1,
    K1 every downsample, K2 every conv3 of a train-mode forward."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    dt, dname = torch.bfloat16, "bf16"
    shapes = fused_conv_shapes(rn50.vision, SUP_BATCH)
    unique = {}
    for role, m, k, c, ident, _ in shapes:
        kid = {"conv1": "K3", "downsample": "K1", "conv3": "K2"}[role]
        unique.setdefault((kid, m, k, c), []).append(role)
    records, errs = [], {}
    for (kid, m, k, c), roles in unique.items():
        z = torch.randn(m, k, device="cuda", generator=gen).to(dt)
        w = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dt)
        if kid == "K3":
            y, s1, s2 = fused_conv.matmul_stats(z, w)
            ry, r1, r2 = fused_conv.matmul_stats_plain(z, w)
            torch.cuda.synchronize()
            ok, err = close(y, ry, TOLERANCE[dname])
            ok = ok and max(rel_err(s1, r1), rel_err(s2, r2)) <= STATS_TOL
            del y, s1, s2, ry, r1, r2
            fns = {"kernel_ms": lambda: fused_conv.matmul_stats(z, w),
                   "plain_ms": lambda: fused_conv.matmul_stats_plain(z, w),
                   "library_ms": lambda: (lambda y: (y.sum(dim=0, dtype=torch.float32),
                                                     (y * y).sum(dim=0, dtype=torch.float32)))(torch.matmul(z, w))}
            nbytes = (m * k + k * c + m * c) * 2 + 2 * c * 4
        else:
            g = torch.rand(c, device="cuda", generator=gen) + 0.5
            b = torch.randn(c, device="cuda", generator=gen) * 0.1
            idn = torch.randn(m, c, device="cuda", generator=gen).to(dt) if kid == "K2" else None
            relu = kid == "K2"
            got = fused_conv.matmul_affine_act(z, w, g, b, idn, relu=relu)
            ok, err = close(got, fused_conv.matmul_affine_act_plain(z, w, g, b, idn, relu=relu), TOLERANCE[dname])
            del got

            def library(z=z, w=w, g=g, b=b, idn=idn, relu=relu):
                y = torch.matmul(z, w)
                y.mul_(g.to(y.dtype)).add_(b.to(y.dtype))
                if idn is not None:
                    y.add_(idn)
                return y.relu_() if relu else y

            fns = {"kernel_ms": lambda: fused_conv.matmul_affine_act(z, w, g, b, idn, relu=relu),
                   "plain_ms": lambda: fused_conv.matmul_affine_act_plain(z, w, g, b, idn, relu=relu),
                   "library_ms": library}
            nbytes = (m * k + k * c + m * c * (2 if idn is not None else 1)) * 2 + 2 * c * 4
        errs[kid] = max(errs.get(kid, 0.0), err)
        if not ok:
            fail(f"{kid} bf16 at the classifier's shape M={m} K={k} C={c}: max_abs_err {err}")
        rec = {"kernel": kid, "dtype": dname, "M": m, "K": k, "C": c, "count_per_batch": len(roles),
               "max_abs_err": err, **{key: time_ms(fn) for key, fn in fns.items()}}
        bound(rec, 2.0 * m * k * c, nbytes, dname)
        share(rec)
        records.append(rec)
        log(f"  {kid} bf16 M={m} K={k} C={c} x{len(roles)} (classifier, batch {SUP_BATCH}): "
            f"kernel_ms={rec['kernel_ms']:.4f} plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) share_of_bound={rec['share_of_bound']:.3f} "
            f"max_abs_err={err:.3g}")
        del z, w
        torch.cuda.empty_cache()
    return records, errs


def make_combined_tree(root: str, seed: int = 0):
    """Seeded CombinedNet tree of 256-px JPEGs for the supervised baseline:
    wnid folders from ``data/imagenet_class_index.json`` (SUP_FOLDED of them
    classes that ``data/in_to_dn_mapping.json`` folds into DomainNet
    classes), DomainNet class folders from the mapping's keys; a 1,024-row
    train TSV and a 256-row val TSV. Returns (train TSV, val TSV, labels of
    the folders by the mapping)."""
    import numpy as np
    from PIL import Image

    with open(os.path.join(REPO, "data", "imagenet_class_index.json")) as fh:
        index = json.load(fh)
    with open(os.path.join(REPO, "data", "in_to_dn_mapping.json")) as fh:
        mapping = json.load(fh)
    folded = sorted({i for v in mapping.values() if v for i in v})
    kept = [i for i in range(1000) if i not in set(folded)]
    rng = np.random.RandomState(seed)
    wnids = ([index[str(i)][0] for i in rng.choice(kept, SUP_WNIDS - SUP_FOLDED, replace=False)]
             + [index[str(i)][0] for i in rng.choice(folded, SUP_FOLDED, replace=False)])
    dn = [c.replace(" ", "_") for c in rng.choice(list(mapping), SUP_DN_CLASSES, replace=False)]
    folders = wnids + dn
    per_train, per_val = SUP_TRAIN_ROWS // len(folders), SUP_VAL_ROWS // len(folders)
    rows = {"train": [], "val": []}
    for split, per in (("train", per_train), ("val", per_val)):
        for folder in folders:
            for j in range(per):
                path = os.path.join(root, split, folder, f"{j}.jpg")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(rng.randint(0, 256, (256, 256, 3), np.uint8)).save(path, quality=90)
                rows[split].append(f"{path}\ta photo.")
    out = []
    for split in ("train", "val"):
        order = rng.permutation(len(rows[split]))
        tsv = os.path.join(root, f"{split}.tsv")
        with open(tsv, "w") as fh:
            fh.write("filepath\ttitle\n" + "".join(rows[split][i] + "\n" for i in order))
        out.append(tsv)
    return out[0], out[1]


def supervised_path_counts(cfg, steps: int, val_batches: int, eval_batches: int = 0) -> dict:
    """Exact launches and backward calls of the supervised path: each
    training step's train-mode forward (K3 every conv1, K1 every downsample,
    K2 every conv3; K4 every ViT layer) and each Function's backward once,
    then the eval-mode forward of each validation batch and each batch of
    the supervised LSO evaluation (K1 every conv1 and downsample, K2 every
    conv3; K4 every layer)."""
    if isinstance(cfg.vision.layers, (list, tuple)):
        blocks, stages = sum(cfg.vision.layers), len(cfg.vision.layers)
        fwd = {"K1": stages, "K2": blocks, "K3": blocks, "K4": 0}
        evals = {"K1": blocks + stages, "K2": blocks, "K3": 0, "K4": 0}
        bwd = {"K1/K2 backward": blocks + stages, "K3 backward": blocks, "K4 backward": 0}
    else:
        layers = cfg.vision.layers
        fwd = {"K1": 0, "K2": 0, "K3": 0, "K4": layers}
        evals = dict(fwd)
        bwd = {"K1/K2 backward": 0, "K3 backward": 0, "K4 backward": layers}
    counts = {k: steps * fwd[k] + (val_batches + eval_batches) * evals[k] for k in fwd}
    counts.update({k: steps * v for k, v in bwd.items()})
    return counts


class LogLines:
    """Collects the log lines of a CLI that installs its own root handlers
    (``utils.meters.setup_logging``) and puts chip_smoke's handlers back."""

    def __init__(self, module):
        self.module, self.lines = module, []

    def __enter__(self):
        import logging as _logging

        self.saved = list(_logging.root.handlers), _logging.root.level
        real = self.module.setup_logging
        lines = self.lines

        class Collect(_logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        def setup(*a, **kw):
            handlers = real(*a, **kw) + [Collect()]
            _logging.root.addHandler(handlers[-1])
            return handlers

        self.module.setup_logging = setup
        self.real = real
        return self

    def __exit__(self, *exc):
        import logging as _logging

        self.module.setup_logging = self.real
        for h in list(_logging.root.handlers):
            _logging.root.removeHandler(h)
        for h in self.saved[0]:
            _logging.root.addHandler(h)
        _logging.root.setLevel(self.saved[1])
        return False


def run_supervised_training(torch, fused_conv, flash_attention, sup_cli, model: str, epochs: int, tsvs, ws: str):
    """``train_combined_captions.main`` for ``model`` at batch 256, bf16
    (``--precision 16-mixed``), checkpoints every epoch; returns (counts,
    wall seconds, the CLI's log lines, its checkpoint directory)."""
    argv = ["--model", model, "--train_index_path", tsvs[0], "--val_index_path", tsvs[1],
            "--in_class_index_path", os.path.join(REPO, "data", "imagenet_class_index.json"),
            "--class_mapping_path", os.path.join(REPO, "data", "in_to_dn_mapping.json"),
            "--experiment_name", model, "--batch_size", str(SUP_BATCH), "--max_epochs", str(epochs),
            "--save_epochs", "1", "--precision", "16-mixed", "--num_workers", "16", "--seed", "0",
            "--ws_path", ws, "--device", "cuda"]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    with LogLines(sup_cli) as logs:
        rc = sup_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = train_counts(fused_conv, flash_attention)
    if rc != 0:
        fail(f"train_combined_captions.main {model} returned {rc}")
    return counts, wall, logs.lines, os.path.join(ws, "checkpoints", model)


def check_supervised_logs(lines, epochs: int, model: str) -> list:
    """The CLI's step lines (step 0 of each epoch at 4 steps an epoch) with
    finite losses and img/s, and one validation line per epoch; returns the
    logged losses."""
    steps = [ln for ln in lines if " step " in ln and ln.endswith("img/s)")]
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in steps]
    done = [ln for ln in lines if " done: val_loss " in ln]
    if len(steps) != epochs or len(done) != epochs or not all(math.isfinite(v) for v in losses):
        fail(f"{model}: expected {epochs} step and validation log lines with finite losses, found {steps} {done}")
    for ln in done:
        if not math.isfinite(float(ln.split("val_loss ")[1].split()[0])):
            fail(f"{model}: non-finite validation loss: {ln}")
    return losses


def phase_supervised(torch, factory, fused_conv, flash_attention, card: str):
    """Phase 5f: the supervised baseline at full width (see the module
    docstring); returns (counts by run, report)."""
    from xclip_tpu_torch.scripts import evaluate_domainnet_supervised_lso as sup_eval
    from xclip_tpu_torch.scripts import train_combined_captions as sup_cli
    from xclip_tpu_torch.train import learner

    rn50, vit = factory.get_clip_cfg("RN50"), factory.get_clip_cfg(SUP_VIT)
    t0 = time.perf_counter()
    tsvs = make_combined_tree(os.path.join(SCRATCH, "combined"))
    log(f"  CombinedNet tree: {SUP_TRAIN_ROWS} + {SUP_VAL_ROWS} JPEGs (256 px) in {time.perf_counter() - t0:.1f} s")
    ws = os.path.join(SCRATCH, "supervised")
    report, counts = {}, {}
    steps = SUP_TRAIN_ROWS // SUP_BATCH

    # RN50 classifier: 2 epochs of 4 steps
    c, wall, lines, ckpt_dir = run_supervised_training(torch, fused_conv, flash_attention, sup_cli, "rn50-clip",
                                                       SUP_RN_EPOCHS, tsvs, ws)
    losses = check_supervised_logs(lines, SUP_RN_EPOCHS, "rn50-clip")
    names = sorted(os.listdir(ckpt_dir))
    want_names = sorted(["epoch=0-step=0.npz", "last.npz"] + [f"epoch={e}.npz" for e in range(1, SUP_RN_EPOCHS + 1)])
    want = supervised_path_counts(rn50, steps * SUP_RN_EPOCHS, SUP_RN_EPOCHS)
    log(f"  train_combined_captions rn50-clip, batch {SUP_BATCH}, bf16: {steps * SUP_RN_EPOCHS} steps in {wall:.1f} s "
        f"incl. model and loader start; logged losses {losses}; checkpoints {names}")
    log(f"  launches {c} (expected {want})")
    if names != want_names:
        fail(f"rn50-clip checkpoints {names}, expected {want_names}")
    if c != want:
        fail(f"supervised RN50 counts {c} differ from the path's {want}")
    model = learner.create_classifier(learner.ClassifierCfg(model="rn50-clip"), device="cuda")
    extras = learner.load_classifier(os.path.join(ckpt_dir, "last.npz"), model)
    if extras != {"epoch": SUP_RN_EPOCHS}:
        fail(f"last.npz extras {extras}")
    counts["train_supervised_rn50"] = c
    report["rn50"] = {"wall_s": wall, "logged_losses": losses, "log_lines": lines, "checkpoints": names}

    # one steady-state step, timed and profiled
    report["rn50"]["steady_state"] = supervised_step_timing(torch, learner, "rn50-clip", rn50)

    # the supervised LSO evaluation over the three epoch=*.npz files, phase 4's DomainNet tree
    ckpts = [os.path.join(ckpt_dir, n) for n in names if n.startswith("epoch=")]
    out = os.path.join(ws, "lso-eval-sketch")
    n_dn = 2 * N_DOMAINNET_CLASSES
    eval_batches = len(ckpts) * math.ceil(n_dn / BATCH)
    argv = ["--model", "rn50-clip", "--domain", "sketch", "--ckpt_files", *reversed(ckpts), "--out_path", out,
            "--domainnet_path", os.path.join(SCRATCH, "tree", "domainnet"), "--num_workers", "8", "--device", "cuda"]
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc = sup_eval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = train_counts(fused_conv, flash_attention)
    want = supervised_path_counts(rn50, 0, 0, eval_batches)
    with open(os.path.join(out, "results.json")) as fh:
        results = json.load(fh)
    acc = results["domainnet-val"]["accuracy"]
    log(f"  evaluate_domainnet_supervised_lso: {len(ckpts)} checkpoints x {n_dn} images (batches of {BATCH}, "
        f"ragged tail {n_dn % BATCH}) in {wall:.2f} s; steps {results['steps']}; sketch-lso-id "
        f"{acc['sketch-lso-id']}; launches {c} (expected {want})")
    if rc != 0 or results["steps"] != [0, 1, 2] or results["domain"] != "sketch" or results["imagenet-val"] != {
            "accuracy": {}}:
        fail(f"supervised evaluation: rc {rc}, steps {results['steps']}, imagenet-val {results['imagenet-val']}")
    for key in ("sketch-lso-ood", "sketch-lso-id", "real-lso-ood", "real-lso-id", "sketch-lso-unweighted-id",
                "real-lso-unweighted-ood", "sketch-banana-ood"):
        if len(acc.get(key, [])) != 3 or not all(math.isfinite(v) and 0 <= v <= 1 for v in acc[key]):
            fail(f"supervised results.json accuracy[{key!r}] = {acc.get(key)}")
    if c != want:
        fail(f"supervised evaluation counts {c} differ from the path's {want}")
    counts["eval_supervised_rn50"] = c

    # 8 images' fp32 logits of the last checkpoint, card vs CPU
    cpu = learner.create_classifier(learner.ClassifierCfg(model="rn50-clip"), device="cpu")
    learner.load_classifier(ckpts[-1], cpu)
    learner.load_classifier(ckpts[-1], model)
    x = torch.randn(SUP_CHECK, rn50.image_size, rn50.image_size, 3, generator=torch.Generator().manual_seed(16))
    with torch.no_grad():
        got, ref = model(x.cuda()).cpu(), cpu(x)
    ok, err = close(got, ref, SUP_CHECK_TOL)
    log(f"  fp32 logits of {SUP_CHECK} images, {os.path.basename(ckpts[-1])}, card vs CPU: max_abs_err {err:.3g} "
        f"(largest |logit| {float(ref.abs().max()):.3g}; tolerance {SUP_CHECK_TOL} + {SUP_CHECK_TOL} |ref|)")
    if not ok:
        fail("supervised classifier: card and CPU disagree in fp32")
    report["eval"] = {"wall_s": wall, "results": results, "card_vs_cpu_max_abs_err": err}
    del model, cpu
    torch.cuda.empty_cache()

    # ViT-B-32 classifier: 1 epoch of 4 steps
    c, wall, lines, ckpt_dir = run_supervised_training(torch, fused_conv, flash_attention, sup_cli, "vit-b-32-clip",
                                                       SUP_VIT_EPOCHS, tsvs, ws)
    losses = check_supervised_logs(lines, SUP_VIT_EPOCHS, "vit-b-32-clip")
    want = supervised_path_counts(vit, steps * SUP_VIT_EPOCHS, SUP_VIT_EPOCHS)
    log(f"  train_combined_captions vit-b-32-clip, batch {SUP_BATCH}, bf16: {steps} steps in {wall:.1f} s; logged "
        f"losses {losses}; launches {c} (expected {want})")
    if c != want:
        fail(f"supervised ViT-B-32 counts {c} differ from the path's {want}")
    model = learner.create_classifier(learner.ClassifierCfg(model="vit-b-32-clip"), device="cuda")
    learner.load_classifier(os.path.join(ckpt_dir, f"epoch={SUP_VIT_EPOCHS}.npz"), model)
    with torch.no_grad():
        logits = model(torch.randn(4, vit.image_size, vit.image_size, 3, device="cuda"), torch.bfloat16)
    if logits.shape != (4, 1345) or not torch_all_finite(logits):
        fail(f"vit-b-32-clip epoch={SUP_VIT_EPOCHS}.npz does not give finite logits")
    del model
    torch.cuda.empty_cache()
    counts["train_supervised_vit_b32"] = c
    report["vit_b32"] = {"wall_s": wall, "logged_losses": losses, "log_lines": lines,
                         "steady_state": supervised_step_timing(torch, learner, "vit-b-32-clip", vit)}

    # one fp32 SGD step of a tiny RN classifier, card vs CPU
    report["tiny_card_vs_cpu"] = supervised_card_vs_cpu(torch, factory, learner)
    report["card"] = card
    return counts, report


def supervised_step_timing(torch, learner, model: str, cfg) -> dict:
    """One steady-state bf16 step of the 1345-way classifier at batch 256 on
    fixed device batches: CUDA events after two warm-up steps, its images/s
    and peak memory, then torch.profiler over one more step (top device
    ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    clf = learner.create_classifier(learner.ClassifierCfg(model=model), device="cuda").train()
    step, _ = learner.make_classifier_train_step(clf, steps_per_epoch=4, precision="bf16")
    gen = torch.Generator(device="cuda").manual_seed(17)
    images = torch.randint(0, 256, (SUP_BATCH, cfg.image_size, cfg.image_size, 3), device="cuda",
                           dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 1345, (SUP_BATCH,), device="cuda", generator=gen)
    for _ in range(2):
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    m = step(images, labels)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    step_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not math.isfinite(float(m["loss"])):
        fail(f"{model}: non-finite loss in the timed step")
    log(f"  {model} steady-state step, batch {SUP_BATCH}, bf16: {step_ms:.1f} ms (CUDA events; host {host_ms:.1f} ms), "
        f"{SUP_BATCH / step_ms * 1e3:.1f} img/s, peak memory {peak_gb:.2f} GB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images, labels)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(f"  profiler: device time over one step: {total:.1f} ms ({100 * total / step_ms:.1f} % of the step)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f} % x{count:<5d} {key[:110]}")
    del clf, step, images
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "host_step_ms": host_ms, "images_per_s": SUP_BATCH / step_ms * 1e3,
            "peak_memory_gb": peak_gb, "profiled_device_ms": total,
            "top": [{"kernel": k, "ms": ms, "count": c} for k, ms, c in rows[:12]]}


def supervised_card_vs_cpu(torch, factory, learner) -> dict:
    """One fp32 SGD step of the tiny RN classifier (phase 5b's config, 1345
    classes, 16 images) on the card and on the CPU: loss, every gradient (of
    its largest element, floored at 1e-4) and the BatchNorm running
    statistics after the step."""
    import numpy as np

    factory._MODEL_CONFIGS[TINY_RN] = TINY_RN_CFG
    cls = learner.ClassifierCfg
    saved = cls.backbone_name, cls.feature_dim
    cls.backbone_name = property(lambda self: TINY_RN)
    cls.feature_dim = property(lambda self: TINY_RN_CFG["embed_dim"])
    try:
        images, _ = tiny_batch(torch)
        labels = torch.from_numpy(np.random.RandomState(1).randint(0, 1345, len(images)).astype(np.int32))
        results = []
        for device in ("cpu", "cuda"):
            model = learner.create_classifier(cls(lr=1e-3), device=device).train()
            step, opt = learner.make_classifier_train_step(model, steps_per_epoch=1, precision="fp32")
            grads = {}  # read before the update: CUDA's foreach Nesterov SGD adds the momentum into .grad
            opt.register_step_pre_hook(lambda *_, m=model, g=grads: g.update(
                {n: p.grad.float().cpu() for n, p in m.named_parameters()}))
            m = step(images.to(device), labels.to(device))
            results.append((float(m["loss"]), grads, {n: b.cpu() for n, b in model.named_buffers() if "running" in n}))
    finally:
        cls.backbone_name, cls.feature_dim = saved
    (loss_cpu, g_cpu, b_cpu), (loss_gpu, g_gpu, b_gpu) = results
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = max(float((g_gpu[n] - g_cpu[n]).abs().max()) / max(float(g_cpu[n].abs().max()), 1e-4) for n in g_cpu)
    bn_err = max(float((b_gpu[n] - b_cpu[n]).abs().max()) / max(float(b_cpu[n].abs().max()), 1e-4) for n in b_cpu)
    log(f"  fp32 tiny RN classifier step, card vs CPU: loss rel err {loss_err:.3g}, worst gradient rel err "
        f"{grad_err:.3g}, worst running-statistic rel err {bn_err:.3g} (tolerance {TRAIN_CHECK_TOL})")
    if not math.isfinite(loss_gpu) or max(loss_err, grad_err, bn_err) > TRAIN_CHECK_TOL:
        fail("card and CPU disagree on the fp32 classifier step")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "bn_rel_err": bn_err}


# phase 8: the interpretability path (scripts/compute_circuits.py and the analyses after it)
INTERP_CLASSES = 30      # the tree's DomainNet classes 0-29 in every domain (5 LSO classes: 0, 11, 13, 15, 25)
INTERP_IMAGES = 16       # images of the circuit's class in real and sketch (the protocol's 50: cut)
INTERP_PER_CLASS = 2     # images of every other class in every domain
INTERP_LABEL = 0         # "aircraft carrier", an LSO (ood) class
INTERP_STEPS, INTERP_THRESHOLD = 10, 0.1  # compute_circuits' defaults
INTERP_CHECK = 2         # images whose node effects are held card vs CPU
INTERP_EDGE_CHECK = ("avgpool", "resblock1")  # the edge pair held card vs CPU
# card vs CPU, fp32, per stage: max |difference| over the largest |effect|
# (summation order through up to 16 bottlenecks, forward and backward)
INTERP_TOL = 1e-3
# cka_linear.json, card vs CPU: |difference| within INTERP_CKA_RTOL of the
# CPU's |value|, or of INTERP_CKA_FLOOR for values nearer 0 (the ood split
# has 5 class means); measured 1.1e-4 on H100 (a 9x margin)
INTERP_CKA_RTOL, INTERP_CKA_FLOOR = 1e-3, 0.1
INTERP_CKA_MEDIAN = 0.2  # the least median |CKA| at which the comparison is a witness
INTERP_VOCAB = 1000      # name_concepts' vocabulary: 4 chunks of 256 prompts


def make_interp_tree(root: str) -> int:
    """Seeded DomainNet tree for the interpretability path: in each domain's
    test split INTERP_PER_CLASS 64 x 48 JPEGs of each class
    0..INTERP_CLASSES-1, and INTERP_IMAGES of class INTERP_LABEL in real and
    sketch; class folders ``c{label}``. A class is a colour and a stripe
    pattern of its own, the same in every domain; a domain adds a tint, an
    image its noise. The class means then share their structure across
    domains, and the CKAs over them sit well above zero."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(8)
    colour = rng.randint(30, 200, (INTERP_CLASSES, 1, 1, 3))
    yy, xx = np.mgrid[0:48, 0:64]
    n = 0
    for domain in ("clipart", "infograph", "painting", "quickdraw", "real", "sketch"):
        tint = rng.randint(-20, 21, (1, 1, 3))
        rows = []
        for label in range(INTERP_CLASSES):
            count = INTERP_IMAGES if label == INTERP_LABEL and domain in ("real", "sketch") else INTERP_PER_CLASS
            along = (yy, xx, yy + xx)[label % 3]
            stripes = 0.5 + 0.5 * np.sin(2 * np.pi * along / (4 + 2 * (label // 3)))[..., None]
            for i in range(count):
                rel = f"{domain}/c{label}/{i}.jpg"
                os.makedirs(os.path.join(root, domain, f"c{label}"), exist_ok=True)
                img = colour[label, 0] * (0.4 + 0.6 * stripes) + tint + rng.randint(0, 40, (48, 64, 3))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, rel), quality=90)
                rows.append(f"{rel}\t{label}\ta {domain} of thing {label}.")
                n += 1
        with open(os.path.join(root, f"{domain}_test.tsv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return n


def interp_rn50_checkpoint(torch, factory, path: str, tree=None) -> None:
    """A seed-0 RN50 whose visual weights go through the JAX layout and back
    (``core.checkpoint.visual_pytrees_from_state_dict``, then
    ``visual_state_dict_from_jax``, the image half of
    ``state_dict_from_jax_params``), every BatchNorm drawn from a seed there
    as the CPU tests draw JAX's; saved as an open_clip ``.pt``.

    With ``tree``, the running statistics are then the tree's own: one
    train-mode forward of all its images on the card, at momentum 1. With
    random statistics the deep stages map every image to nearly one point,
    where the unbiased HSIC over the class means cancels many digits and
    fp32 rounding alone moves a CKA by percents; calibrated, as a trained
    tower's are, the classes stay apart. The circuits keep the random
    statistics: calibrated, many more pre-activations sit within rounding
    of the relu's kink, and a mask that flips between two fp32 runs moves
    a gradient by percents at its position."""
    import numpy as np

    from xclip_tpu_torch.core.checkpoint import visual_pytrees_from_state_dict, visual_state_dict_from_jax

    cfg = factory.get_clip_cfg("RN50")
    sd = factory.create_model("RN50", seed=0, device="cpu").state_dict()
    vp, vs = visual_pytrees_from_state_dict(sd, cfg)
    rng = np.random.RandomState(13)

    def walk(p, s):
        if isinstance(p, list):
            for pi, si in zip(p, s):
                walk(pi, si)
            return
        for key, sub in p.items():
            if key.startswith("bn") or key == "bn":
                c = sub["scale"].shape[0]
                sub["scale"] = (rng.rand(c) + 0.5).astype(np.float32)
                sub["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
                s["downsample_bn" if key == "bn" else key] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                                                              "var": (rng.rand(c) + 0.5).astype(np.float32)}
            elif isinstance(sub, (dict, list)) and key in s:
                walk(sub, s[key])
            elif key == "downsample":
                walk(sub, s)

    walk(vp, vs)
    sd.update(visual_state_dict_from_jax(vp, vs, cfg))
    if tree is not None:
        sd = calibrated_bn_state_dict(torch, factory, sd, tree)
    torch.save({"epoch": 32, "name": "chip_smoke", "state_dict": sd}, path)


def calibrated_bn_state_dict(torch, factory, sd: dict, tree: str) -> dict:
    """``sd`` with every BatchNorm's running statistics taken from one
    train-mode forward of all of ``tree``'s images on the card."""
    import numpy as np

    from xclip_tpu_torch.data.datasets import DomainNetCaptions
    from xclip_tpu_torch.data.transforms import image_transform
    from xclip_tpu_torch.models import layers
    from xclip_tpu_torch.models.resnet import apply_bn_moments

    model = factory.create_model("RN50", seed=0, device="cuda")
    model.load_state_dict(sd)
    data = DomainNetCaptions(tree, "val", image_transform(model.cfg.image_size), exclude_domains=[])
    images = torch.from_numpy(np.stack([data[i][0] for i in range(len(data))])).cuda()
    moments = {}
    momentum, layers.BN_MOMENTUM = layers.BN_MOMENTUM, 1.0
    try:
        model.visual.train()
        with torch.no_grad():
            model.visual(images, moments=moments)
    finally:
        layers.BN_MOMENTUM = momentum
    apply_bn_moments(model.visual, moments)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, images
    torch.cuda.empty_cache()
    return sd


def hsic1_cancellation(means) -> float:
    """How many times the unbiased HSIC1(K, K)'s three terms exceed their
    sum, K the linear gram of ``means`` in float64: the factor by which the
    estimator magnifies the activations' rounding (ROADMAP C4)."""
    import numpy as np

    x = np.asarray(means, np.float64)
    k = x @ x.T
    np.fill_diagonal(k, 0.0)
    n, kk = k.shape[0], k @ k
    terms = (np.trace(kk), k.sum() ** 2 / ((n - 1) * (n - 2)), 2.0 / (n - 2) * kk.sum())
    return float(sum(abs(t) for t in terms) / abs(terms[0] + terms[1] - terms[2]))


def interp_passes(cm, n_images: int, steps: int, device):
    """The tower passes of one compute_class_circuit, from the attribution's
    chunking: (images in the pass, bottlenecks it runs, whether a backward
    follows). A no-grad forward of the whole tower (the clean activations)
    for the nodes and for each edge pair; per chunk of IG copies one forward
    and one backward through the bottlenecks of its segment."""
    import math

    from xclip_tpu_torch.interp import attribution

    stages = cm.stages
    # the bottleneck each stage runs (flattened block number), None outside the resblocks
    block = [int(s.name[len("resblock"):]) - 1 if s.name.startswith("resblock") else None for s in stages]
    everything = [b for b in block if b is not None]
    passes = [(n_images, everything, False)] * len(stages)  # 1 + 21 clean forwards
    copies = steps * n_images
    for i, s in enumerate(stages):  # nodes: from each stage to the head
        after = [b for b in block[i + 1:] if b is not None]
        for size in attribution.chunk_sizes(copies, cm.segment_elements(s.name), device):
            passes.append((size, after, True))
    for i in range(1, len(stages)):  # edges: one segment per downstream neuron copy
        n_down = math.ceil(stages[i].channels * INTERP_THRESHOLD)
        own = [block[i]] if block[i] is not None else []
        for size in attribution.chunk_sizes(n_down * copies, cm.segment_elements(stages[i - 1].name, stages[i].name),
                                            device):
            passes.append((size, own, True))
    return passes


def interp_counts(cm, n_images: int, steps: int, device) -> dict:
    """K1/K2 launches and MatmulAffineAct backward calls of one
    compute_class_circuit (:func:`interp_passes`): conv1 and conv3 of every
    bottleneck a pass runs, and the downsample where there is one."""
    shapes = block_conv_shapes(cm.cfg, 1)
    counts = {"K1": 0, "K2": 0, "K1/K2 backward": 0}
    for _, blocks, backward in interp_passes(cm, n_images, steps, device):
        for b in blocks:
            k2 = sum(s[4] for s in shapes[b])
            counts["K1"] += len(shapes[b]) - k2
            counts["K2"] += k2
            counts["K1/K2 backward"] += len(shapes[b]) if backward else 0
    return counts


def interp_kernel_shapes(cm, n_images: int, steps: int, device) -> set:
    """Every (M, K, C, identity, relu) that K1/K2 launch at in one
    compute_class_circuit (:func:`interp_passes`)."""
    shapes = set()
    for size, blocks, _ in interp_passes(cm, n_images, steps, device):
        per_block = block_conv_shapes(cm.cfg, size)
        shapes.update(s[1:] for b in blocks for s in per_block[b])
    return shapes


def phase_interp(torch, factory, fused_conv, flash_attention, card: str):
    """The interpretability path at full RN50 width, fp32 (see the module
    docstring, phase 8)."""
    import math

    import numpy as np

    from xclip_tpu_torch.evals.zero_shot import OpenAIZeroShotClassifier
    from xclip_tpu_torch.interp import attribution, circuits
    from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel
    from xclip_tpu_torch.interp.cka import class_mean_activations
    from xclip_tpu_torch.interp.dictionary import IdentityDict
    from xclip_tpu_torch.sae import model as sae_model
    from xclip_tpu_torch.scripts import (analyze_sae_features, compute_circuit_similarity, compute_circuits,
                                         compute_node_similarity, name_concepts, representational_analysis)
    from xclip_tpu_torch.tokenizer import get_tokenizer

    from xclip_tpu_torch.models.resnet import resnet_stage_names

    out: dict = {"card": card, "wall_s": {}}
    n_stages = len(resnet_stage_names(factory.get_clip_cfg("RN50").vision)) + 1  # 22 submodules with the input
    t0 = time.perf_counter()
    tree = os.path.join(SCRATCH, "interp_domainnet")
    n_jpegs = make_interp_tree(tree)
    model_dir = os.path.join(SCRATCH, "interp_rn50")
    os.makedirs(os.path.join(model_dir, "checkpoints"))
    ckpt = os.path.join(model_dir, "checkpoints", "epoch_32.pt")
    interp_rn50_checkpoint(torch, factory, ckpt)
    cka_dir = os.path.join(SCRATCH, "interp_rn50_calibrated")  # the CKA's model
    os.makedirs(os.path.join(cka_dir, "checkpoints"))
    interp_rn50_checkpoint(torch, factory, os.path.join(cka_dir, "checkpoints", "epoch_32.pt"), tree)
    out["wall_s"]["setup"] = time.perf_counter() - t0
    log(f"  {n_jpegs} JPEGs, seeded RN50 .pt and a copy with BatchNorm statistics from the tree in "
        f"{out['wall_s']['setup']:.1f} s; class {INTERP_LABEL}, {INTERP_IMAGES} images in real and sketch (the protocol's --samples_per_class 50: "
        f"cut to {INTERP_IMAGES}), steps {INTERP_STEPS}, node_threshold {INTERP_THRESHOLD}")

    # --- compute_circuits for one class in two domains, timed by part
    timing = {"nodes": [], "edges": []}
    grads_seen = {}
    orig_nodes, orig_edges = circuits.compute_nodes, circuits.compute_edges

    def timed(name, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start.record()
            res = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            timing[name].append({"event_ms": start.elapsed_time(end), "wall_s": time.perf_counter() - h0})
            if name == "nodes":
                grads_seen.update(res[1][2])
            return res
        return run

    circuits.compute_nodes, circuits.compute_edges = timed("nodes", orig_nodes), timed("edges", orig_edges)
    zero_counts(fused_conv, flash_attention)
    torch.cuda.reset_peak_memory_stats()
    try:
        for domain in ("real", "sketch"):
            t1 = time.perf_counter()
            if compute_circuits.main(["--model", "RN50", "--model_dir", model_dir, "--domain", domain,
                                      "--class_idx", str(INTERP_LABEL), "--domainnet_path", tree,
                                      "--samples_per_class", str(INTERP_IMAGES)]) != 0:
                fail(f"compute_circuits failed for {domain}")
            out["wall_s"][f"compute_circuits_{domain}"] = time.perf_counter() - t1
            bad = [name for name, g in grads_seen.items()
                   if g is None or g.act is None or not torch_all_finite(g.act) or not bool((g.act != 0).any())]
            if bad or len(grads_seen) != n_stages:
                fail(f"{domain}: mean IG gradients None, non-finite or all zero at {bad} ({len(grads_seen)} stages)")
            grads_seen.clear()
    finally:
        circuits.compute_nodes, circuits.compute_edges = orig_nodes, orig_edges
    counts = train_counts(fused_conv, flash_attention)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["timing"] = timing

    # the counts the chunking gives, one zero-shot head (86 templates, chunks of 2048) per CLI run
    model = factory.create_model("RN50", pretrained=ckpt, device="cuda")
    cfg = model.cfg
    cm_probe = VisualCircuitModel(model, np.zeros((1, cfg.embed_dim), np.float32))
    card_dev = next(model.parameters()).device
    per_run = interp_counts(cm_probe, INTERP_IMAGES, INTERP_STEPS, card_dev)
    want = {k: 2 * v for k, v in per_run.items()}
    want["K4"] = 2 * math.ceil(INTERP_CLASSES * N_TEMPLATES / TEXT_CHUNK) * cfg.text.layers
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"phase 8 circuit counts {got} differ from the chunking's {want}")
    out["counts"] = counts
    for domain in ("real", "sketch"):
        base = os.path.join(model_dir, "circuit_analysis", domain)
        with np.load(os.path.join(base, f"{INTERP_LABEL}_edges.npz")) as z:
            if len(z.files) != n_stages - 1 or not all(np.isfinite(z[k]).all() for k in z.files):
                fail(f"{domain}: {len(z.files)} edge pairs, or non-finite edges")
        with np.load(os.path.join(base, f"{INTERP_LABEL}_nodes.npz")) as z:
            if len(z.files) != n_stages:
                fail(f"{domain}: {len(z.files)} node sets")
    nodes_ms = [t["event_ms"] for t in timing["nodes"]]
    edges_ms = [t["event_ms"] for t in timing["edges"]]
    log(f"  compute_circuits: real {out['wall_s']['compute_circuits_real']:.1f} s, sketch "
        f"{out['wall_s']['compute_circuits_sketch']:.1f} s (wall); nodes {', '.join(f'{v:.0f}' for v in nodes_ms)} ms, "
        f"edges {', '.join(f'{v:.0f}' for v in edges_ms)} ms (CUDA events); peak memory "
        f"{out['peak_memory_gb']:.2f} GB; {card}")
    log(f"  launches: K1 {counts['K1']}, K2 {counts['K2']}, MatmulAffineAct backward {counts['K1/K2 backward']}, "
        f"K4 {counts['K4']} (the two zero-shot heads): as the chunking gives")
    sizes = sorted({n for n, blocks, _ in interp_passes(cm_probe, INTERP_IMAGES, INTERP_STEPS, card_dev) if blocks})
    out["kernel_shapes"] = check_fp32_shapes(
        torch, fused_conv, interp_kernel_shapes(cm_probe, INTERP_IMAGES, INTERP_STEPS, card_dev), "circuit path",
        f"passes of {sizes[0]} to {sizes[-1]} images or copies")

    # --- node effects (2 images, all 22 stages) and one edge pair, card vs CPU
    t1 = time.perf_counter()
    from xclip_tpu_torch.data.datasets import DomainNetCaptions
    from xclip_tpu_torch.data.transforms import image_transform

    data = DomainNetCaptions(tree, "val", image_transform(cfg.image_size),
                             exclude_domains=["clipart", "infograph", "painting", "quickdraw", "sketch"])
    idx = [i for i, s in enumerate(data.samples) if s[1] == INTERP_LABEL][:INTERP_CHECK]
    images = np.stack([data[i][0] for i in idx])
    classes = {s[1]: s[0].split("/")[-2] for s in data.samples}
    head = OpenAIZeroShotClassifier(model, get_tokenizer("RN50"), classes).prompt_feat
    cpu_model = factory.create_model("RN50", pretrained=ckpt, device="cpu")
    cms = {"cuda": VisualCircuitModel(model, head), "cpu": VisualCircuitModel(cpu_model, head)}
    subs = [s.name for s in cms["cpu"].stages]
    dicts = {s.name: IdentityDict(s.channels) for s in cms["cpu"].stages}
    nodes = {}
    for dev, cm in cms.items():
        eff = attribution.patching_effect(images, None, cm, subs, dicts, INTERP_LABEL, steps=INTERP_STEPS).effects
        nodes[dev] = {k: v.sum(axis=1).mean(axis=0).act.cpu().numpy() for k, v in eff.items()}
    node_errs = {k: float(np.abs(nodes["cuda"][k] - nodes["cpu"][k]).max() / max(np.abs(nodes["cpu"][k]).max(), 1e-30))
                 for k in subs}
    up, down = INTERP_EDGE_CHECK
    feats = {k: np.argsort(-np.abs(nodes["cpu"][k]))[:math.ceil(len(nodes["cpu"][k]) * INTERP_THRESHOLD)]
             for k in (up, down)}
    edge = {dev: attribution.upstream_neuron_attribution(images, None, cm, up, down, dicts, feats[up], feats[down],
                                                          steps=INTERP_STEPS) for dev, cm in cms.items()}
    edge_err = float(np.abs(edge["cuda"] - edge["cpu"]).max() / max(np.abs(edge["cpu"]).max(), 1e-30))
    out["card_vs_cpu"] = {"node_rel_err": node_errs, "edge_rel_err": edge_err, "images": INTERP_CHECK}
    out["wall_s"]["card_vs_cpu"] = time.perf_counter() - t1
    worst = max(node_errs, key=node_errs.get)
    log(f"  card vs CPU ({INTERP_CHECK} images, {n_stages} stages): node effects within {node_errs[worst]:.2e} of each "
        f"stage's largest ({worst} worst), edge {up}->{down} within {edge_err:.2e} (tolerance {INTERP_TOL}); "
        f"{out['wall_s']['card_vs_cpu']:.1f} s")
    if max(node_errs.values()) > INTERP_TOL or edge_err > INTERP_TOL or not math.isfinite(edge_err):
        fail(f"phase 8 card vs CPU: nodes {node_errs}, edge {edge_err}")
    del cms, cpu_model

    # --- node and circuit similarity over the two domains
    t1 = time.perf_counter()
    sims = os.path.join(SCRATCH, "interp_sims")
    compute_node_similarity.main(["--model_dir", model_dir, "--out_path", sims])
    for metric in ("jaccard", "wl"):
        compute_circuit_similarity.main(["--model_dir", model_dir, "--out_path", sims, "--metric", metric])
    with open(os.path.join(sims, "node_similarity.json")) as fh:
        ns = json.load(fh)
    sim = {"node": ns}
    for metric in ("jaccard", "wl"):
        with open(os.path.join(sims, f"circuit_similarity_{metric}.json")) as fh:
            sim[metric] = json.load(fh)
    vals = [v for layer in ns["ood"].values() for v in layer.values()]
    if len(ns["ood"]) != n_stages - 1 or not all(0 <= v <= 1 for v in vals) or not all(
            0 <= sim[m]["ood"]["real|sketch"] <= 1 + 1e-9 for m in ("jaccard", "wl")):
        fail(f"phase 8 similarities: {sim}")
    out["similarity"] = {"node_mean_ood": float(np.mean(vals)), "jaccard": sim["jaccard"]["ood"]["real|sketch"],
                         "wl": sim["wl"]["ood"]["real|sketch"]}
    out["wall_s"]["similarity"] = time.perf_counter() - t1
    log(f"  similarity real|sketch: nodes {out['similarity']['node_mean_ood']:.3f} (mean of {n_stages - 1} stages), edges "
        f"Jaccard {out['similarity']['jaccard']:.3f}, WL {out['similarity']['wl']:.3f}; "
        f"{out['wall_s']['similarity']:.1f} s")

    # --- CKA over the six domains, card vs CPU
    ckas, pooled = {}, {}
    capture = representational_analysis.capture_pooled_activations

    def recording_capture(model, dataset, batch_size, num_threads):  # the card's pooled activations by domain
        pooled[dataset.samples[0][0].split("/")[-3]] = res = capture(model, dataset, batch_size, num_threads)
        return res

    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        path = os.path.join(SCRATCH, f"interp_cka_{dev}")
        representational_analysis.capture_pooled_activations = recording_capture if dev == "cuda" else capture
        try:
            if representational_analysis.main(["--model", "RN50", "--model_dir", cka_dir, "--domainnet_path", tree,
                                               "--out_path", path, "--device", dev]) != 0:
                fail(f"representational_analysis on {dev}")
        finally:
            representational_analysis.capture_pooled_activations = capture
        with open(os.path.join(path, "cka_linear.json")) as fh:
            ckas[dev] = json.load(fh)
        out["wall_s"][f"cka_{dev}"] = time.perf_counter() - t1
    pairs = [(ckas["cuda"][sp][layer][pair], v) for sp in ckas["cpu"] for layer in ckas["cpu"][sp]
             for pair, v in ckas["cpu"][sp][layer].items() if math.isfinite(v)]
    rel = [abs(got - v) / max(abs(v), INTERP_CKA_FLOOR) for got, v in pairs]
    n_nan = sum(not math.isfinite(v) for sp in ckas["cuda"] for layer in ckas["cuda"][sp]
                for v in ckas["cuda"][sp][layer].values())
    median_cka = float(np.median([abs(v) for _, v in pairs])) if pairs else math.nan
    cancel = {name: max(hsic1_cancellation(class_mean_activations(acts[name], labels))
                        for acts, labels in pooled.values()) for name in pooled["real"][0]}
    out["cka"] = {"max_rel_diff": max(rel, default=math.nan), "values": len(pairs), "nan": n_nan,
                  "max_abs_diff": max((abs(got - v) for got, v in pairs), default=math.nan),
                  "min": min((v for _, v in pairs), default=math.nan), "median": median_cka,
                  "mean_all": float(np.nanmean([v for layer in ckas["cuda"]["all"].values() for v in layer.values()])),
                  "hsic1_cancellation": cancel}
    log(f"  CKA ({n_stages - 1} stages x 15 domain pairs x all/ood/id): card vs CPU within "
        f"{out['cka']['max_rel_diff']:.2e} of max(|CPU value|, {INTERP_CKA_FLOOR}) (tolerance {INTERP_CKA_RTOL}; "
        f"{out['cka']['max_abs_diff']:.2e} absolute) over {len(pairs)} values ({n_nan} NaN; median |CKA| "
        f"{median_cka:.3f}, min {out['cka']['min']:.3f}), card {out['wall_s']['cka_cuda']:.1f} s, CPU "
        f"{out['wall_s']['cka_cpu']:.1f} s; HSIC1(K, K) over a domain's class means cancels up to "
        f"{max(cancel.values()):.3g}-fold ({max(cancel, key=cancel.get)}; {cancel['stem.act1']:.3g} at stem.act1)")
    # a witness only where the class means carry structure: CKAs near 0 are
    # mostly the unbiased HSIC's cancellation (ROADMAP C4)
    if len(pairs) < (n_stages - 1) * 15 * 2 or median_cka < INTERP_CKA_MEDIAN or max(rel) > INTERP_CKA_RTOL:
        fail(f"phase 8 CKA card vs CPU: {out['cka']}")

    # --- SAE feature sharing and concept naming (a seeded 1024 -> 4096 SAE)
    t1 = time.perf_counter()
    sae_dir = os.path.join(SCRATCH, "interp_sae")
    os.makedirs(os.path.join(sae_dir, "checkpoints"))
    params = sae_model.sae_init(torch.Generator().manual_seed(21), sae_model.SAECfg(SAE_D, SAE_M, n_components=1))
    torch.save(sae_model.sae_params_to_state_dict(params),
               os.path.join(sae_dir, "checkpoints", "sparse_autoencoder_final.pt"))
    fs = os.path.join(SCRATCH, "interp_fs")
    if analyze_sae_features.main(["--ckpt_path", ckpt, "--sae_path", sae_dir, "--domainnet_path", tree,
                                  "--out_path", fs, "--domain", "sketch", "--num_workers", "2"]) != 0:
        fail("analyze_sae_features")
    with open(os.path.join(fs, "feature-sharing.json")) as fh:
        share_ = json.load(fh)
    score = share_["score"]["mpct_shared@20"]
    if not math.isfinite(score) or len(os.listdir(fs)) != 15 * 6 + 1:
        fail(f"analyze_sae_features: score {score}, {len(os.listdir(fs))} files")
    out["feature_sharing_score"] = score
    out["wall_s"]["analyze_sae_features"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    vocab = os.path.join(SCRATCH, "interp_vocab.txt")
    rng = np.random.RandomState(5)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    with open(vocab, "w") as fh:
        fh.write("\n".join("".join(rng.choice(letters, rng.randint(3, 10))) for _ in range(INTERP_VOCAB)) + "\n")
    zero_counts(fused_conv, flash_attention)
    if name_concepts.main(["--out_dir", sae_dir, "--vocab_file", vocab, "--ckpt_path", ckpt]) != 0:
        fail("name_concepts")
    k4 = flash_attention.launches
    want_k4 = math.ceil(INTERP_VOCAB / 256) * cfg.text.layers
    with open(os.path.join(sae_dir, "concepts", "concept_names.csv")) as fh:
        names = fh.read().splitlines()
    if k4 != want_k4 or len(names) != SAE_M:
        fail(f"name_concepts: K4 {k4} launches (want {want_k4}), {len(names)} names")
    out["counts"]["K4 name_concepts"] = k4
    out["wall_s"]["name_concepts"] = time.perf_counter() - t1
    log(f"  feature sharing score {score:.3f} ({out['wall_s']['analyze_sae_features']:.1f} s); name_concepts: "
        f"{len(names)} names from {INTERP_VOCAB} words, K4 {k4} launches ({out['wall_s']['name_concepts']:.1f} s)")
    del model
    torch.cuda.empty_cache()
    return {"K1": counts["K1"], "K2": counts["K2"], "K4": counts["K4"] + k4,
            "K1/K2 backward": counts["K1/K2 backward"]}, out


FAB_DN_COUNTS = {  # DomainNet's published (train, test) images per domain: 586,575 rows
    "clipart": (33525, 14604), "infograph": (36023, 15582), "painting": (50416, 21850),
    "quickdraw": (120750, 51750), "real": (120906, 52041), "sketch": (48212, 20916)}
FAB_IN_CAPTIONS = 10_000   # ImageNet-Captions entries (the dataset has 463,622: cut, each costs three file operations)
FAB_IN_SKETCH = 50_889     # ImageNet-Sketch's images over its 1,000 classes
FAB_CC3M = 300_000         # cc3m-train.tsv rows (CC3M has 3.3 M: cut)
FAB_MIXTURES = (           # PAPER_MIXTURES, as subsample_domainnet_lso builds each
    ("lso-rs-nosketchclasses", dict(exclude="sketch", single_domain=True, subsample=True)),
    ("lso-cipqrs-nosketchclasses", dict(exclude="sketch", subsample=True)),
    ("lso-cipqr-nosketchclasses", dict(exclude="sketch", exclude_domains=["sketch"], subsample=True)),
    ("lso-cr-noclipartclasses", dict(exclude="clipart", single_domain=True, subsample=True)),
    ("lso-cipqrs-noclipartclasses", dict(exclude="clipart", subsample=True)),
    ("lso-ipqrs-noclipartclasses", dict(exclude="clipart", exclude_domains=["clipart"], subsample=True)),
    ("lso-real-only", dict(real_only=True)),
)
WDS_STEPS = 4              # phase 10: one epoch of --train-num-samples 1024 at batch 128 x accum 2
WDS_SHARD = 512            # samples per tar shard
UMAP_N, UMAP_D = 20000, 1024  # phase 11: embedding_analysis at its own --max_points, RN50's width
UMAP_CHECK_N = 2000        # kNN and layout held card vs CPU on the first rows
UMAP_KNN_RTOL = 1e-4       # distances: the fp32 expansion |r|^2 - 2 r.x + |x|^2 rounds differently
UMAP_GRAD_TOL = 1e-4       # a layout epoch's gradient, card vs CPU, in relative norm
UMAP_CHECK_EPOCHS = 10


def imagenet_wnids() -> list:
    with open(os.path.join(REPO, "data", "imagenet_class_index.json")) as fh:
        index = json.load(fh)
    return [index[str(i)][0] for i in range(len(index))]


def lso_class_names(lso_class_to_idx) -> list:
    """345 DomainNet class folder names, the LSO classes at their indices."""
    names = [f"thing_{i}" for i in range(N_DOMAINNET_CLASSES)]
    for cls, idx in lso_class_to_idx.items():
        names[idx] = cls.replace(" ", "_")
    return names


def make_fabrication_inputs(root: str, lso_class_to_idx) -> dict:
    """DomainNet's lists at its published size, an ImageNet-Captions JSON
    and split of FAB_IN_CAPTIONS (empty) images, an ImageNet-Sketch tree of
    FAB_IN_SKETCH empty files and a CC3M list; all seeded. Returns the
    rows per (domain, split, class)."""
    import numpy as np

    rng = np.random.RandomState(0)
    names = lso_class_names(lso_class_to_idx)
    dn = os.path.join(root, "domainnet")
    os.makedirs(dn)
    per_class = {}
    for domain, totals in FAB_DN_COUNTS.items():
        for split, total in zip(("train", "test"), totals):
            counts = 5 + np.floor(rng.dirichlet(np.full(N_DOMAINNET_CLASSES, 2.0))
                                  * (total - 5 * N_DOMAINNET_CLASSES)).astype(int)
            counts[: total - counts.sum()] += 1
            per_class[domain, split] = counts
            with open(os.path.join(dn, f"{domain}_{split}.txt"), "w") as fh:
                fh.writelines(f"{domain}/{names[c]}/{domain}_{c:03d}_{j:06d}.jpg {c}\n"
                              for c in range(N_DOMAINNET_CLASSES) for j in range(counts[c]))
    wnids = imagenet_wnids()
    imagenet = os.path.join(root, "imagenet")
    in_train = os.path.join(imagenet, "captions")  # ImageNet-Captions' images, <wnid>/<file>
    for w in wnids:
        os.makedirs(os.path.join(in_train, w))
        os.makedirs(os.path.join(imagenet, "sketch", w))
    samples, split = [], {"train": [], "val": []}
    for i in range(FAB_IN_CAPTIONS):
        wnid, fname = wnids[i % len(wnids)], f"{wnids[i % len(wnids)]}_{i}.JPEG"
        open(os.path.join(in_train, wnid, fname), "wb").close()
        samples.append({"wnid": wnid, "filename": fname, "title": f"Photo  {i}",
                        "tags": [f"tag{i % 97}", "flickr"], "description": f"line one\nline two {i}"})
        split["train" if i % 10 else "val"].append(fname)
    with open(os.path.join(root, "imagenet_captions.json"), "w") as fh:
        json.dump(samples, fh)
    with open(os.path.join(root, "imagenet_captions_split.json"), "w") as fh:
        json.dump(split, fh)
    for j in range(FAB_IN_SKETCH):
        open(os.path.join(imagenet, "sketch", wnids[j % len(wnids)], f"sketch_{j}.JPEG"), "wb").close()
    indices = os.path.join(root, "indices")
    os.makedirs(indices)
    with open(os.path.join(indices, "cc3m-train.tsv"), "w") as fh:
        fh.write("filepath\ttitle\n")
        fh.writelines(f"/data/cc3m/{i // 10000:03d}/{i:07d}.jpg\ta web image number {i}.\n" for i in range(FAB_CC3M))
    return {"dn": dn, "imagenet": imagenet, "in_train": in_train, "indices": indices, "per_class": per_class}


def count_lines(path: str) -> int:
    with open(path, "rb") as fh:
        return sum(1 for _ in fh)


def phase_fabrication():
    """Phase 9: data fabrication at DomainNet's size (index files, no
    images): captions, the seven paper mixtures, the CC3M merge and the
    ImageNet-Sketch mixes; row counts against the reference-size rule."""
    from xclip_tpu_torch.data import captions, lso, mixtures
    from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX

    root = os.path.join(SCRATCH, "fabrication")
    t0 = time.perf_counter()
    inp = make_fabrication_inputs(root, LSO_CLASS_TO_IDX)
    setup_s = time.perf_counter() - t0
    n_dn = sum(sum(v) for v in FAB_DN_COUNTS.values())
    log(f"  inputs: {n_dn} DomainNet rows, {FAB_IN_CAPTIONS} ImageNet-Captions files, {FAB_IN_SKETCH} "
        f"ImageNet-Sketch files, {FAB_CC3M} CC3M rows in {setup_s:.1f} s")
    steps = {}

    def timed(name: str, rows: int, fn):
        t = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t
        steps[name] = {"s": dt, "rows": rows, "rows_per_s": rows / dt}
        log(f"  {name}: {rows} rows in {dt:.2f} s ({rows / dt:,.0f} rows/s)")
        return out

    dn, indices, imagenet, per_class = inp["dn"], inp["indices"], inp["imagenet"], inp["per_class"]
    timed("generate_domainnet_captions", 2 * n_dn, lambda: captions.generate_domainnet_captions(dn))
    for domain, (n_train, n_test) in FAB_DN_COUNTS.items():
        for sub in ("", "aligned-captions"):
            got = (count_lines(os.path.join(dn, sub, f"{domain}_train.tsv")),
                   count_lines(os.path.join(dn, sub, f"{domain}_test.tsv")))
            if got != (n_train, n_test):
                fail(f"{sub or 'captions'} {domain}: {got} rows, lists hold {(n_train, n_test)}")
        if not os.path.islink(os.path.join(dn, "aligned-captions", domain)):
            fail(f"aligned-captions/{domain} is not a symlink")
    split = os.path.join(SCRATCH, "fabrication", "imagenet_captions_split.json")
    import warnings

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="Filename")  # every entry is in the split: none may be skipped
        timed("generate_imagenet_captions", FAB_IN_CAPTIONS, lambda: captions.generate_imagenet_captions(
            inp["in_train"], os.path.join(root, "imagenet_captions.json"), split, indices))
    n_in_train = count_lines(os.path.join(indices, "in-captions-train.tsv")) - 1
    n_in_val = count_lines(os.path.join(indices, "in-captions-val.tsv")) - 1
    first = os.path.join(inp["in_train"], imagenet_wnids()[0], f"{imagenet_wnids()[0]}_0.JPEG")
    with open(first[:-len(".JPEG")] + ".json") as fh:
        sidecar = json.load(fh)
    if (n_in_train, n_in_val) != (FAB_IN_CAPTIONS * 9 // 10, FAB_IN_CAPTIONS // 10) or \
            sidecar != {"caption": "Photo 0; tag0 flickr; line one line two 0"}:
        fail(f"in-captions rows {n_in_train}/{n_in_val}, sidecar {sidecar}")
    timed("generate_sketch_captions", FAB_IN_SKETCH, lambda: captions.generate_sketch_captions(imagenet))
    if count_lines(os.path.join(imagenet, "in-sketch-captions.tsv")) != FAB_IN_SKETCH + 1:
        fail("in-sketch-captions.tsv rows")

    lso_idx = set(LSO_CLASS_TO_IDX.values())
    train = {d: per_class[d, "train"] for d in FAB_DN_COUNTS}
    mixture_rows = {}
    for ident, kw in FAB_MIXTURES:
        # rows read: train (and the reference's) and val lists of the domains kept
        kept = [d for d in FAB_DN_COUNTS if not kw.get("real_only") or d == "real"]
        read = sum(sum(FAB_DN_COUNTS[d]) for d in kept)
        got = timed(f"subsample_domainnet_lso {ident}", read, lambda: lso.subsample_domainnet_lso(dn, indices, **kw))
        if got != ident:
            fail(f"identifier {got}, expected {ident}")
        with open(os.path.join(indices, f"dn-captions-train-{ident}.tsv")) as fh:
            rows = fh.read().splitlines()[1:]
        exclude = kw.get("exclude")
        if exclude is None:
            want = int(train["real"].sum())
        else:  # the single-rendition reference: real, and the excluded domain without the LSO classes
            want = int(train["real"].sum() + sum(n for c, n in enumerate(train[exclude]) if c not in lso_idx))
            lso_names = {c.replace(" ", "_") for c in LSO_CLASS_TO_IDX}
            leaked = sum(1 for r in rows if f"/{exclude}/" in r and r.split("\t")[0].split("/")[-2] in lso_names)
            if leaked:
                fail(f"{ident}: {leaked} rows of LSO classes in {exclude}")
        if len(rows) != want:
            fail(f"{ident}: {len(rows)} train rows, the reference-size rule gives {want}")
        if count_lines(os.path.join(indices, f"combined-captions-train-{ident}.tsv")) != 1 + n_in_train + len(rows):
            fail(f"combined-captions-train-{ident}.tsv rows")
        mixture_rows[ident] = len(rows)
    log(f"  mixture train rows {mixture_rows} (reference-size rule held)")
    timed("merge_ccxm cc3m", sum(FAB_CC3M + n for n in mixture_rows.values()),
          lambda: mixtures.merge_ccxm("cc3m", indices, [m for m, _ in FAB_MIXTURES]))
    for ident, n in mixture_rows.items():
        if count_lines(os.path.join(indices, f"cc3m-train-{ident}.tsv")) != 1 + FAB_CC3M + n:
            fail(f"cc3m-train-{ident}.tsv rows")
    mapping = os.path.join(REPO, "data", "in_to_dn_mapping.json")
    combined = {i: 1 + n_in_train + n for i, n in mixture_rows.items()}
    names3 = ("lso-real-only", "lso-cipqr-nosketchclasses", "lso-cipqrs-nosketchclasses")
    timed("add_in_sketches", sum(combined[i] for i in names3),
          lambda: mixtures.add_in_sketches(imagenet, indices, mapping))
    for ident in names3:
        if count_lines(os.path.join(indices, f"combined-captions-train-{ident}-with-in-sketches.tsv")) != combined[ident]:
            fail(f"{ident}-with-in-sketches rows differ from the mixture's")
    timed("mix_in_sketches", 7 * combined["lso-cipqrs-nosketchclasses"],
          lambda: mixtures.mix_in_sketches(imagenet, indices, mapping))
    for mode in ("fiftyp", "twentyfivep", "thirtyp", "tenp", "fivep", "onep", "one"):
        path = os.path.join(indices, f"combined-captions-train-lso-cipqrs-nosketchclasses-with-in-sketches-{mode}.tsv")
        if count_lines(path) != combined["lso-cipqrs-nosketchclasses"]:
            fail(f"mix_in_sketches {mode} rows")
    wall = sum(s["s"] for s in steps.values())
    log(f"  fabrication steps {wall:.1f} s (inputs {setup_s:.1f} s more)")
    shutil.rmtree(root, ignore_errors=True)
    return {"steps": steps, "setup_s": setup_s, "wall_s": wall, "mixture_train_rows": mixture_rows,
            "dn_rows": n_dn, "in_captions": FAB_IN_CAPTIONS, "in_sketch": FAB_IN_SKETCH, "cc3m_rows": FAB_CC3M}


def make_wds_chain(root: str, lso_class_to_idx) -> dict:
    """The fabrication chain at image level: a seeded DomainNet tree of
    256-px JPEGs (345 classes; per class 3 real, 2 sketch, 1-2 other train
    images; one of each in test, as lists only), its captions, 200
    ImageNet-Captions JPEGs with their TSVs and ``.json`` sidecars, the
    ``lso-cipqrs-nosketchclasses`` mixture, and its combined train TSV
    written as tar shards of ``.jpg`` + ``.json`` (the sidecar for the
    ImageNet rows); one sample's JPEG cut in half."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    from xclip_tpu_torch.data import captions, lso

    rng = np.random.RandomState(0)
    pool = []
    for _ in range(64):
        img = rng.randint(0, 256, (256, 256, 3)).astype(np.int32) // 2 + rng.randint(0, 128, (1, 1, 3))
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG", quality=90)
        pool.append(buf.getvalue())
    names = lso_class_names(lso_class_to_idx)
    dn = os.path.join(root, "domainnet")
    per_domain = {"clipart": 1, "infograph": 2, "painting": 1, "quickdraw": 2, "real": 3, "sketch": 2}
    for domain, n in per_domain.items():
        for split, count in (("train", n), ("test", 1)):
            lines = []
            for c, name in enumerate(names):
                os.makedirs(os.path.join(dn, domain, name), exist_ok=True)
                for j in range(count):
                    rel = f"{domain}/{name}/{split}{j}.jpg"
                    if split == "train":
                        with open(os.path.join(dn, rel), "wb") as fh:
                            fh.write(pool[rng.randint(len(pool))])
                    lines.append(f"{rel} {c}\n")
            with open(os.path.join(dn, f"{domain}_{split}.txt"), "w") as fh:
                fh.writelines(lines)
    captions.generate_domainnet_captions(dn)
    wnids = imagenet_wnids()[:50]
    in_train = os.path.join(root, "imagenet", "captions")
    samples, split = [], {"train": [], "val": []}
    for i in range(200):
        os.makedirs(os.path.join(in_train, wnids[i % 50]), exist_ok=True)
        fname = f"{wnids[i % 50]}_{i}.JPEG"
        with open(os.path.join(in_train, wnids[i % 50], fname), "wb") as fh:
            fh.write(pool[rng.randint(len(pool))])
        samples.append({"wnid": wnids[i % 50], "filename": fname, "title": f"photo {i}", "tags": ["t"],
                        "description": "a flickr photo"})
        split["train" if i % 10 else "val"].append(fname)
    for name, obj in (("c.json", samples), ("s.json", split)):
        with open(os.path.join(root, name), "w") as fh:
            json.dump(obj, fh)
    indices = os.path.join(root, "indices")
    captions.generate_imagenet_captions(in_train, os.path.join(root, "c.json"), os.path.join(root, "s.json"), indices)
    ident = lso.subsample_domainnet_lso(dn, indices, exclude="sketch", subsample=True)
    with open(os.path.join(indices, f"combined-captions-train-{ident}.tsv")) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh.readlines()[1:]]
    shards = os.path.join(root, "shards")
    os.makedirs(shards)
    keys, corrupt = [], None
    n_shards = math.ceil(len(rows) / WDS_SHARD)
    for s in range(n_shards):
        with tarfile.open(os.path.join(shards, f"dn-{s:03d}.tar"), "w") as tf:
            for i in range(s * WDS_SHARD, min(len(rows), (s + 1) * WDS_SHARD)):
                path, caption = rows[i]
                with open(path, "rb") as fh:
                    jpg = fh.read()
                sidecar = os.path.splitext(path)[0] + ".json"
                if "/captions/" in path:  # generate_imagenet_captions wrote it
                    with open(sidecar, "rb") as fh:
                        meta = fh.read()
                else:
                    meta = json.dumps({"caption": caption}).encode()
                key = f"{i:07d}"
                if s == 1 and i == (s * WDS_SHARD + 17):
                    jpg, corrupt = jpg[: len(jpg) // 2], key
                for suffix, data in (("jpg", jpg), ("json", meta)):
                    info = tarfile.TarInfo(f"{key}.{suffix}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                keys.append(key)
    return {"shards": shards, "n_shards": n_shards, "keys": keys, "corrupt": corrupt, "identifier": ident,
            "rows": len(rows), "captions": {f"{i:07d}": r[1] for i, r in enumerate(rows)}}


def read_train_log(path: str) -> tuple:
    """(log lines, losses, the lines' samples/s) of a train.main run."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if "Train Epoch:" in ln]
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in lines]
    rates = [float(ln.split("Batch (t): ")[1].split(",")[1].split("/s")[0]) for ln in lines]
    return lines, losses, rates


def phase_wds_train(torch, factory, train_main, fused_conv, flash_attention, rn50):
    """Phase 10: RN50 training at full width from tar shards: the CLI plain
    and resampled with weights over two ``::`` sources; a corrupt sample
    skipped and logged; the first batch against the reader's own."""
    import numpy as np

    from xclip_tpu_torch.data import wds
    from xclip_tpu_torch.data.transforms import image_transform
    from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX
    from xclip_tpu_torch.parallel.distributed import DistInfo
    from xclip_tpu_torch.tokenizer import get_tokenizer
    from xclip_tpu_torch.train.params import parse_args

    root = os.path.join(SCRATCH, "wds")
    t0 = time.perf_counter()
    chain = make_wds_chain(root, LSO_CLASS_TO_IDX)
    n_samples = WDS_STEPS * TRAIN_BATCH * TRAIN_ACCUM
    log(f"  chain: {chain['identifier']} ({chain['rows']} rows, captions and .json sidecars) as "
        f"{chain['n_shards']} shards in {time.perf_counter() - t0:.1f} s; corrupt sample {chain['corrupt']}")
    if chain["rows"] < n_samples + 100:
        fail(f"the mixture has {chain['rows']} rows, fewer than an epoch of {n_samples}")
    url = os.path.join(chain["shards"], f"dn-{{000..{chain['n_shards'] - 1:03d}}}.tar")

    # a corrupt sample is skipped and logged, and nothing else is dropped
    with _LogCollector() as logs:
        got = [(s["__key__"], s["text"]) for s in wds.WebDatasetReader(url, json_caption_key="caption")]
    skipped = [m for m in logs.messages if "Handling tar-pipeline error" in m]
    want = [k for k in chain["keys"] if k != chain["corrupt"]]
    if [k for k, _ in got] != want or len(skipped) != 1:
        fail(f"reader: {len(got)} samples of {len(chain['keys'])}, {len(skipped)} logged errors; expected all but "
             f"{chain['corrupt']} and one")
    if any(text != chain["captions"][k] for k, text in got):
        fail("a --json-captions caption differs from the mixture TSV's")

    flags = ["--model", "RN50", "--json-captions", "--train-num-samples", str(n_samples),
             "--batch-size", str(TRAIN_BATCH), "--accum-freq", str(TRAIN_ACCUM), "--precision", "amp",
             "--grad-checkpointing", "--local-loss", "--gather-with-grad", "--warmup", "2", "--lr", "1e-3",
             "--epochs", "1", "--log-every-n-steps", "1", "--seed", "0"]
    common = flags + ["--workers", "8", "--logs", os.path.join(root, "logs"), "--device", "cuda"]
    # the first batch of the trainer's loader (get_data, no worker threads) against the reader's own
    args = parse_args(["--train-data", url, *flags, "--workers", "0"])
    tokenizer = get_tokenizer("RN50")
    loader = train_main.get_data(args, image_transform(rn50.image_size, is_train=True, seed=0), None, tokenizer,
                                 False, DistInfo.current())["train"]
    batch = next(iter(loader))
    ref = wds.WebDatasetReader(url, transform=image_transform(rn50.image_size, is_train=True, seed=0), shuffle=True,
                               seed=0, json_caption_key="caption")
    ref_items = list(itertools.islice(iter(ref), TRAIN_BATCH * TRAIN_ACCUM))
    first_keys = [s["__key__"] for s in ref_items]
    if not (np.array_equal(batch["images"], np.stack([s["image"] for s in ref_items]))
            and np.array_equal(batch["texts"], tokenizer([s["text"] for s in ref_items]))):
        fail("the trainer's first batch differs from the reader's own at one worker")
    log(f"  first batch (get_data, --workers 0) equals the reader's first {len(first_keys)} samples: "
        f"keys {first_keys[:4]} ... {first_keys[-2:]}")
    # the loader's host rate with the CLI's 8 threads: decode, crop, tokenize
    args8 = parse_args(["--train-data", url, *flags, "--workers", "8"])
    loader8 = train_main.get_data(args8, image_transform(rn50.image_size, is_train=True, seed=0), None, tokenizer,
                                  False, DistInfo.current())["train"]
    t0 = time.perf_counter()
    n_host = sum(b["images"].shape[0] for b in loader8)
    host_s = time.perf_counter() - t0
    log(f"  loader alone (8 threads): {n_host} images in {host_s:.2f} s, {n_host / host_s:.1f} img/s on the host")

    runs = {}
    sources = f"{chain['shards']}/dn-000.tar::{chain['shards']}/dn-002.tar"
    for name, data in (("wds", ["--train-data", url]),
                       ("wds_resampled", ["--dataset-type", "webdataset", "--train-data", sources,
                                          "--dataset-resampled", "--train-data-upsampling-factors", "1::2"])):
        torch.cuda.synchronize()
        zero_counts(fused_conv, flash_attention)
        t0 = time.perf_counter()
        with _LogCollector() as logs:
            rc = train_main.main([*data, *common, "--name", name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = train_counts(fused_conv, flash_attention)
        want = train_path_counts(rn50, WDS_STEPS, TRAIN_ACCUM)
        lines, losses, rates = read_train_log(os.path.join(root, "logs", name, "out.log"))
        skipped = sum("Handling tar-pipeline error" in m for m in logs.messages)
        log(f"  train.main {name}: rc {rc}, {len(lines)} steps in {wall:.1f} s (model, loader and first step "
            f"included); losses {[round(v, 4) for v in losses]}; samples/s by step {rates}; corrupt samples met "
            f"{skipped}; launches {counts} (expected {want}, the TSV path's at {WDS_STEPS} steps)")
        if rc != 0 or len(lines) != WDS_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"{name}: rc {rc}, {len(lines)} log lines, losses {losses}")
        if counts != want:
            fail(f"{name}: launches {counts} differ from the TSV path's {want}")
        if skipped > 1:
            fail(f"{name}: {skipped} samples skipped, the shards hold one corrupt sample")
        ckpt = os.path.join(root, "logs", name, "checkpoints", "epoch_1.pt")
        model = factory.create_model("RN50", pretrained=ckpt, device="cuda")
        with torch.inference_mode():
            feats = model.encode_image(torch.randn(4, rn50.image_size, rn50.image_size, 3, device="cuda"),
                                       normalize=True, dtype=torch.bfloat16)
        if not torch_all_finite(feats):
            fail(f"{name}: epoch_1.pt gives non-finite features")
        del model
        torch.cuda.empty_cache()
        runs[name] = {"counts": counts, "losses": losses, "samples_per_s": rates, "wall_s": wall,
                      "corrupt_met": skipped, "log_lines": lines}
    shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(r["counts"][k] for r in runs.values()) for k in runs["wds"]["counts"]}
    return total, {"runs": runs, "first_batch_keys": first_keys, "host_images_per_s": n_host / host_s,
                   "host_s": host_s, "rows": chain["rows"], "shards": chain["n_shards"]}


def umap_clusters(n: int, d: int, seed: int = 0):
    """Six seeded Gaussian clusters whose scales differ 6-fold."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = np.arange(n) % 6
    centers = rng.randn(6, d) * 3
    scales = np.array([0.5, 0.75, 1.0, 1.5, 2.0, 3.0])
    return (centers[labels] + scales[labels, None] * rng.randn(n, d)).astype(np.float32), labels


def layout_grad(torch, umap, y, t, neg_tail, ab, densmap: bool):
    """The gradient of the layout loss at ``y`` (tensors ``t`` on y's device)."""
    y = y.detach().requires_grad_(True)
    loss = umap.layout_loss(y, t["head"], t["tail"], t["weight"], t["neg_head"], neg_tail, t["log_r"], *ab, densmap, 2.0)
    return torch.autograd.grad(loss, y)[0]


def umap_card_vs_cpu(torch, umap, x):
    """kNN, one layout epoch's gradient and 10 epochs step by step, card vs
    CPU with equal negatives, at the first UMAP_CHECK_N points."""
    import numpy as np

    x = x[:UMAP_CHECK_N]
    got_d, got_i = umap.exact_knn(torch.from_numpy(x).cuda(), 16)
    want_d, want_i = umap.exact_knn(x, 16)
    d_err = float(np.max(np.abs(got_d - want_d) / np.maximum(want_d, 1e-6)))
    # indices are held where a distance is clear of its neighbours' by twice the tolerance (ties may swap)
    tol = 2 * UMAP_KNN_RTOL * want_d
    clear = ((np.diff(want_d, axis=1, prepend=-np.inf) > tol) & (np.diff(want_d, axis=1, append=np.inf) > tol))[:, :15]
    idx_equal = bool(np.array_equal(got_i[:, :15][clear], want_i[:, :15][clear]))
    want_d, want_i = want_d[:, :15], want_i[:, :15]
    graph = umap.fuzzy_graph_from_knn(want_d, want_i)
    y0 = umap.spectral_init(graph, len(x), 2)
    y0 = umap.pca_init(x, 2) if y0 is None else y0
    out = {"knn_dist_rel_err": d_err, "knn_idx_equal_off_ties": idx_equal, "knn_clear_share": float(clear.mean())}
    ab = umap.fit_ab(0.1, 1.0)
    log_r = umap.log_radius_orig(graph)
    rng = np.random.RandomState(3)
    for densmap in (False, True):
        t = {dev: {"head": torch.as_tensor(graph.head, dtype=torch.long, device=dev),
                   "tail": torch.as_tensor(graph.tail, dtype=torch.long, device=dev),
                   "weight": torch.as_tensor(graph.weight, device=dev),
                   "log_r": torch.as_tensor(log_r, device=dev)} for dev in ("cpu", "cuda")}
        for dev in t:
            t[dev]["neg_head"] = t[dev]["head"].repeat(5)
        negs = rng.randint(0, len(x), (UMAP_CHECK_EPOCHS, 5 * len(graph.head)))
        y_card, errs = torch.as_tensor(y0).cuda(), []
        for epoch in range(UMAP_CHECK_EPOCHS):
            neg = torch.as_tensor(negs[epoch], dtype=torch.long)
            g_card = layout_grad(torch, umap, y_card, t["cuda"], neg.cuda(), ab, densmap)
            g_cpu = layout_grad(torch, umap, y_card.cpu(), t["cpu"], neg, ab, densmap)
            errs.append(norm_rel_err(g_card.cpu(), g_cpu))
            alpha = float(np.float32(1.0) - np.float32(epoch) / np.float32(UMAP_CHECK_EPOCHS))
            y_card = y_card - alpha * torch.clamp(g_card, -4.0, 4.0)
        # the whole 10-epoch runs, card and CPU, drift apart: the clipped steps amplify rounding (reported only)
        kw = dict(n_epochs=UMAP_CHECK_EPOCHS, a=ab[0], b=ab[1], densmap=densmap, dens_lambda=2.0, seed=0, negatives=negs)
        drift = float((umap.optimize_layout(y0, graph, log_r, device="cuda", **kw).cpu()
                       - umap.optimize_layout(y0, graph, log_r, **kw)).abs().max())
        key = "densmap" if densmap else "plain"
        out[f"grad_rel_err_{key}"], out[f"drift_{key}"] = errs, drift
        log(f"  card vs CPU at n = {len(x)}, {key}: the layout gradient along {UMAP_CHECK_EPOCHS} epochs with equal "
            f"negatives, relative norm {max(errs):.3g} at worst (epoch 0: {errs[0]:.3g}; tolerance {UMAP_GRAD_TOL}); "
            f"the two {UMAP_CHECK_EPOCHS}-epoch runs end {drift:.3g} apart at most (the layout spans +-{float(y_card.abs().max()):.3g})")
        if max(errs) > UMAP_GRAD_TOL:
            fail(f"UMAP layout gradient card vs CPU {errs}")
    log(f"  kNN card vs CPU at n = {len(x)}: distances within {d_err:.3g} relative (tolerance {UMAP_KNN_RTOL}); "
        f"indices equal off ties: {idx_equal} ({clear.mean():.1%} of neighbours clear of ties)")
    if d_err > UMAP_KNN_RTOL or not idx_equal:
        fail("UMAP kNN card vs CPU")
    return out


def phase_embedding(torch, fused_conv, flash_attention, rn50):
    """Phase 11: ``save_domainnet_features`` over phase 7's tree and RN50
    (fp32, K1/K2) and ``embedding_analysis`` on its output; then the script
    at its own cap, 20,000 x 1024 seeded features, with the stages timed
    by a replay that must give the script's embedding bit for bit."""
    import numpy as np

    from xclip_tpu_torch.evals import umap
    from xclip_tpu_torch.scripts import embedding_analysis, save_domainnet_features

    tree, ckpt = os.path.join(SCRATCH, "domainnet"), os.path.join(SCRATCH, "sae_rn50.pt")
    root = os.path.join(SCRATCH, "embedding")
    n_val = 6 * SAE_TEST_PER_DOMAIN
    torch.cuda.synchronize()
    zero_counts(fused_conv, flash_attention)
    t0 = time.perf_counter()
    rc = save_domainnet_features.main(["--model", "RN50", "--ckpt_files", ckpt, "--out_path", os.path.join(root, "f"),
                                       "--domainnet_path", tree, "--num_workers", "0", "--device", "cuda"])
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    counts = sae_path_counts(fused_conv, flash_attention)
    per_batch = fused_conv_shapes(rn50.vision, 1)
    fb = math.ceil(n_val / SAE_FEATURES_BS)
    want = {"K1": sum(not s[4] for s in per_batch) * fb, "K2": sum(s[4] for s in per_batch) * fb, "K3": 0, "K4": 0,
            "K5": 0}
    if rc != 0 or counts != want:
        fail(f"save_domainnet_features rc {rc}, launches {counts} (expected {want})")
    t0 = time.perf_counter()
    rc = embedding_analysis.main(["--features_path", os.path.join(root, "f"), "--out_path", os.path.join(root, "e"),
                                  "--device", "cuda"])
    small_s = time.perf_counter() - t0
    with open(os.path.join(root, "e", "embedding_analysis.json")) as fh:
        summary = json.load(fh)
    emb = np.load(os.path.join(root, "e", "embedding.npy"))
    feats = np.load(os.path.join(root, "f", "img_feat.npy"))[-1]
    ids = np.load(os.path.join(root, "f", "domain_ids.npy"))
    if rc != 0 or summary != embedding_analysis.analysis_summary(feats, ids)[0] or emb.shape != (n_val, 2) \
            or not np.isfinite(emb).all() or np.asarray(summary["domain_distance_matrix"]).shape != (6, 6):
        fail(f"embedding_analysis on the RN50 features: rc {rc}, embedding {emb.shape}, keys {sorted(summary)}")
    log(f"  save_domainnet_features (RN50 fp32, {n_val} images) {feat_s:.2f} s, launches {counts}; "
        f"embedding_analysis {small_s:.2f} s; quickdraw max |diff| {summary['quickdraw_max_absdiff']:.4g}")

    x, labels = umap_clusters(UMAP_N, UMAP_D)
    big = os.path.join(root, "big")
    os.makedirs(big)
    np.save(os.path.join(big, "img_feat.npy"), x)
    np.save(os.path.join(big, "domain_ids.npy"), labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = embedding_analysis.main(["--features_path", big, "--out_path", os.path.join(root, "big_out"),
                                  "--max_points", str(UMAP_N), "--device", "cuda"])
    torch.cuda.synchronize()
    script_s = time.perf_counter() - t0
    emb = np.load(os.path.join(root, "big_out", "embedding.npy"))
    if rc != 0 or emb.shape != (UMAP_N, 2) or not np.isfinite(emb).all():
        fail(f"embedding_analysis at {UMAP_N} x {UMAP_D}: rc {rc}, embedding {emb.shape}")

    # the stages of umap_embed(densmap=True, seed=0), timed: kNN and layout on the card (CUDA events),
    # the graph and the initialisation on the host
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    xt = torch.from_numpy(x).cuda()
    torch.cuda.synchronize()
    start.record()
    d, i = umap.knn_device(xt, 15)
    end.record()
    end.synchronize()
    knn_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    graph = umap.fuzzy_graph_from_knn(d.cpu().numpy(), i.cpu().numpy().astype(np.int32))
    fuzzy_s = time.perf_counter() - t0
    a, b = umap.fit_ab(0.1, 1.0)
    t0 = time.perf_counter()
    y0 = umap.spectral_init(graph, UMAP_N, 2)
    spectral_s = time.perf_counter() - t0
    init = "spectral" if y0 is not None else "pca (spectral failed)"
    y0 = umap.pca_init(x, 2) if y0 is None else y0
    y0 = y0 + np.random.RandomState(0).normal(0, 1e-4, y0.shape).astype(np.float32)
    layouts, layout_ms = [], []
    n_epochs = 500 if UMAP_N < 10000 else 200  # umap_embed's default
    for _ in range(2):
        torch.cuda.synchronize()
        start.record()
        layouts.append(umap.optimize_layout(y0, graph, umap.log_radius_orig(graph), n_epochs=n_epochs, a=a, b=b,
                                            densmap=True, dens_lambda=2.0, seed=0, device="cuda"))
        end.record()
        end.synchronize()
        layout_ms.append(start.elapsed_time(end))
    deterministic = torch.equal(layouts[0], layouts[1])
    same_as_script = bool(np.array_equal(layouts[0].cpu().numpy(), emb))
    log(f"  embedding_analysis {UMAP_N} x {UMAP_D}, densMAP, {n_epochs} epochs: wall {script_s:.2f} s; kNN {knn_ms:.1f} ms "
        f"(CUDA events), fuzzy set {fuzzy_s:.2f} s and {init} init {spectral_s:.2f} s (host), layout "
        f"{layout_ms[0]:.1f} / {layout_ms[1]:.1f} ms (CUDA events, {len(graph.head)} edges); two layouts bit for "
        f"bit: {deterministic}; the replay equals the script's embedding: {same_as_script}")
    if not deterministic or not same_as_script:
        fail("the UMAP layout is not deterministic at a seed on the card")
    cross = umap_card_vs_cpu(torch, umap, x)
    shutil.rmtree(root, ignore_errors=True)
    return counts, {"features_s": feat_s, "small_script_s": small_s, "summary_small": summary, "script_s": script_s,
                    "knn_ms": knn_ms, "fuzzy_s": fuzzy_s, "spectral_s": spectral_s, "init": init,
                    "layout_ms": layout_ms, "edges": len(graph.head), "deterministic": deterministic,
                    "card_vs_cpu": cross}


def summarize(report, errs, counts, train_counts_, stats_records, stats_errs, bwd_records, bwd_errs,
              text_layers: int, sae_counts, k5, ddp_counts, vit, sup_counts, sup_records, sup_errs, interp_counts_,
              wds_counts, embedding_counts):
    """One entry per kernel. K1/K2 are timed over one 250-image eval batch
    (the sum over its launches of the per-shape times), K4 over one full
    text chunk (one launch per text block), K3 over one 128-image training
    forward (16 launches). The top-level numbers are bf16, the main paths'
    dtype; ``by_dtype`` holds the same sums for fp32, bf16 and fp16.
    ``launches`` counts the main paths' runs (``launches_by_path``: the LSO
    evaluation, training, training with its evaluation in a 1-rank NCCL
    group, and the SAE path's two feature CLIs). K5 is timed
    over one pass of the probe's 8192 x 8192 bf16 array, its launches are
    the probe's two runs. K4's ``vit`` holds its non-causal shapes of the
    ViT paths (phase 3c, head dims 64 to 112), each timed per launch, and
    the launches of phases 4b (ViT-L-14, ViT-bigG-14), 4c (the ViT-H, -g
    and -e towers) and 5e are in its ``launches_by_path``. The supervised
    baseline's runs (phase 5f: the RN50 and ViT-B-32 classifiers'
    training, the supervised LSO evaluation) are in ``launches_by_path``
    too; K1/K2/K3's ``classifier_train_bf16`` holds phase 3d's times summed
    over one 256-image train-mode forward of the RN50 classifier. Phase 8's
    interpretability path (the two class circuits, their zero-shot heads and
    name_concepts' vocabulary) is ``interp`` in ``launches_by_path``, and the
    circuits' MatmulAffineAct backward calls ``calls_in_interp``. Phase 10's
    two RN50 runs from tar shards are ``train_wds`` (their backward calls in
    ``calls_in_train``), phase 11's feature cache ``embedding_features``.
    ``backward`` holds the Function's plain backward against autograd of the
    plain version at one shape per stage (bf16 and fp32 times summed over
    those shapes)."""
    kernels = (
        ("K1", "matmul_affine_act (K1: conv1 in eval, downsample)", "fused_conv.cu", "fused_conv.py:59",
         "K1/K2 backward"),
        ("K2", "matmul_affine_act (K2: conv3 + identity)", "fused_conv.cu", "fused_conv.py:67", "K1/K2 backward"),
        ("K3", "matmul_stats (K3: conv1 + BatchNorm batch sums, training)", "fused_conv.cu", "fused_conv.py:187",
         "K3 backward"),
        ("K4", "flash_attention (K4: text self-attention, causal; ViT, EVA and timm-ViT self-attention, "
               "non-causal)",
         "flash_attention.cu", "flash_attention.py:31", "K4 backward"),
    )
    entries = []
    for kid, name, source, replaces, bwd_key in kernels:
        by_dtype = {}
        kid_errs = stats_errs if kid == "K3" else errs[kid]
        for dname in kid_errs:
            if kid == "K4":
                recs = [dict(r, count_per_batch=text_layers) for r in report["flash_attention"]
                        if r["dtype"] == dname and r["B"] == TEXT_CHUNK]
            elif kid == "K3":
                recs = [r for r in stats_records if r["dtype"] == dname]
            else:
                recs = [r for r in report["fused_conv"] if r["kernel"] == kid and r["dtype"] == dname]
            tot = {key: sum(r[key] * r["count_per_batch"] for r in recs)
                   for key in ("kernel_ms", "plain_ms", "library_ms", "ops_ms", "bytes_ms")}
            bound_ms = max(tot["ops_ms"], tot["bytes_ms"])
            by_dtype[dname] = {
                "ms": tot["kernel_ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                "bound_ms": bound_ms, "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
                "share_of_bound": bound_ms / tot["kernel_ms"], "slower_than_library": slower_list(recs),
                "max_abs_err": kid_errs[dname], "launches_per": sum(r["count_per_batch"] for r in recs),
            }
            if kid != "K4":  # the late layers' products, K >= 512, where the tensor cores set the pace
                deep = [r for r in recs if r["K"] >= DEEP_K]
                by_dtype[dname]["deep_k"] = {
                    key: sum(r[key] * r["count_per_batch"] for r in deep) for key in ("kernel_ms", "library_ms")}
        bf16 = by_dtype["bf16"]
        per = {"K4": f"one {TEXT_CHUNK}-prompt text chunk", "K3": f"one {TRAIN_BATCH}-image RN50 training forward"
               }.get(kid, f"one {BATCH}-image RN50 eval batch")
        by_path = {"lso_eval": counts.get(kid, 0), "train": train_counts_[kid], "train_ddp_eval": ddp_counts[kid],
                   "sae_feature_cache": sae_counts["cache"][kid], "save_domainnet_features": sae_counts["features"][kid],
                   **{f"lso_eval_{name}": c.get(kid, 0) for name, c in vit["lso_counts"].items()},
                   **{f"tower_{name}": (r["bf16"]["launches"] + r["fp32"]["launches"]) if kid == "K4" else 0
                      for name, r in vit["towers"].items()},
                   "train_vit_b16": vit["train_counts"][kid],
                   **{name: c[kid] for name, c in sup_counts.items()},
                   "interp": interp_counts_.get(kid, 0), "train_wds": wds_counts[kid],
                   "embedding_features": embedding_counts[kid]}
        bwd = [r for r in bwd_records if r["kernel"] == kid]
        backward = {
            "route": "plain PyTorch in a torch.autograd.Function (no backward kernel yet)",
            "calls_in_train": (train_counts_[bwd_key] + ddp_counts[bwd_key] + vit["train_counts"][bwd_key]
                               + sum(c[bwd_key] for c in sup_counts.values()) + wds_counts[bwd_key]),
            "calls_in_interp": interp_counts_.get(bwd_key, 0),
            "rel_err": bwd_errs[kid],
            "shapes": sorted({r["shape"] for r in bwd}),
            "ms_bf16": sum(r["backward_ms"] for r in bwd if r["dtype"] == "bf16"),
            "plain_ms_bf16": sum(r["plain_backward_ms"] for r in bwd if r["dtype"] == "bf16"),
            "ms_fp32": sum(r["backward_ms"] for r in bwd if r["dtype"] == "fp32"),
            "plain_ms_fp32": sum(r["plain_backward_ms"] for r in bwd if r["dtype"] == "fp32"),
        }
        entry = {
            "name": name, "route": "cuda", "source": f"xclip_tpu_torch/ops/csrc/{source}",
            "replaces": f"xclip_tpu/ops/{replaces}", "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "share_of_bound": bf16["share_of_bound"],
            "slower_than_library": [s for d in by_dtype.values() for s in d["slower_than_library"]],
            "dtype": "bf16", "per": f"{per} ({bf16['launches_per']} launches)",
            "status": ("forward: built, launched by the main paths, agrees with plain in fp32/bf16/fp16; "
                       "backward: agrees with autograd of plain in fp32/bf16, ran in training"),
            "by_dtype": by_dtype, "backward": backward,
        }
        sup = [r for r in sup_records if r["kernel"] == kid]
        if sup:  # the RN50 classifier's batch-256 training shapes, bf16
            entry["classifier_train_bf16"] = {
                **{key: sum(r[key] * r["count_per_batch"] for r in sup)
                   for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
                "launches_per": sum(r["count_per_batch"] for r in sup), "max_abs_err": sup_errs[kid],
                "shapes": [{k: r[k] for k in ("M", "K", "C", "count_per_batch", "kernel_ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by", "share_of_bound", "max_abs_err")} for r in sup]}
            entry["slower_than_library"] += slower_list(sup)
        if kid == "K4":  # the ViT paths' non-causal shapes, per launch
            entry["slower_than_library"] += slower_list(vit["records"])
            entry["vit"] = {"max_abs_err": vit["errs"], "shapes": [
                {k: r[k] for k in ("role", "dtype", "B", "H", "L", "D", "kernel_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "share_of_bound", "max_abs_err")} for r in vit["records"]]}
        entries.append(entry)
    entries.append({
        "name": "stream_scale (K5: bf16 streaming copy-and-scale, the bandwidth probe)", "route": "cuda",
        "source": "xclip_tpu_torch/ops/csrc/stream_scale.cu", "replaces": "tools/probe_mosaic.py:72",
        "launches": k5["launches"], "launches_by_path": {"probe_bandwidth": k5["launches"]},
        "max_abs_err": k5["max_abs_err"], "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"], "library_ms": k5["library_ms"], "dtype": "bf16",
        "share_of_bound": k5["share_of_bound"], "slower_than_library": slower_list([k5]),
        "per": (f"one pass over an 8192 x 8192 bf16 array (1 launch), median of {K5_ROUNDS} rounds of "
                f"{K5_LAUNCHES} launches timed in turns with plain and library (the same torch.mul)"),
        "spread_ms": {k: v["spread_ms"] for k, v in k5["timing"].items()},
        "host_ms_per_call": k5["host_ms_per_call"], "ptxas": k5["ptxas"], "geometry": k5["geometry"],
        "status": "built, launched by the probe, bit-identical to plain into fresh NaN-filled buffers",
        "gbps": k5["kernel_gbps"], "library_gbps": k5["library_gbps"],
        "probe": {"single": k5["probe"], "chain10": k5["probe_chain"]},
    })
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the evaluator's phase timings (model load, features, zero-shot heads)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="  [log] %(message)s")
    sys.path.insert(0, REPO)
    from xclip_tpu_torch.evals import run_lso
    from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX
    from xclip_tpu_torch.evals.metadata import XCLIP_IMAGENET_CLASSES
    from xclip_tpu_torch.models import factory
    from xclip_tpu_torch.ops import _build, flash_attention, fused_conv, stream_scale
    from xclip_tpu_torch.tools import probe_bandwidth
    from xclip_tpu_torch import tokenizer as tokenizer_mod
    from xclip_tpu_torch.train import main as train_main

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    try:
        log("[phase 2] build kernels (nvcc, sm_90a)")
        t0 = time.perf_counter()
        _build.load_library()
        build_s = time.perf_counter() - t0
        log(f"  built and loaded in {build_s:.1f} s")
        build_log = _build.BUILD_DIR / "build.log"
        if build_log.exists():
            for ln in build_log.read_text().splitlines():
                if "entry function" in ln or "Used" in ln or "spill" in ln:
                    log("  ptxas: " + ln.strip())

        log("[phase 3] kernels vs plain at the main path's shapes (fp32, bf16, fp16)")
        rn50 = factory.get_clip_cfg("RN50")
        dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
        report, errs = phase_kernels(torch, fused_conv, flash_attention, rn50, dtypes)

        stats_records, stats_errs = phase_stats_kernel(torch, fused_conv, rn50, dtypes)
        log(f"[phase 3d] K3, K1, K2 in bf16 at the RN50 classifier's training shapes (batch {SUP_BATCH})")
        sup_records, sup_errs = phase_supervised_kernels(torch, fused_conv, rn50)
        log("[phase 3b] each Function's backward vs autograd of its plain version (fp32, bf16)")
        bwd_records, bwd_errs = phase_backward(torch, fused_conv, flash_attention, rn50, factory.get_clip_cfg(SUP_VIT))
        log("[phase 3c] K4 non-causal at the ViT paths' shapes (fp32, bf16, fp16)")
        vit = {}
        vit["records"], vit["errs"] = phase_vit_attention(torch, flash_attention, factory, dtypes)
        log(f"[phase 3e] K4 at head dim 72 ({SIGLIP}'s image and text towers), fp32, bf16, fp16; causal checked")
        records72, errs72 = phase_vit_attention(torch, flash_attention, factory, dtypes,
                                                shapes=timm_attention_shapes(factory), causal_check=True)
        vit["records"] += records72
        vit["errs"] = {d: max(vit["errs"][d], errs72[d]) for d in vit["errs"]}
        phase_s = {"kernels": time.perf_counter() - t_start}

        log("[phase 4] main path: RN50 zero-shot DomainNet-LSO, bf16")
        model, counts, rates = phase_main_path(torch, factory, run_lso, fused_conv, flash_attention,
                                               tokenizer_mod, XCLIP_IMAGENET_CLASSES, LSO_CLASS_TO_IDX)
        log("[phase 4a] fp32 card vs CPU")
        cross = phase_card_vs_cpu(torch, factory, tokenizer_mod, model)
        del model
        torch.cuda.empty_cache()
        phase_s["lso_eval"] = time.perf_counter() - t_start - sum(phase_s.values())
        vit["lso_counts"], vit["lso"] = {}, {}
        for name in VIT_LSO_MODELS:
            log(f"[phase 4b] {name} zero-shot DomainNet-LSO at full width, bf16")
            vit["lso_counts"][name], vit["lso"][name] = phase_vit_lso(
                torch, factory, run_lso, fused_conv, flash_attention, tokenizer_mod, XCLIP_IMAGENET_CLASSES, name)
        vit["towers"] = {}
        for name in VIT_TOWERS:
            log(f"[phase 4c] {name} image tower through K4")
            vit["towers"][name] = phase_vit_tower(torch, factory, flash_attention, name)
        phase_s["vit_eval"] = time.perf_counter() - t_start - sum(phase_s.values())
        for name in TIMM_LSO_MODELS:
            log(f"[phase 4d] {name} zero-shot DomainNet-LSO at full width, bf16")
            vit["lso_counts"][name], vit["lso"][name] = phase_vit_lso(
                torch, factory, run_lso, fused_conv, flash_attention, tokenizer_mod, XCLIP_IMAGENET_CLASSES, name)
        for name in TIMM_TOWERS:
            log(f"[phase 4e] {name} at full width: towers through K4 vs the plain attention")
            vit["towers"][name] = phase_timm_tower(torch, factory, flash_attention, name)
        phase_s["timm_eval"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"  phases 4d-4e took {phase_s['timm_eval']:.1f} s")

        log("[phase 5] training path: RN50, batch 128 x accum 2, amp, grad checkpointing, 12 steps")
        tcounts, training = phase_train(torch, factory, train_main, fused_conv, flash_attention, rn50)
        training["steady_state"] = phase_train_step_timing(torch, factory, tokenizer_mod)
        log("[phase 5b] fp32 train step, card vs CPU")
        training["card_vs_cpu"] = phase_train_card_vs_cpu(torch, factory)
        log("[phase 5c] run-to-run determinism of the train step (child process, CUBLAS_WORKSPACE_CONFIG=:4096:8)")
        training["determinism"] = phase_determinism()
        phase_s["training"] = time.perf_counter() - t_start - sum(phase_s.values())
        log("[phase 5d] the data-parallel path as a 1-rank NCCL group: step bits, train.main with the eval")
        ddp_counts, training["ddp"] = phase_ddp(torch, factory, train_main, fused_conv, flash_attention, rn50,
                                                tokenizer_mod, card)
        phase_s["ddp"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"[phase 5e] {VIT_TRAIN} training path: batch {TRAIN_BATCH} x accum {TRAIN_ACCUM}, amp, grad "
            f"checkpointing, patch dropout {VIT_PATCH_DROPOUT}; tiny ViT fp32 step card vs CPU")
        vit["train_counts"], vit["train"] = phase_vit_train(torch, factory, train_main, fused_conv, flash_attention)
        phase_s["vit_train"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"[phase 5f] supervised baseline: RN50 and {SUP_VIT} 1345-way classifiers at batch {SUP_BATCH}, bf16; "
            "the supervised LSO evaluation; a tiny fp32 classifier step card vs CPU")
        sup_counts, supervised = phase_supervised(torch, factory, fused_conv, flash_attention, card)
        phase_s["supervised"] = time.perf_counter() - t_start - sum(phase_s.values())

        log("[phase 6] K5 stream_scale vs plain, and the bandwidth probe")
        k5 = phase_stream_scale(torch, stream_scale, probe_bandwidth)
        phase_s["probe"] = time.perf_counter() - t_start - sum(phase_s.values())

        log(f"[phase 7] SAE path: RN50 feature cache, SAE {SAE_D} -> {SAE_M} at batch {SAE_BATCH}")
        sae_counts, sae, store = phase_sae(torch, factory, fused_conv, flash_attention, rn50)
        sae["steady_state"] = phase_sae_step_timing(torch, store)
        log("[phase 7b] fp32 SAE step, card vs CPU")
        sae["card_vs_cpu"] = phase_sae_card_vs_cpu(torch, store)
        phase_s["sae"] = time.perf_counter() - t_start - sum(phase_s.values())

        log("[phase 8] interpretability path: RN50 feature circuits (IG through K1/K2, fp32), node and circuit "
            "similarity, CKA, SAE feature sharing, concept naming")
        interp_counts_, interp = phase_interp(torch, factory, fused_conv, flash_attention, card)
        phase_s["interp"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"  phase 8 took {phase_s['interp']:.1f} s")

        log("[phase 9] data fabrication at DomainNet's size: captions, the 7 paper mixtures, the CC3M merge, "
            "the ImageNet-Sketch mixes")
        fabrication = phase_fabrication()
        phase_s["fabrication"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"[phase 10] RN50 training from tar shards: batch {TRAIN_BATCH} x accum {TRAIN_ACCUM}, amp, "
            f"{WDS_STEPS} steps, plain and resampled with weights")
        wds_counts, wds_train = phase_wds_train(torch, factory, train_main, fused_conv, flash_attention, rn50)
        phase_s["wds_train"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"[phase 11] embedding analysis: RN50 features, then densMAP at {UMAP_N} x {UMAP_D}")
        embedding_counts, embedding = phase_embedding(torch, fused_conv, flash_attention, rn50)
        phase_s["embedding"] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"  phases 9-11 took {phase_s['fabrication']:.1f} / {phase_s['wds_train']:.1f} / "
            f"{phase_s['embedding']:.1f} s")

        kernels = summarize(report, errs, counts, tcounts, stats_records, stats_errs, bwd_records, bwd_errs,
                            rn50.text.layers, sae_counts, k5, ddp_counts, vit, sup_counts, sup_records, sup_errs,
                            interp_counts_, wds_counts, embedding_counts)
        detail = {"card": card, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                  "cuda": torch.version.cuda, "build_s": build_s, "kernels": kernels, "report": report,
                  "matmul_stats": stats_records, "backward": bwd_records, "main_path": rates,
                  "launches": counts, "card_vs_cpu": cross, "training": training, "train_launches": tcounts,
                  "ddp_launches": ddp_counts, "vit": vit,
                  "stream_scale": k5, "sae": sae, "sae_launches": sae_counts, "supervised": supervised,
                  "supervised_launches": sup_counts, "classifier_shapes": sup_records, "interp": interp,
                  "interp_launches": interp_counts_, "fabrication": fabrication, "wds_train": wds_train,
                  "wds_launches": wds_counts, "embedding": embedding, "embedding_launches": embedding_counts,
                  "phase_s": phase_s, "total_s": time.perf_counter() - t_start}
        with open(REPORT, "w") as fh:
            json.dump(detail, fh, indent=1)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    for entry in kernels:
        kid = entry["name"].split("(")[1].split(":")[0]
        deep = {d: v["deep_k"] for d, v in entry.get("by_dtype", {}).items() if "deep_k" in v}
        log(f"{kid}: share of bound {entry['share_of_bound']:.3f} (bf16, {entry['per']})"
            + "".join(f"; {d} K>={DEEP_K} {v['kernel_ms']:.4f} vs library {v['library_ms']:.4f} ms"
                      for d, v in deep.items()))
    slower = [s for entry in kernels for s in entry["slower_than_library"]]
    log(f"slower than the library call ({len(slower)} shapes): " + ("; ".join(slower) or "none"))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
