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
   version at one shape per ResNet stage (and the text attention), in fp32
   and bf16, and time both backwards;
4. drive the evaluation path at full width: a seeded random RN50 saved as an
   open_clip ``.pt``, a seeded synthetic ImageNet/DomainNet tree at 224 px,
   and ``xclip_tpu_torch.evals.run_lso.main(... --precision bf16)`` (86
   templates x (1000 + 345) classes, image batches of 250); check
   results.json, and that every kernel of the path was launched by that run
   (the counts are zeroed just before it and read just after); time one
   image batch and one text chunk; hold an 8-image fp32 batch (and a few
   prompts) encoded on the card against the port on the CPU;
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
8. print the kernels line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package. Per-shape numbers also go
to ``build/chip_smoke_report.json`` (nvcc's register/spill report is
``build/xclip_tpu_torch/build.log``); scratch files live in
``build/chip_smoke`` and are removed at the end.
"""

from __future__ import annotations

import ast
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
# the SAE path (scripts/train_sae.py defaults: 1024 -> 4x, batch 4096, one hook point)
SAE_D, SAE_M, SAE_BATCH = 1024, 4096, 4096
SAE_TRAIN_PER_DOMAIN, SAE_TEST_PER_DOMAIN = 1400, 100  # 8,400 train: two steps per epoch
SAE_EPOCHS, SAE_RESAMPLE_FREQ, SAE_TIMED_STEPS = 4, 2, 30
SAE_CACHE_BS, SAE_FEATURES_BS = 1024, 256  # --activations_bs default; save_domainnet_features' batch
SAE_RESAMPLE_ROWS = 8192  # --resample_dataset_size: at most the 8,400 cached train rows
SAE_STEP_RTOL = 1e-5     # phase 7b: loss, card vs CPU (fp32 summation order)
SAE_PARAM_TOL = 1e-4     # phase 7b: gradients (in norm) and parameters after the step (of each tensor's scale)


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


def fused_conv_shapes(cfg, batch: int):
    """(role, M, K, C, identity, relu) of every fused 1x1-conv launch of one
    image batch through the ModifiedResNet (the Bottleneck's eval path)."""
    shapes = []
    hw = cfg.image_size // 4  # stride-2 stem conv + 2x2 avgpool
    inplanes = cfg.width
    for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), cfg.layers)):
        planes = cfg.width * mult
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ohw = hw // stride
            shapes.append(("conv1", batch * hw * hw, inplanes, planes, False, True))
            if stride > 1 or inplanes != planes * 4:
                shapes.append(("downsample", batch * ohw * ohw, inplanes, planes * 4, False, False))
            shapes.append(("conv3", batch * ohw * ohw, planes, planes * 4, True, True))
            hw, inplanes = ohw, planes * 4
    return shapes


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


def phase_backward(torch, fused_conv, flash_attention, rn50):
    """Each Function's backward vs autograd of its plain version: K3 at each
    stage's first conv1, K1 at each downsample, K2 at each stage's first
    conv3 (batch 128), K4 at the text attention of one 128-caption
    microbatch; fp32 and bf16. Times both backwards (retain_graph, CUDA
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


def check_results(results: dict) -> None:
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
            "--num_workers", "8", "--precision", "bf16"]
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
        check_results(json.load(fh))
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


def make_train_tsv(root: str, n: int) -> str:
    """Seeded ``filepath\ttitle`` TSV of n random 256 x 256 JPEGs with
    captions from a fixed list."""
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
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
    # per optimizer step: each microbatch runs the cache forward, the grad
    # forward and the per-block recomputation; each Function's backward once
    fwd = TRAIN_STEPS * TRAIN_ACCUM * 3
    per_fwd = {"K1": 4, "K2": 16, "K3": 16, "K4": rn50.text.layers}
    want = {k: fwd * v for k, v in per_fwd.items()}
    want.update({"K1/K2 backward": TRAIN_STEPS * TRAIN_ACCUM * 20, "K3 backward": TRAIN_STEPS * TRAIN_ACCUM * 16,
                 "K4 backward": TRAIN_STEPS * TRAIN_ACCUM * rn50.text.layers})
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


def phase_train_card_vs_cpu(torch, factory):
    """One fp32 train step (accum 2, grad checkpointing) of a seeded tiny RN
    CLIP on the card and on the CPU: loss and every gradient."""
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    factory._MODEL_CONFIGS[TINY_RN] = TINY_RN_CFG
    images, texts = tiny_batch(torch)
    results = []
    for device in ("cpu", "cuda"):
        model = factory.create_model(TINY_RN, device=device, seed=0).train()
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
    log(f"  fp32 tiny-RN train step, card vs CPU: loss rel err {loss_err:.3g}, worst gradient rel err "
        f"{grad_err:.3g} (tolerance {TRAIN_CHECK_TOL}: fp32 summation order through 15 BatchNorms)")
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


def phase_sae_kernel_shapes(torch, fused_conv, rn50, batches) -> dict:
    """K1/K2 vs plain in fp32 at every fused-conv shape of the SAE path's
    image batches (the feature cache's full and ragged batches, and
    save_domainnet_features'): phase 3 checks the eval batch of 250 only."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    unique = sorted({s[1:] for bsz in batches for s in fused_conv_shapes(rn50.vision, bsz)}, reverse=True)
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
            fail(f"matmul_affine_act fp32 M={m} K={k} C={c} id={ident} (SAE path): max_abs_err {err}")
        del z, w, g, b, idn, got, ref
    torch.cuda.empty_cache()
    log(f"  K1/K2 fp32 vs plain at the SAE path's {len(unique)} shapes (image batches {batches}, largest M "
        f"{unique[0][0]}): max_abs_err K1 {errs['K1']:.3g}, K2 {errs['K2']:.3g} (tolerance {TOLERANCE['fp32']})")
    return {"batches": batches, "shapes": len(unique), "max_abs_err": errs}


def check_tower_routes(torch, fused_conv, enc, images, tail: int, per_batch: int) -> dict:
    """The fp32 image tower through the kernels against the same model with
    its 1x1 convs on the plain route, at the cache's batch and its ragged
    tail; the kernel route launches ``per_batch`` kernels, the plain none."""
    from xclip_tpu_torch.models import resnet

    errs = {}
    with torch.inference_mode():
        for n in (len(images), tail):
            before = fused_conv.launches
            got = enc.encode_image(images[:n], normalize=True)
            kernel_route, resnet.matmul_affine_act = resnet.matmul_affine_act, fused_conv.matmul_affine_act_plain
            try:
                ref = enc.encode_image(images[:n], normalize=True)
            finally:
                resnet.matmul_affine_act = kernel_route
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
    shape_check = phase_sae_kernel_shapes(torch, fused_conv, rn50, batches)
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


def summarize(report, errs, counts, train_counts_, stats_records, stats_errs, bwd_records, bwd_errs,
              text_layers: int, sae_counts, k5):
    """One entry per kernel. K1/K2 are timed over one 250-image eval batch
    (the sum over its launches of the per-shape times), K4 over one full
    text chunk (one launch per text block), K3 over one 128-image training
    forward (16 launches). The top-level numbers are bf16, the main paths'
    dtype; ``by_dtype`` holds the same sums for fp32, bf16 and fp16.
    ``launches`` counts the main paths' runs (``launches_by_path``: the LSO
    evaluation, training, and the SAE path's two feature CLIs). K5 is timed
    over one pass of the probe's 8192 x 8192 bf16 array, its launches are
    the probe's two runs.
    ``backward`` holds the Function's plain backward against autograd of the
    plain version at one shape per stage (bf16 and fp32 times summed over
    those shapes)."""
    kernels = (
        ("K1", "matmul_affine_act (K1: conv1 in eval, downsample)", "fused_conv.cu", "fused_conv.py:59",
         "K1/K2 backward"),
        ("K2", "matmul_affine_act (K2: conv3 + identity)", "fused_conv.cu", "fused_conv.py:67", "K1/K2 backward"),
        ("K3", "matmul_stats (K3: conv1 + BatchNorm batch sums, training)", "fused_conv.cu", "fused_conv.py:187",
         "K3 backward"),
        ("K4", "flash_attention (K4: causal text self-attention)", "flash_attention.cu",
         "flash_attention.py:31", "K4 backward"),
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
        by_path = {"lso_eval": counts.get(kid, 0), "train": train_counts_[kid],
                   "sae_feature_cache": sae_counts["cache"][kid], "save_domainnet_features": sae_counts["features"][kid]}
        bwd = [r for r in bwd_records if r["kernel"] == kid]
        backward = {
            "route": "plain PyTorch in a torch.autograd.Function (no backward kernel yet)",
            "calls_in_train": train_counts_[bwd_key], "rel_err": bwd_errs[kid],
            "shapes": sorted({r["shape"] for r in bwd}),
            "ms_bf16": sum(r["backward_ms"] for r in bwd if r["dtype"] == "bf16"),
            "plain_ms_bf16": sum(r["plain_backward_ms"] for r in bwd if r["dtype"] == "bf16"),
            "ms_fp32": sum(r["backward_ms"] for r in bwd if r["dtype"] == "fp32"),
            "plain_ms_fp32": sum(r["plain_backward_ms"] for r in bwd if r["dtype"] == "fp32"),
        }
        entries.append({
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
        })
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
        log("[phase 3b] each Function's backward vs autograd of its plain version (fp32, bf16)")
        bwd_records, bwd_errs = phase_backward(torch, fused_conv, flash_attention, rn50)
        phase_s = {"kernels": time.perf_counter() - t_start}

        log("[phase 4] main path: RN50 zero-shot DomainNet-LSO, bf16")
        model, counts, rates = phase_main_path(torch, factory, run_lso, fused_conv, flash_attention,
                                               tokenizer_mod, XCLIP_IMAGENET_CLASSES, LSO_CLASS_TO_IDX)
        log("[phase 4b] fp32 card vs CPU")
        cross = phase_card_vs_cpu(torch, factory, tokenizer_mod, model)
        del model
        torch.cuda.empty_cache()
        phase_s["lso_eval"] = time.perf_counter() - t_start - sum(phase_s.values())

        log("[phase 5] training path: RN50, batch 128 x accum 2, amp, grad checkpointing, 12 steps")
        tcounts, training = phase_train(torch, factory, train_main, fused_conv, flash_attention, rn50)
        training["steady_state"] = phase_train_step_timing(torch, factory, tokenizer_mod)
        log("[phase 5b] fp32 train step, card vs CPU")
        training["card_vs_cpu"] = phase_train_card_vs_cpu(torch, factory)
        log("[phase 5c] run-to-run determinism of the train step (child process, CUBLAS_WORKSPACE_CONFIG=:4096:8)")
        training["determinism"] = phase_determinism()
        phase_s["training"] = time.perf_counter() - t_start - sum(phase_s.values())

        log("[phase 6] K5 stream_scale vs plain, and the bandwidth probe")
        k5 = phase_stream_scale(torch, stream_scale, probe_bandwidth)
        phase_s["probe"] = time.perf_counter() - t_start - sum(phase_s.values())

        log(f"[phase 7] SAE path: RN50 feature cache, SAE {SAE_D} -> {SAE_M} at batch {SAE_BATCH}")
        sae_counts, sae, store = phase_sae(torch, factory, fused_conv, flash_attention, rn50)
        sae["steady_state"] = phase_sae_step_timing(torch, store)
        log("[phase 7b] fp32 SAE step, card vs CPU")
        sae["card_vs_cpu"] = phase_sae_card_vs_cpu(torch, store)
        phase_s["sae"] = time.perf_counter() - t_start - sum(phase_s.values())

        kernels = summarize(report, errs, counts, tcounts, stats_records, stats_errs, bwd_records, bwd_errs,
                            rn50.text.layers, sae_counts, k5)
        detail = {"card": card, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                  "cuda": torch.version.cuda, "build_s": build_s, "kernels": kernels, "report": report,
                  "matmul_stats": stats_records, "backward": bwd_records, "main_path": rates,
                  "launches": counts, "card_vs_cpu": cross, "training": training, "train_launches": tcounts,
                  "stream_scale": k5, "sae": sae, "sae_launches": sae_counts,
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
