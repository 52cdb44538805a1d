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
   K4 at the RN50 LSO evaluation's shapes, K3 (``matmul_stats``) at the 16
   conv1 shapes of RN50 training at batch 128; then hold the backward of
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
6. print the kernels line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package. Per-shape numbers also go
to ``build/chip_smoke_report.json`` (nvcc's register/spill report is
``build/xclip_tpu_torch/build.log``); scratch files live in
``build/chip_smoke`` and are removed at the end.
"""

from __future__ import annotations

import json
import math
import os
import shutil
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
TEXT_CHUNK = 2048    # OpenAIZeroShotClassifier's prompt chunk
N_TEMPLATES = 86
N_IMAGENET_CLASSES, N_DOMAINNET_CLASSES = 1000, 345
IMAGENET_WNIDS, IMAGES_PER_WNID = 10, 5
MAIN_CHECK_TOL = 1e-3


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


def bound(rec: dict, flops: float, nbytes: float, dtype: str) -> None:
    """Least time for the work: operations over the peak rate or bytes (each
    input read once, each output written once) over the memory rate."""
    rec["ops_ms"] = flops / PEAK_FLOPS[dtype] * 1e3
    rec["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
    rec["bound_by"] = "operations" if rec["ops_ms"] > rec["bytes_ms"] else "bytes"


def close(got, ref, tol: float):
    """(ok, max_abs_err) for |got - ref| <= tol + tol * |ref|."""
    diff = (got.float() - ref.float()).abs()
    ok = bool(torch_all_finite(got) and (diff <= tol + tol * ref.float().abs()).all())
    return ok, float(diff.max())


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
            report["fused_conv"].append(rec)
            log(f"  {kid} {dname} M={m} K={k} C={c} id={int(ident)} relu={int(relu)} x{len(roles)}: "
                f"kernel_ms={rec['kernel_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
                f"({rec['bound_by']}) max_abs_err={err:.3g}")
            del z, w, g, b, idn
            torch.cuda.empty_cache()

    heads, seq, width = rn50.text.heads, rn50.text.context_length, rn50.text.width
    hd = width // heads
    n_prompts = N_TEMPLATES * (N_IMAGENET_CLASSES + N_DOMAINNET_CLASSES)
    # full chunk and the two tail chunks of the two classifiers
    batches = sorted({TEXT_CHUNK, (N_TEMPLATES * N_IMAGENET_CLASSES) % TEXT_CHUNK,
                      (N_TEMPLATES * N_DOMAINNET_CLASSES) % TEXT_CHUNK} - {0}, reverse=True)
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
                log(f"  K4 {dname} B={bsz} H={heads} L={seq} D={hd} causal: kernel_ms={rec['kernel_ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) max_abs_err={err:.3g}")
            else:
                log(f"  K4 {dname} B={bsz} (tail chunk) max_abs_err={err:.3g}")
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
            records.append(rec)
            log(f"  K3 {dname} M={m} K={k} C={c} x{count}: kernel_ms={rec['kernel_ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
                f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) max_abs_err={err:.3g} "
                f"sums_rel_err={err_s:.3g}")
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


def phase_card_vs_cpu(torch, factory, tokenizer_mod, model_gpu):
    """8 images and 4 prompts in fp32: card vs the port on the CPU, same
    weights. BatchNorm parameters and statistics are set to seeded random
    values on both first: the random init zeroes bn3, which would hide the
    conv1/conv3 kernels' contribution."""
    model_cpu = factory.create_model("RN50", seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    sd = model_cpu.state_dict()
    for key, val in sd.items():
        if ".bn" in key or "downsample.1" in key or key.startswith("visual.bn"):
            if key.endswith(("weight", "running_var")):
                sd[key] = torch.rand(val.shape, generator=gen) + 0.5
            elif key.endswith(("bias", "running_mean")):
                sd[key] = torch.randn(val.shape, generator=gen) * 0.1
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
    fused_conv.launches = fused_conv.launches_with_identity = fused_conv.stats_launches = 0
    fused_conv.affine_act_backward_calls = fused_conv.stats_backward_calls = 0
    flash_attention.launches = flash_attention.backward_calls = 0


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


def phase_train_card_vs_cpu(torch, factory):
    """One fp32 train step (accum 2, grad checkpointing) of a seeded tiny RN
    CLIP on the card and on the CPU: loss and every gradient."""
    import numpy as np

    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    factory._MODEL_CONFIGS["TinyRN-chip-smoke"] = {
        "embed_dim": 64, "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
        "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2}}
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (16, 64, 64, 3)).astype(np.uint8))
    texts = torch.from_numpy(rng.randint(1, 49407, (16, 77)).astype(np.int32))
    results = []
    for device in ("cpu", "cuda"):
        model = factory.create_model("TinyRN-chip-smoke", device=device, seed=0).train()
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


def summarize(report, errs, counts, train_counts_, stats_records, stats_errs, bwd_records, bwd_errs,
              text_layers: int):
    """One entry per kernel. K1/K2 are timed over one 250-image eval batch
    (the sum over its launches of the per-shape times), K4 over one full
    text chunk (one launch per text block), K3 over one 128-image training
    forward (16 launches). The top-level numbers are bf16, the main paths'
    dtype; ``by_dtype`` holds the same sums for fp32, bf16 and fp16.
    ``launches`` counts both main paths' runs (``launches_by_path``).
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
            by_dtype[dname] = {
                "ms": tot["kernel_ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                "bound_ms": max(tot["ops_ms"], tot["bytes_ms"]),
                "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
                "max_abs_err": kid_errs[dname], "launches_per": sum(r["count_per_batch"] for r in recs),
            }
        bf16 = by_dtype["bf16"]
        per = {"K4": f"one {TEXT_CHUNK}-prompt text chunk", "K3": f"one {TRAIN_BATCH}-image RN50 training forward"
               }.get(kid, f"one {BATCH}-image RN50 eval batch")
        by_path = {"lso_eval": counts.get(kid, 0), "train": train_counts_[kid]}
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
            "dtype": "bf16", "per": f"{per} ({bf16['launches_per']} launches)",
            "status": ("forward: built, launched by the main paths, agrees with plain in fp32/bf16/fp16; "
                       "backward: agrees with autograd of plain in fp32/bf16, ran in training"),
            "by_dtype": by_dtype, "backward": backward,
        })
    return entries


def main() -> int:
    import logging

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
    from xclip_tpu_torch.ops import _build, flash_attention, fused_conv
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
        phase_s["training"] = time.perf_counter() - t_start - sum(phase_s.values())

        kernels = summarize(report, errs, counts, tcounts, stats_records, stats_errs, bwd_records, bwd_errs,
                            rn50.text.layers)
        detail = {"card": card, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                  "cuda": torch.version.cuda, "build_s": build_s, "kernels": kernels, "report": report,
                  "matmul_stats": stats_records, "backward": bwd_records, "main_path": rates,
                  "launches": counts, "card_vs_cpu": cross, "training": training, "train_launches": tcounts,
                  "phase_s": phase_s, "total_s": time.perf_counter() - t_start}
        with open(REPORT, "w") as fh:
            json.dump(detail, fh, indent=1)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
