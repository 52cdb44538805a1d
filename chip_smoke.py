#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xclip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure:

1. require CUDA, print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``xclip_tpu_torch/ops/csrc`` with nvcc;
3. hold every kernel against its plain PyTorch version at the shapes the
   RN50 LSO evaluation gives it, in fp32, bf16 and fp16, and time the
   kernel, the plain version, one library call computing the same function
   (the yardstick, used nowhere in the port) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate);
4. drive the main path at full width: a seeded random RN50 saved as an
   open_clip ``.pt``, a seeded synthetic ImageNet/DomainNet tree at 224 px,
   and ``xclip_tpu_torch.evals.run_lso.main(... --precision bf16)`` (86
   templates x (1000 + 345) classes, image batches of 250); check
   results.json, and that every kernel was launched by that run (the
   counts are zeroed just before it and read just after); time one image
   batch and one text chunk; hold an 8-image fp32 batch (and a few prompts)
   encoded on the card against the port on the CPU;
5. print the kernels line, then ``{"ok": true, "device": {...}}`` last.

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
    fused_conv.launches = fused_conv.launches_with_identity = 0
    flash_attention.launches = 0
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


def summarize(report, errs, counts, text_layers: int):
    """One entry per kernel, timed over one image batch (K1/K2: the sum over
    its launches of the per-shape times) or one full text chunk (K4, one
    launch per text block). The top-level numbers are bf16, the main path's
    dtype; ``by_dtype`` holds the same sums for fp32, bf16 and fp16."""
    kernels = (
        ("K1", "matmul_affine_act (K1: conv1, downsample)", "fused_conv.cu", "fused_conv.py:59"),
        ("K2", "matmul_affine_act (K2: conv3 + identity)", "fused_conv.cu", "fused_conv.py:67"),
        ("K4", "flash_attention (K4: causal text self-attention)", "flash_attention.cu",
         "flash_attention.py:31"),
    )
    entries = []
    for kid, name, source, replaces in kernels:
        by_dtype = {}
        for dname in errs[kid]:
            if kid == "K4":
                recs = [dict(r, count_per_batch=text_layers) for r in report["flash_attention"]
                        if r["dtype"] == dname and r["B"] == TEXT_CHUNK]
            else:
                recs = [r for r in report["fused_conv"] if r["kernel"] == kid and r["dtype"] == dname]
            tot = {key: sum(r[key] * r["count_per_batch"] for r in recs)
                   for key in ("kernel_ms", "plain_ms", "library_ms", "ops_ms", "bytes_ms")}
            by_dtype[dname] = {
                "ms": tot["kernel_ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                "bound_ms": max(tot["ops_ms"], tot["bytes_ms"]),
                "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
                "max_abs_err": errs[kid][dname], "launches_per": sum(r["count_per_batch"] for r in recs),
            }
        bf16 = by_dtype["bf16"]
        per = (f"one {TEXT_CHUNK}-prompt text chunk" if kid == "K4" else f"one {BATCH}-image RN50 batch")
        entries.append({
            "name": name, "route": "cuda", "source": f"xclip_tpu_torch/ops/csrc/{source}",
            "replaces": f"xclip_tpu/ops/{replaces}", "launches": counts[kid],
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "dtype": "bf16", "per": f"{per} ({bf16['launches_per']} launches)",
            "status": "built, launched by the main path, agrees with plain in fp32/bf16/fp16",
            "by_dtype": by_dtype,
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

        log("[phase 4] main path: RN50 zero-shot DomainNet-LSO, bf16")
        model, counts, rates = phase_main_path(torch, factory, run_lso, fused_conv, flash_attention,
                                               tokenizer_mod, XCLIP_IMAGENET_CLASSES, LSO_CLASS_TO_IDX)
        log("[phase 4b] fp32 card vs CPU")
        cross = phase_card_vs_cpu(torch, factory, tokenizer_mod, model)

        kernels = summarize(report, errs, counts, rn50.text.layers)
        detail = {"card": card, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                  "cuda": torch.version.cuda, "build_s": build_s, "kernels": kernels, "report": report,
                  "main_path": rates, "launches": counts, "card_vs_cpu": cross,
                  "total_s": time.perf_counter() - t_start}
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
