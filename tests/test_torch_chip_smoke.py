"""The shape lists and the report logic of ``chip_smoke.py`` on the CPU.

``chip_smoke.py`` holds each kernel at the main paths' shapes and fails on
inexact launch counts, so the shapes it derives are checked here against
RN50's layers; its per-shape summary (share of the bound, the shapes at
which a kernel is slower than its library call) is checked on made-up
records. Neither needs a card: the script imports torch and the port only
inside its phases.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from xclip_tpu_torch.models import factory  # noqa: E402


@pytest.fixture(scope="module")
def rn50():
    return factory.get_clip_cfg("RN50").vision


def test_eval_and_training_shapes_of_rn50(rn50):
    """36 fused-conv launches per 250-image eval batch (16 conv1, 16 conv3
    with the identity, 4 downsamples), 16 conv1 launches (K3) per
    128-image training forward, with RN50's widths."""
    shapes = chip_smoke.fused_conv_shapes(rn50, chip_smoke.BATCH)
    roles = [s[0] for s in shapes]
    assert len(shapes) == 36
    assert (roles.count("conv1"), roles.count("conv3"), roles.count("downsample")) == (16, 16, 4)
    assert all(ident == (role == "conv3") for role, _, _, _, ident, _ in shapes)
    assert {m for _, m, _, _, _, _ in shapes} == {784000, 196000, 49000, 12250}
    conv1 = chip_smoke.conv1_shapes(rn50, chip_smoke.TRAIN_BATCH)
    assert len(conv1) == 16 and conv1[0] == (401408, 64, 64) and conv1[-1] == (6272, 2048, 512)
    # the late layers summed apart as "deep_k": 7 distinct K1 shapes of the eval, 5 of K3
    k1 = {(m, k, c) for role, m, k, c, ident, _ in shapes if not ident and k >= chip_smoke.DEEP_K}
    assert len(k1) == 7 and (12250, 2048, 512) in k1
    assert len({s for s in conv1 if s[1] >= chip_smoke.DEEP_K}) == 5


def test_share_of_bound_and_slower_than_library():
    fast = {"kernel": "K1", "dtype": "bf16", "M": 12250, "K": 2048, "C": 512,
            "kernel_ms": 0.05, "library_ms": 0.08, "bound_ms": 0.026}
    slow = {"kernel": "K3", "dtype": "fp16", "M": 6272, "K": 2048, "C": 512,
            "kernel_ms": 0.1, "library_ms": 0.05, "bound_ms": 0.02}
    k5 = {"kernel": "K5", "dtype": "bf16", "shape": [8192, 8192],
          "kernel_ms": 0.099, "library_ms": 0.092, "bound_ms": 0.080}
    for rec in (fast, slow, k5):
        chip_smoke.share(rec)
    assert fast["share_of_bound"] == pytest.approx(0.52) and not fast["slower_than_library"]
    assert slow["share_of_bound"] == pytest.approx(0.2) and slow["slower_than_library"]
    assert chip_smoke.slower_list([fast, slow, k5]) == [
        "K3 fp16 M=6272 K=2048 C=512: 0.1000 > 0.0500 ms",
        "K5 bf16 8192x8192: 0.0990 > 0.0920 ms"]


def test_training_path_counts_of_rn50():
    """Phase 5's exact counts: 12 steps x accum 2, three forwards per
    microbatch (cache, grad, recomputation)."""
    cfg = factory.get_clip_cfg("RN50")
    assert chip_smoke.train_path_counts(cfg, chip_smoke.TRAIN_STEPS, chip_smoke.TRAIN_ACCUM) == {
        "K1": 288, "K2": 1152, "K3": 1152, "K4": 864,
        "K1/K2 backward": 480, "K3 backward": 384, "K4 backward": 288}


@pytest.mark.parametrize("n,batch,text,batches", [(1000, 128, False, 8), (256, 128, True, 2), (250, 250, False, 1),
                                                  (129, 128, True, 2)])
def test_eval_tower_counts_take_the_tail_batch(n, batch, text, batches):
    """One launch set per batch, the ragged tail included: 20 K1 (16 conv1,
    4 downsamples) and 16 K2 per image batch, 12 K4 per caption batch."""
    cfg = factory.get_clip_cfg("RN50")
    assert chip_smoke.eval_tower_counts(cfg, n, batch, text) == {
        "K1": 20 * batches, "K2": 16 * batches, "K4": 12 * batches if text else 0}


def test_ddp_phase_counts_of_rn50():
    """Phase 5d: 2 training steps (K1 48, K2 192, K3 192, K4 144), the
    80,000-prompt head in 40 chunks of 2048 (39 full, one of 128) through
    12 text layers (K4 480), the 1,000-image tree in 7 batches of 128 and a
    tail of 104 (K1 160, K2 128), the 256-image val TSV in 2 batches (K1
    40, K2 32, K4 24)."""
    cfg = factory.get_clip_cfg("RN50")
    assert chip_smoke.DDP_IMAGENET_CLASSES * chip_smoke.ZERO_SHOT_TEMPLATES == 80000
    assert divmod(80000, chip_smoke.TEXT_CHUNK) == (39, 128)
    assert chip_smoke.ddp_path_counts(cfg) == {
        "K1": 48 + 160 + 40, "K2": 192 + 128 + 32, "K3": 192, "K4": 144 + 480 + 24,
        "K1/K2 backward": 80, "K3 backward": 64, "K4 backward": 48}


def test_ddp_eval_batches_cover_the_tails():
    """Phase 5d holds K1/K2 against plain in fp32 at the CLI's batch of 128
    and the 1,000-image tree's tail of 104 (the 256-image val TSV has
    none)."""
    assert chip_smoke.ddp_eval_batches() == [128, 104]


def test_zero_shot_template_count_matches_the_metadata():
    from xclip_tpu_torch.evals import metadata

    assert len(metadata.OPENAI_IMAGENET_TEMPLATES) == chip_smoke.ZERO_SHOT_TEMPLATES
    assert len(metadata.IMAGENET_CLASSNAMES) == chip_smoke.DDP_IMAGENET_CLASSES


def test_vit_attention_shapes():
    """Phase 3c's K4 shapes (B, H, L, D): the eval batches of 250 at 257
    tokens of ViT-L-14 (head dim 64), ViT-H-14 (80), ViT-g-14 (88),
    ViT-bigG-14 (104) and ViT-e-14 (112), ViT-B-16's training microbatch
    at 197 tokens and at the 1 + 98 that patch dropout 0.5 keeps, 64
    images of ViT-L-14-336 at 577 tokens, and the ViT-B-32 classifier's
    training batch of 256 at 50 tokens."""
    assert [s[1:] for s in chip_smoke.vit_attention_shapes(factory)] == [
        (250, 16, 257, 64), (250, 16, 257, 80), (250, 16, 257, 88), (250, 16, 257, 104), (250, 16, 257, 112),
        (128, 12, 197, 64), (128, 12, 99, 64), (64, 16, 577, 64), (256, 12, 50, 64)]


def test_vit_lso_counts_of_vit_l14():
    """Phase 4b: phase 4's 50 ImageNet and 690 DomainNet images in 1 + 3
    batches through 24 layers (head dim 64), the 86,000 + 29,670 prompts in
    42 + 15 chunks through 12 layers (causal, head dim 64); no K1/K2."""
    cfg = factory.get_clip_cfg(chip_smoke.VIT_EVAL)
    assert (cfg.vision.layers, cfg.text.layers) == (24, 12)
    by_shape = {"D=64": 24 * 4, "D=64 causal": 12 * 57}
    assert chip_smoke.vit_lso_counts(cfg) == ({"K1": 0, "K2": 0, "K4": 24 * 4 + 12 * 57}, by_shape)


def test_vit_lso_counts_of_vit_bigg14():
    """Phase 4b at ViT-bigG-14: the same 4 image batches through 48 layers
    at head dim 104 and 57 prompt chunks through 32 text layers (causal,
    head dim 64): 48 launches per batch, 32 per chunk."""
    assert chip_smoke.VIT_LSO_MODELS == (chip_smoke.VIT_EVAL, chip_smoke.VIT_BIGG)
    cfg = factory.get_clip_cfg(chip_smoke.VIT_BIGG)
    assert (cfg.vision.layers, cfg.text.layers) == (48, 32)
    by_shape = {"D=104": 48 * 4, "D=64 causal": 32 * 57}
    assert chip_smoke.vit_lso_counts(cfg) == ({"K1": 0, "K2": 0, "K4": 48 * 4 + 32 * 57}, by_shape)


def test_vit_towers_cover_the_remaining_head_dims():
    """Phase 4c: the image towers at head dims 80, 88 and 112, with the
    layers and widths of their configs; with phase 4b's 64 and 104 every
    head dim of K4 runs in a whole tower."""
    got = [(v.layers, v.width, v.width // v.heads) for v in
           (factory.get_clip_cfg(name).vision for name in chip_smoke.VIT_TOWERS)]
    assert got == [(32, 1280, 80), (40, 1408, 88), (56, 1792, 112)]


def test_vit_train_counts_of_vit_b16():
    """Phase 5e: one epoch of 1,024 rows at 128 x accum 2 is 4 steps, 8
    microbatches of three forwards through 12 + 12 layers, one backward
    per layer and microbatch."""
    cfg = factory.get_clip_cfg(chip_smoke.VIT_TRAIN, force_patch_dropout=chip_smoke.VIT_PATCH_DROPOUT)
    assert chip_smoke.VIT_TRAIN_STEPS == 4
    assert chip_smoke.vit_train_counts(cfg, chip_smoke.VIT_TRAIN_STEPS, chip_smoke.TRAIN_ACCUM) == {
        "K1": 0, "K2": 0, "K3": 0, "K4": 576, "K1/K2 backward": 0, "K3 backward": 0, "K4 backward": 192}


def test_supervised_path_counts():
    """Phase 5f's exact counts. RN50 classifier, 8 steps at batch 256 and 2
    validation batches: per step K3 at the 16 conv1s, K1 at the 4
    downsamples, K2 at the 16 conv3s and each Function's backward once; per
    eval-mode batch K1 at the 20 conv1s and downsamples, K2 at the 16
    conv3s. The supervised evaluation: 3 checkpoints x 3 batches (690
    DomainNet images in 250s). ViT-B-32: 4 steps and 1 validation batch
    through 12 layers."""
    rn50, vit = factory.get_clip_cfg("RN50"), factory.get_clip_cfg(chip_smoke.SUP_VIT)
    assert chip_smoke.SUP_TRAIN_ROWS // chip_smoke.SUP_BATCH == 4
    assert chip_smoke.supervised_path_counts(rn50, 8, 2) == {
        "K1": 8 * 4 + 2 * 20, "K2": 8 * 16 + 2 * 16, "K3": 8 * 16, "K4": 0,
        "K1/K2 backward": 8 * 20, "K3 backward": 8 * 16, "K4 backward": 0}
    assert chip_smoke.supervised_path_counts(rn50, 0, 0, 9) == {
        "K1": 180, "K2": 144, "K3": 0, "K4": 0, "K1/K2 backward": 0, "K3 backward": 0, "K4 backward": 0}
    assert chip_smoke.supervised_path_counts(vit, 4, 1) == {
        "K1": 0, "K2": 0, "K3": 0, "K4": 60, "K1/K2 backward": 0, "K3 backward": 0, "K4 backward": 48}


def test_combined_tree_labels(tmp_path, monkeypatch):
    """Phase 5f's CombinedNet tree (at a smaller size): every row's folder is
    a wnid or a DomainNet class of the real mapping files (CombinedNet
    refuses anything else), the folded wnids land in the DomainNet range,
    both TSVs have their row counts and the same labels."""
    from xclip_tpu_torch.data.datasets import CombinedNet

    monkeypatch.setattr(chip_smoke, "SUP_TRAIN_ROWS", 32)
    monkeypatch.setattr(chip_smoke, "SUP_VAL_ROWS", 16)
    monkeypatch.setattr(chip_smoke, "SUP_WNIDS", 6)
    monkeypatch.setattr(chip_smoke, "SUP_FOLDED", 2)
    monkeypatch.setattr(chip_smoke, "SUP_DN_CLASSES", 2)
    monkeypatch.setattr(chip_smoke, "REPO", str(ROOT))
    train, val = chip_smoke.make_combined_tree(str(tmp_path))
    index, mapping = ROOT / "data" / "imagenet_class_index.json", ROOT / "data" / "in_to_dn_mapping.json"
    ds = {name: CombinedNet(tsv, str(index), str(mapping), transform=None) for name, tsv in (("train", train),
                                                                                           ("val", val))}
    assert (len(ds["train"]), len(ds["val"])) == (32, 16)
    labels = sorted({lab for _, lab in ds["train"].samples})
    # 8 folders; a folded wnid may land on a chosen DomainNet class's label
    assert 6 <= len(labels) <= 8 and sum(lab < 1000 for lab in labels) == 4
    assert {lab for _, lab in ds["val"].samples} == set(labels)


def test_check_results_reads_the_topk_keys():
    """Phase 4's results.json with ``--topk``: every top-k and F1 key, top-1
    equal to the accuracy; a missing key or a top-1 that differs fails."""
    splits = [f"{d}-lso-{s}" for d in ("sketch", "real") for s in ("ood", "id")]
    acc = {k: [0.5] for k in splits + ["sketch-lso-unweighted-id", "sketch-lso-unweighted-ood", "sketch-banana-ood",
                                       "real-traffic light-ood"]}
    results = {"steps": [1], "domain": "sketch",
               "imagenet-val": {"accuracy": {"total": [0.25]}, "f1-score": {"total": [0.1]},
                                **{f"top-{k}-accuracy": {"total": [0.25 if k == 1 else 0.75]} for k in (1, 5, 10)}},
               "domainnet-val": {"accuracy": acc, "num-samples": {"sketch-lso-ood": [15]},
                                 "f1-score": {k: [0.2] for k in splits},
                                 **{f"top-{k}-accuracy": {s: [0.5 if k == 1 else 0.9] for s in splits}
                                    for k in (1, 5, 10)}}}
    chip_smoke.check_results(results, (1, 5, 10))
    chip_smoke.check_results(results)
    results["domainnet-val"]["top-1-accuracy"]["real-lso-id"] = [0.4]
    with pytest.raises(SystemExit, match="top-1"):
        chip_smoke.check_results(results, (1, 5, 10))
    del results["imagenet-val"]["f1-score"]
    with pytest.raises(SystemExit, match="f1-score"):
        chip_smoke.check_results(results, (1, 5, 10))


def test_interp_counts_of_rn50(monkeypatch):
    """Phase 8's K1/K2 launches per class circuit of RN50, with every IG
    segment in one chunk: 22 no-grad forwards of the tower (20 K1 and 16 K2
    launches each), the nodes' passes from each of the 22 stages to the head
    (243 K1, 200 K2) and the 21 edge segments (20 K1, 16 K2); the backward
    calls are the IG launches. A smaller budget splits the segments into
    more chunks, each a forward and a backward."""
    import numpy as np

    from xclip_tpu_torch.interp import attribution
    from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel

    model = factory.create_model("RN50", device="cpu")
    cm = VisualCircuitModel(model, np.zeros((1, 1024), np.float32))
    cpu = next(model.parameters()).device
    monkeypatch.setattr(attribution, "chunk_budget", lambda device: 1 << 60)
    assert chip_smoke.interp_counts(cm, 16, 10, cpu) == {"K1": 440 + 243 + 20, "K2": 352 + 200 + 16,
                                                         "K1/K2 backward": 243 + 20 + 200 + 16}
    monkeypatch.setattr(attribution, "chunk_budget", lambda device: 1 << 30)
    small = chip_smoke.interp_counts(cm, 16, 10, cpu)
    assert small["K1"] - 440 == small["K1/K2 backward"] - (small["K2"] - 352) > 263


def test_interp_kernel_shapes_of_rn50(monkeypatch):
    """The (M, K, C) phase 8 holds K1/K2 at: with every IG segment in one
    chunk, each bottleneck at 16 images (the clean passes) and at 160
    copies (the nodes), and each edge's own bottleneck at its neurons'
    copies: resblock1 at 26 x 160 of them, resblock4 (layer2.0, whose
    conv1 runs before the stride) at 52 x 160 over 56 x 56 pixels, the
    most rows. A smaller budget cuts the edges' rows into the chunks that
    run."""
    import numpy as np

    from xclip_tpu_torch.interp import attribution
    from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel

    model = factory.create_model("RN50", device="cpu")
    cm = VisualCircuitModel(model, np.zeros((1, 1024), np.float32))
    cpu = next(model.parameters()).device
    monkeypatch.setattr(attribution, "chunk_budget", lambda device: 1 << 60)
    shapes = chip_smoke.interp_kernel_shapes(cm, 16, 10, cpu)
    clean = {s[1:] for s in chip_smoke.fused_conv_shapes(cm.cfg, 16)}
    nodes = {s[1:] for s in chip_smoke.fused_conv_shapes(cm.cfg, 160)}
    assert clean | nodes <= shapes
    assert (26 * 160 * 56 * 56, 64, 64, False, True) in shapes  # resblock1's conv1
    assert max(shapes) == (52 * 160 * 56 * 56, 256, 128, False, True)  # resblock4's conv1
    assert (205 * 160 * 7 * 7, 512, 2048, True, True) in shapes  # resblock16's conv3
    monkeypatch.setattr(attribution, "chunk_budget", lambda device: 1 << 30)
    small = chip_smoke.interp_kernel_shapes(cm, 16, 10, cpu)
    sizes = {size for size, blocks, _ in chip_smoke.interp_passes(cm, 16, 10, cpu) if blocks}
    assert max(small)[0] < 26 * 160 * 56 * 56 and max(small)[0] in {n * 56 * 56 for n in sizes}


def test_hsic1_cancellation_grows_with_a_common_offset():
    """Phase 8's conditioning figure: 1 where no term cancels, and about
    offset^2-fold larger when the class means share a large offset; the
    terms' sum is the port's HSIC1(K, K) times n (n - 3)."""
    import numpy as np
    import torch

    from xclip_tpu_torch.interp import cka

    x = np.random.RandomState(0).randn(12, 6)
    base = chip_smoke.hsic1_cancellation(x)
    assert 1.0 <= base < 100
    assert chip_smoke.hsic1_cancellation(x + 100.0) > 1000 * base
    k = torch.from_numpy(x @ x.T)
    k_t = k - torch.diag(torch.diagonal(k))
    terms = [torch.trace(k_t @ k_t), k_t.sum() ** 2 / (11 * 10), 2.0 / 10 * (k_t @ k_t).sum()]
    assert float(sum(abs(t) for t in terms) / (12 * 9 * cka.hsic1(k, k))) == pytest.approx(base, rel=1e-12)


def test_fabrication_phase_builds_the_paper_mixtures():
    """Phase 9 builds the seven paper mixtures under their identifiers, at
    DomainNet's published 586,575 rows."""
    from xclip_tpu_torch.data import lso, mixtures

    assert [m for m, _ in chip_smoke.FAB_MIXTURES] == mixtures.PAPER_MIXTURES
    for ident, kw in chip_smoke.FAB_MIXTURES:
        exclude_domains = kw.get("exclude_domains", [])
        if kw.get("single_domain"):
            exclude_domains = [d for d in lso.ALL_DOMAINS if d not in (kw["exclude"], "real")]
        if kw.get("real_only"):
            exclude_domains = [d for d in lso.ALL_DOMAINS if d != "real"]
        assert lso.build_identifier(real_only=kw.get("real_only", False), domains=lso.ALL_DOMAINS,
                                    exclude_domains=exclude_domains, exclude=kw.get("exclude"),
                                    subsample=kw.get("subsample", False), pseudo_exclude=False, allow_pct=0.0,
                                    aligned_captions=False) == ident
    assert sum(sum(v) for v in chip_smoke.FAB_DN_COUNTS.values()) == 586575


def test_wds_training_counts_of_rn50():
    """Phase 10's exact counts a run: 4 steps x accum 2, as the TSV path."""
    cfg = factory.get_clip_cfg("RN50")
    assert chip_smoke.train_path_counts(cfg, chip_smoke.WDS_STEPS, chip_smoke.TRAIN_ACCUM) == {
        "K1": 96, "K2": 384, "K3": 384, "K4": 288, "K1/K2 backward": 160, "K3 backward": 128, "K4 backward": 96}


def test_read_train_log(tmp_path):
    log = tmp_path / "out.log"
    log.write_text("2026 | INFO | Start epoch 0\n"
                   "2026 | INFO | Train Epoch: 0 [ 256/1024 (25%)] Loss: 5.5452 (5.545) Data (t): 0.012 "
                   "Batch (t): 0.431, 593.968/s, 593.968/s/gpu Scale: 14.286\n")
    lines, losses, rates = chip_smoke.read_train_log(str(log))
    assert len(lines) == 1 and losses == [5.5452] and rates == [593.968]


def test_timm_attention_shapes_at_head_dim_72():
    """Phase 3e's K4 shapes (B, H, L, D): ViT-SO400M-14-SigLIP's eval batch
    of 250 at its 256 patch tokens (no class token) and a 2048-prompt chunk
    of its 16-token text tower, both at head dim 72."""
    assert [s[1:] for s in chip_smoke.timm_attention_shapes(factory)] == [(250, 16, 256, 72), (2048, 16, 16, 72)]


@pytest.mark.parametrize("name,image_layers,head_dim,text_layers", [("EVA02-L-14", 24, 64, 12),
                                                                    ("convnext_large_d", 0, None, 16)])
def test_timm_lso_counts(name, image_layers, head_dim, text_layers):
    """Phase 4d: EVA02-L-14's 4 image batches through 24 layers at head dim
    64 share a key with nothing (its text tower is causal), 57 prompt
    chunks through 12 text layers; convnext_large_d launches K4 only in its
    16-layer text tower."""
    assert name in chip_smoke.TIMM_LSO_MODELS
    cfg = factory.get_clip_cfg(name)
    by_shape = {"D=64 causal": text_layers * 57}
    if image_layers:
        by_shape = {f"D={head_dim}": image_layers * 4, **by_shape}
    assert chip_smoke.vit_lso_counts(cfg) == ({"K1": 0, "K2": 0, "K4": sum(by_shape.values())}, by_shape)
    assert chip_smoke.tower_depth(cfg.vision) == (24 if image_layers else 36)


def test_timm_towers_cover_the_slice_shapes():
    """Phase 4e: EVA02-E-14 (64 layers, width 1792, head dim 112, post-norm),
    ViT-SO400M-14-SigLIP (27 + 27 layers at head dim 72; text not causal,
    16 tokens) and convnext_xxlarge (no attention)."""
    eva, siglip, convnext = (factory.get_clip_cfg(name) for name in chip_smoke.TIMM_TOWERS)
    assert (eva.vision.layers, eva.vision.width, eva.vision.head_dim, eva.vision.post_norm) == (64, 1792, 112, True)
    assert (siglip.vision.layers, siglip.vision.head_dim, siglip.vision.seq_len) == (27, 72, 256)
    assert (siglip.text.layers, siglip.text.width // siglip.text.heads, siglip.text.context_length,
            siglip.text.no_causal_mask) == (27, 72, 16, True)
    assert chip_smoke.is_convnext(convnext.vision) and convnext.vision.dims[-1] == 3072
    assert not any(chip_smoke.is_convnext(c.vision) for c in (eva, siglip))


def test_randomize_layer_scale_touches_only_convnext_gammas():
    import torch

    from xclip_tpu_torch.models import convnext as port_convnext

    cfg = port_convnext.ConvNeXtCfg((1, 1, 1, 1), (8, 16, 16, 32), 8, image_size=32)
    tower = port_convnext.ConvNeXt(cfg)
    tower.init_parameters(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tower.state_dict().items()}
    chip_smoke.randomize_layer_scale(torch, tower, torch.Generator().manual_seed(1))
    for key, val in tower.state_dict().items():
        if key.endswith(".gamma"):
            assert float(val.min()) >= 0.5 and float(val.max()) < 1.5
        else:
            assert torch.equal(val, before[key]), key


def test_tower_gate_holds_bf16_to_the_witness_and_catches_a_wrong_route(monkeypatch):
    """Phases 4c and 4e's rule on a tiny EVA02 tower on the CPU (where K4's
    wrapper runs the plain version, so the kernel route equals the plain
    one): bf16 passes with the tolerance max(1e-2, 1.25 x the witness's
    distance) and every block checked; an attention route that is off by
    2 % fails the tower, and in fp32 as well."""
    import numpy as np
    import torch

    from xclip_tpu_torch.models import eva
    from xclip_tpu_torch.ops import flash_attention

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, *a: 1.0)
    torch.set_num_threads(1)
    cfg = eva.EvaCfg(timm_name="eva02_test", output_dim=24, image_size=32, patch_size=8, width=64, layers=2,
                     heads=1, mlp_ratio=4 * 2 / 3, qkv_fused=False, swiglu=True, rope=True, ref_grid=4)
    tower = eva.Eva(cfg)
    tower.init_parameters(torch.Generator().manual_seed(0))
    tower.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32))
    blocks, calls = tower.trunk.blocks, []
    with torch.inference_mode():
        rec = chip_smoke.hold_tower_routes(torch, flash_attention, "tiny", lambda: tower(x, dtype=torch.bfloat16),
                                           "bf16", 0, 64, blocks)
        assert rec["rel_err"] == 0 and rec["block_update_rel_err"] == 0 and rec["p_rounded_rel_err"] > 0
        assert rec["tolerance"] == max(chip_smoke.VIT_TOWER_TOL["bf16"],
                                       chip_smoke.TOWER_NOISE_RATIO * rec["p_rounded_rel_err"])
        plain = flash_attention.flash_attention

        def off(q, k, v, causal=False, sm_scale=None):
            calls.append(q.shape)
            return plain(q, k, v, causal=causal, sm_scale=sm_scale) * 1.02

        monkeypatch.setattr(flash_attention, "flash_attention", off)
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
            with pytest.raises(SystemExit, match="rel err"):
                chip_smoke.hold_tower_routes(torch, flash_attention, "tiny", lambda: tower(x, dtype=dt), dname,
                                             0, 64, blocks)
    assert len(calls) >= 2 * cfg.layers
