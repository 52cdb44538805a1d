"""The port's CUDA kernels and models on a card (marker ``gpu``).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q

(``--noconftest``: tests/conftest.py configures JAX). Without a CUDA device
every test skips. Inputs are small, with ragged edges; the full-size shapes
are checked by ``chip_smoke.py``. Tolerances: fp32 differs from the plain
version by summation order only (atol = rtol = 1e-4); bf16 and fp16 by one
rounding of the IO type (about 1 ulp: 1e-2 and 2e-3).
"""

import math

import numpy as np
import pytest
import torch

from xclip_tpu_torch.ops import flash_attention, fused_conv

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _maa(m, k, c, dt, seed):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(m, k, generator=gen)
    w = torch.randn(k, c, generator=gen) / math.sqrt(k)
    g = torch.rand(c, generator=gen) + 0.5
    b = torch.randn(c, generator=gen) * 0.1
    ident = torch.randn(m, c, generator=gen)
    return [t.cuda() for t in (z.to(dt), w.to(dt), g, b, ident.to(dt))]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,c", [(1000, 72, 200), (12250, 64, 40), (7, 36, 20), (129, 8, 8)])
def test_matmul_affine_act_kernel_matches_plain(cuda, dt, m, k, c):
    z, w, g, b, ident = _maa(m, k, c, dt, seed=m + k)
    before = fused_conv.launches
    for identity in (None, ident):
        for relu in (False, True):
            got = fused_conv.matmul_affine_act(z, w, g, b, identity, relu=relu)
            ref = fused_conv.matmul_affine_act_plain(z, w, g, b, identity, relu=relu)
            assert got.dtype == dt and got.is_cuda
            torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dt], rtol=TOL[dt])
    assert fused_conv.launches == before + 4


@pytest.mark.gpu
def test_matmul_affine_act_unaligned_views(cuda):
    """A contiguous view starting off a 16-byte boundary takes the scalar
    load path and gives the same result."""
    z, w, g, b, ident = _maa(257, 64, 48, torch.bfloat16, seed=3)
    zbig = torch.empty(257 * 64 + 1, dtype=z.dtype, device="cuda")
    zv = zbig[1:].view(257, 64)
    zv.copy_(z)
    got = fused_conv.matmul_affine_act(zv, w, g, b, ident)
    torch.testing.assert_close(got, fused_conv.matmul_affine_act(z, w, g, b, ident), atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("l", [1, 50, 77, 200])
def test_flash_attention_kernel_matches_plain(cuda, dt, l):
    gen = torch.Generator().manual_seed(l)
    q, k, v = (torch.randn(2, 3, l, 64, generator=gen).to(dt).cuda() for _ in range(3))
    before = flash_attention.launches
    for causal in (False, True):
        got = flash_attention.flash_attention(q, k, v, causal=causal)
        ref = flash_attention.flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dt], rtol=TOL[dt])
    assert flash_attention.launches == before + 2


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 2, 8, 48, device="cuda")  # head dim 48 has no kernel
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention(q, q, q)
    z = torch.randn(8, 8, device="cuda").t()  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.matmul_affine_act(z, torch.randn(8, 8, device="cuda"), torch.ones(8, device="cuda"),
                                     torch.zeros(8, device="cuda"))


@pytest.mark.gpu
def test_tiny_model_card_matches_cpu(cuda, monkeypatch):
    """A seeded tiny RN CLIP (random BatchNorm statistics) in fp32 on the
    card against the same model on the CPU: unit-norm features, atol 1e-4."""
    from xclip_tpu_torch.models import factory
    from xclip_tpu_torch.tokenizer import tokenize

    tiny = {"embed_dim": 32,
            "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
            "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2}}
    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRNgpu", tiny)
    cpu = factory.create_model("TinyRNgpu", device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    sd = cpu.state_dict()
    for key, val in sd.items():
        if key.endswith(("running_var",)) or (".bn" in key and key.endswith("weight")):
            sd[key] = torch.rand(val.shape, generator=gen) + 0.5
        elif key.endswith("running_mean"):
            sd[key] = torch.randn(val.shape, generator=gen) * 0.1
    cpu.load_state_dict(sd)
    gpu = factory.create_model("TinyRNgpu", device="cuda", seed=0)
    gpu.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 64, 64, 3).astype(np.float32))
    ids = torch.from_numpy(tokenize(["a photo of a cat.", "a sketch of a barn."]))
    with torch.inference_mode():
        torch.testing.assert_close(gpu.encode_image(x.cuda(), normalize=True).cpu(),
                                   cpu.encode_image(x, normalize=True), atol=1e-4, rtol=0)
        torch.testing.assert_close(gpu.encode_text(ids.cuda(), normalize=True).cpu(),
                                   cpu.encode_text(ids, normalize=True), atol=1e-4, rtol=0)
        feats = gpu.encode_image(x.cuda(), normalize=True, dtype=torch.bfloat16)
    assert torch.isfinite(feats).all()


# --- training slice: K3 and the backward passes -----------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,c", [(7, 36, 20), (129, 8, 8), (12250, 64, 40), (1000, 72, 200)])
def test_matmul_stats_kernel_matches_plain(cuda, dt, m, k, c):
    """K3 at ragged and unaligned M and C: y within one rounding of the IO
    type (TOL), the fp32 column sums within 1e-4 of their scale (the sums
    run over the fp32 accumulator on both sides and differ in order only),
    and bit-identical from run to run (no atomics)."""
    z, w, _, _, _ = _maa(m, k, c, dt, seed=m + c)
    before = fused_conv.stats_launches
    y, s1, s2 = fused_conv.matmul_stats(z, w)
    ry, r1, r2 = fused_conv.matmul_stats_plain(z, w)
    assert y.dtype == dt and s1.dtype == s2.dtype == torch.float32 and fused_conv.stats_launches == before + 1
    torch.testing.assert_close(y.float(), ry.float(), atol=TOL[dt], rtol=TOL[dt])
    for got, ref in ((s1, r1), (s2, r2)):
        torch.testing.assert_close(got, ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)
    y2, s1b, s2b = fused_conv.matmul_stats(z, w)
    assert torch.equal(y, y2) and torch.equal(s1, s1b) and torch.equal(s2, s2b)


def _grad_check(fn, ref_fn, inputs, dt):
    """Grads of ``fn`` (the Function) and of ``ref_fn`` (the plain version
    under autograd) for one random cotangent per output: ||a - b|| within
    TOL of ||b|| for each input (a norm: K2's relu mask comes from the
    kernel's rounded output and may differ from the plain mask at
    pre-activations within rounding of 0)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    b = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    outs, refs = fn(*a), ref_fn(*b)
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    cts = [torch.randn(o.shape, device="cuda", generator=gen) for o in outs]
    sum((o.float() * ct).sum() for o, ct in zip(outs, cts)).backward()
    sum((r.float() * ct).sum() for r, ct in zip(refs, cts)).backward()
    for x, y in zip(a, b):
        if x.grad is None:
            continue
        err = float((x.grad.float() - y.grad.float()).norm()) / float(y.grad.float().norm())
        assert err <= TOL[dt], err


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_identity", [False, True])
def test_matmul_affine_act_backward_on_card(cuda, dt, with_identity):
    z, w, g, b, ident = _maa(1000, 72, 200, dt, seed=5)
    before = fused_conv.affine_act_backward_calls
    if with_identity:
        _grad_check(lambda *t: fused_conv.MatmulAffineAct.apply(*t, True),
                    lambda *t: fused_conv.matmul_affine_act_plain(*t, relu=True), [z, w, g, b, ident], dt)
    else:
        _grad_check(lambda *t: fused_conv.MatmulAffineAct.apply(*t, None, False),
                    lambda *t: fused_conv.matmul_affine_act_plain(*t, relu=False), [z, w, g, b], dt)
    assert fused_conv.affine_act_backward_calls == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_matmul_stats_backward_on_card(cuda, dt):
    z, w, _, _, _ = _maa(1000, 72, 200, dt, seed=6)
    before = fused_conv.stats_backward_calls
    _grad_check(fused_conv.MatmulStats.apply, fused_conv.matmul_stats_plain, [z, w], dt)
    assert fused_conv.stats_backward_calls == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_on_card(cuda, dt):
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(4, 8, 77, 64, generator=gen).to(dt).cuda() for _ in range(3))
    before = flash_attention.backward_calls
    _grad_check(lambda *t: flash_attention.FlashAttention.apply(*t, True),
                lambda *t: flash_attention.flash_attention_plain(*t, causal=True), [q, k, v], dt)
    assert flash_attention.backward_calls == before + 1


@pytest.mark.gpu
def test_tiny_train_step_card_matches_cpu(cuda, monkeypatch):
    """One fp32 train step (accum 2, grad checkpointing) of a seeded tiny RN
    CLIP on the card and on the CPU: loss rtol 1e-4, every grad within 1e-3
    of its largest element (fp32 summation order on two devices)."""
    from xclip_tpu_torch.models import factory
    from xclip_tpu_torch.train import optim, schedule
    from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

    tiny = {"embed_dim": 32,
            "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
            "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2}}
    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRNgpuTrain", tiny)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (16, 64, 64, 3)).astype(np.uint8))
    texts = torch.from_numpy(rng.randint(1, 49407, (16, 77)).astype(np.int32))
    results = []
    for device in ("cpu", "cuda"):
        model = factory.create_model("TinyRNgpuTrain", device=device, seed=0).train()
        opt = optim.adamw(model, lr=1e-4)
        step = make_train_step(model, opt, schedule.const_lr(1e-4, 1),
                               TrainStepCfg(precision="fp32", accum_freq=2, grad_checkpointing=True))
        m = step(images.to(device), texts.to(device), 0)
        results.append((float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-4)
    for name, ref in g_cpu.items():
        torch.testing.assert_close(g_gpu[name], ref, atol=1e-3 * float(ref.abs().max()) + 1e-7, rtol=0)
