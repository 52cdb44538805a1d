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

from xclip_tpu_torch.ops import flash_attention, fused_conv, stream_scale

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


# ragged against the kernels' tiles: M against 128-row blocks, C against
# 64- and 128-channel blocks, K against the 16- and 64-deep slabs, and K = 1,
# 3, 17, whose rows are not whole 16-byte vectors (the scalar load path).
# The 16-bit ring of 3 slabs: K = 64 is one slab (shorter than the ring),
# 2048 is 32 slabs and wraps it 10 times, 72 and 328 end in a ragged slab
# on the vector path; M one below and one above 10 tiles, and the eval's
# M = 12,250; C = 64, 192 and 200 (ragged 128-channel tiles) and 2048. The
# 16-bit tiles are 128 channels wide for K > 256 and C > 128 (1281 x 2048
# x 192, 1279 x 328 x 200, and 257 x 300 x 130 on the scalar path), else 64.
MKC = [(1000, 72, 200), (12250, 64, 40), (7, 36, 20), (129, 8, 8),
       (131, 1, 65), (300, 3, 130), (257, 17, 63), (515, 130, 129),
       (1279, 64, 64), (1281, 2048, 192), (12250, 72, 2048), (1281, 64, 2048),
       (1279, 328, 200), (257, 300, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,c", MKC)
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


def _unaligned(t):
    """A contiguous copy of ``t`` starting one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_matmul_affine_act_unaligned_views(cuda, dt):
    """Contiguous views of z, w and identity starting off a 16-byte boundary
    take the scalar load path instead of cp.async/vectors and give the same
    bits, in K1/K2 and in K3 (K and C are whole vectors, so alignment is the
    only difference), at both 16-bit tile widths (64 and 128 channels)."""
    for m, k, c in ((257, 64, 48), (300, 320, 136)):
        z, w, g, b, ident = _maa(m, k, c, dt, seed=3)
        zu, wu, iu = _unaligned(z), _unaligned(w), _unaligned(ident)
        for identity, identity_u in ((None, None), (ident, iu)):
            got = fused_conv.matmul_affine_act(zu, wu, g, b, identity_u)
            torch.testing.assert_close(got, fused_conv.matmul_affine_act(z, w, g, b, identity), atol=0, rtol=0)
            ref = fused_conv.matmul_affine_act_plain(z, w, g, b, identity)
            torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dt], rtol=TOL[dt])
        for got, want in zip(fused_conv.matmul_stats(zu, wu), fused_conv.matmul_stats(z, w)):
            torch.testing.assert_close(got, want, atol=0, rtol=0)


# every slab count and tail of the 16-row query slabs and 64-key stages:
# one key, a slab +-1, a stage +-1, the text tower's 77 and its 80 padded
# rows, two stages +1, ViT-B/16's 197 + 3 and ViT-L/14's 257 (three blocks)
FLASH_LENGTHS = [1, 15, 16, 17, 50, 63, 64, 65, 77, 80, 129, 200, 257]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("l", FLASH_LENGTHS)
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_unaligned_views(cuda, dt):
    """q, k, v off a 16-byte boundary take scalar loads and stores: the
    same bits as aligned inputs."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(3, 2, 77, 64, generator=gen).to(dt).cuda() for _ in range(3))
    for causal in (False, True):
        got = flash_attention.flash_attention(_unaligned(q), _unaligned(k), _unaligned(v), causal=causal)
        want = flash_attention.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


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
@pytest.mark.parametrize("m,k,c", MKC)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_matmul_stats_same_bits_across_launches(cuda, dt):
    """K3 at a training shape of 196 row tiles x 2 column tiles: y and both
    column sums keep their bits over launches, with another launch of a
    different shape (other blocks, other partials) in between."""
    z, w, _, _, _ = _maa(25088, 1024, 256, dt, seed=11)
    first = fused_conv.matmul_stats(z, w)
    other = fused_conv.matmul_stats(*_maa(6272, 2048, 512, dt, seed=12)[:2])
    again = fused_conv.matmul_stats(z, w)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert all(torch.isfinite(t.float()).all() for t in (*first, *other))


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


# --- K5 stream_scale and the SAE step ----------------------------------------

def _bits(t):
    return t.view(torch.int16)


def _check_stream_scale(x, scale=stream_scale.PROBE_SCALE):
    """Kernel vs plain, bit for bit, into a fresh NaN-filled buffer."""
    before = stream_scale.launches
    got = stream_scale.stream_scale(x, scale, nan_fill_output=True)
    ref = stream_scale.stream_scale_plain(x, scale)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.bfloat16 and got.shape == x.shape
    assert got.numel() == 0 or got.data_ptr() != x.data_ptr()
    assert torch.equal(_bits(got), _bits(ref))
    assert stream_scale.launches == before + (x.numel() > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (8,), (9,), (1000, 1003), (257, 4097), (8192, 8192)])
@pytest.mark.parametrize("scale", [stream_scale.PROBE_SCALE, 1.5, -0.3])
def test_stream_scale_kernel_matches_plain(cuda, shape, scale):
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=gen) * 30).to(torch.bfloat16)
    _check_stream_scale(x, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3, 7, 8])
def test_stream_scale_misaligned_views(cuda, offset):
    """Contiguous views that start 2, 6, 14 and 16 bytes into a buffer: the
    first three take the scalar loop, all give the plain version's bits."""
    gen = torch.Generator(device="cuda").manual_seed(offset)
    base = torch.randn(offset + 1000 * 37, device="cuda", generator=gen).to(torch.bfloat16)
    x = base[offset:].view(1000, 37)
    assert x.is_contiguous()
    _check_stream_scale(x, 1.5)


@pytest.mark.gpu
def test_stream_scale_writes_every_element_of_a_fresh_buffer(cuda):
    """At the probe's scale the right output is the input itself: the output
    is a new buffer, NaN before the launch, equal to x after it."""
    x = torch.rand(8192, 8192, device="cuda").to(torch.bfloat16)
    out = stream_scale.stream_scale(x, nan_fill_output=True)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr() and not torch.isnan(out).any()
    assert torch.equal(_bits(out), _bits(x))
    with pytest.raises(TypeError):
        stream_scale.stream_scale(x.float())


def _edge(case):
    return stream_scale.edge_lengths(**stream_scale.geometry())[case]


@pytest.mark.gpu
@pytest.mark.parametrize("case", stream_scale.EDGE_CASES)
def test_stream_scale_edges(cuda, case):
    """Lengths on the kernel's block and wave boundaries (its geometry
    asked of the kernel's library): a block's last threads with some of their
    vectors past the end, tails of 1 to 7 elements, whole blocks."""
    n = _edge(case)
    gen = torch.Generator(device="cuda").manual_seed(n)
    _check_stream_scale((torch.randn(n, device="cuda", generator=gen) * 30).to(torch.bfloat16), 1.5)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3, 7, 8, 16])
def test_stream_scale_offset_views_across_a_wave(cuda, offset):
    """Views 2, 6, 14, 16 and 32 bytes into a buffer, a wave plus 8 elements
    long: offsets 8 and 16 stay on 16-byte boundaries and take the vector
    kernel, the others the scalar loop."""
    n = _edge("wave_plus_8")
    gen = torch.Generator(device="cuda").manual_seed(offset)
    base = torch.randn(offset + n, device="cuda", generator=gen).to(torch.bfloat16)
    _check_stream_scale(base[offset:], -0.3)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [stream_scale.PROBE_SCALE, 1.5, -0.3, 2.0 ** -126, 3.0e38])
@pytest.mark.parametrize("across_a_wave", [False, True])
def test_stream_scale_every_bf16_bit_pattern(cuda, scale, across_a_wave):
    """All 65,536 bf16 bit patterns as input (NaNs, +-Inf, +-0, subnormals,
    the largest finite values): products that overflow, underflow to
    subnormals or flush to 0 round as torch.mul's do. Tiled across a wave
    plus 7 elements, every block sees them."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).cuda()
    if across_a_wave:
        n = _edge("wave_plus_7")
        x = x.repeat(-(-n // x.numel()))[:n]
    _check_stream_scale(x, scale)


@pytest.mark.gpu
def test_stream_scale_back_to_back_launches_agree(cuda):
    """Three launches on one stream into fresh buffers, each counted once,
    give the same bits."""
    n = _edge("two_waves_plus_13")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(n, device="cuda", generator=gen) * 30).to(torch.bfloat16)
    before = stream_scale.launches
    outs = [stream_scale.stream_scale(x, 1.5, nan_fill_output=True) for _ in range(3)]
    ref = stream_scale.stream_scale_plain(x, 1.5)
    torch.cuda.synchronize()
    assert stream_scale.launches == before + 3
    assert len({o.data_ptr() for o in outs}) == 3
    for out in outs:
        assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.gpu
def test_sae_step_card_matches_cpu(cuda):
    """One fp32 SAE step (components layout, d=64, m=256, batch 512) on the
    card and on the CPU from the same parameters and batch: loss rtol 1e-5,
    parameters within 1e-4 of each tensor's largest magnitude."""
    from xclip_tpu_torch.sae import losses, model, optim, pipeline

    params = model.sae_init(torch.Generator().manual_seed(0), model.SAECfg(64, 256, 1))
    x = torch.from_numpy(np.random.RandomState(0).randn(512, 1, 64).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        p = model.tree_map(lambda t: t.to(device), params)
        adam = optim.adam(1e-3)
        new, metrics, fired = pipeline.train_step(p, adam, adam.init(p), losses.SAELossCfg(3e-4), x.to(device))
        out[device] = (float(metrics["total_loss"]), model.sae_params_to_numpy(new), fired.cpu())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, b in zip(model.tree_leaves(out["cuda"][1]), model.tree_leaves(out["cpu"][1])):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert (out["cuda"][2] - out["cpu"][2]).abs().max() <= 2  # a pre-activation within rounding of 0
