"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions (the CUDA kernels
need the card), so these tests hold the plain versions, which the card
tests compare the kernels with, against ``xclip_tpu.ops`` run in Pallas
interpret mode. Inputs come from numpy with a fixed seed. Tolerances are
fp32's: both sides compute in fp32 on the CPU and differ only in
summation order.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.ops import fused_conv as jax_fused_conv
from xclip_tpu.ops import flash_attention as jax_flash
from xclip_tpu_torch.ops import _build, fused_conv, flash_attention


def _maa_inputs(m, k, c, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, c) / np.sqrt(k)).astype(np.float32)
    g = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    ident = rng.randn(m, c).astype(np.float32)
    return z, w, g, b, ident


@pytest.mark.parametrize("m", [128, 1000])
@pytest.mark.parametrize("k,c", [(36, 20), (64, 48)])
@pytest.mark.parametrize("with_identity", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_affine_act_matches_pallas(m, k, c, with_identity, relu):
    """K1/K2 plain vs the Pallas kernel (interpret mode on the CPU); K and C
    are not multiples of 16. fp32 on both sides: atol = rtol = 1e-5."""
    z, w, g, b, ident = _maa_inputs(m, k, c)
    want = jax_fused_conv.matmul_affine_act(
        jnp.asarray(z), jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(ident) if with_identity else None, relu=relu)
    got = fused_conv.matmul_affine_act(
        torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(ident) if with_identity else None, relu=relu)
    assert got.dtype == torch.float32 and got.shape == (m, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_identity", [False, True])
def test_matmul_affine_act_ragged_m(with_identity):
    """M = 250*7*7 = 12,250 (RN50 layer 4 at the eval batch of 250), which
    the Pallas tiling refuses (12,250 % 8 == 2), held against z@w*g+b in
    float64 instead. fp32 vs float64 over K=96: atol = rtol = 1e-5."""
    m, k, c = 12250, 96, 40
    z, w, g, b, ident = _maa_inputs(m, k, c, seed=1)
    ref = (z.astype(np.float64) @ w.astype(np.float64)) * g + b
    if with_identity:
        ref = ref + ident
    ref = np.maximum(ref, 0.0)
    got = fused_conv.matmul_affine_act(
        torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(ident) if with_identity else None, relu=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_pallas_tiling_refuses_ragged_m():
    """The reason the ragged-M case is held against plain math: the JAX
    tiling raises on M % 8 != 0 (fused_conv.py:42-52)."""
    with pytest.raises(ValueError, match="divisible by 8"):
        jax_fused_conv._pick_tile_m(12250)


def test_matmul_affine_act_dtypes_cpu():
    """bf16/fp16 IO keeps the dtype; fp32 epilogue then one cast, so the
    result equals the fp32 plain result rounded once."""
    z, w, g, b, ident = _maa_inputs(64, 32, 24, seed=2)
    for dt in (torch.bfloat16, torch.float16):
        zt, wt, it = (torch.from_numpy(a).to(dt) for a in (z, w, ident))
        got = fused_conv.matmul_affine_act(zt, wt, torch.from_numpy(g), torch.from_numpy(b), it)
        ref = fused_conv.matmul_affine_act_plain(zt.float(), wt.float(), torch.from_numpy(g),
                                                 torch.from_numpy(b), it.float()).to(dt)
        assert got.dtype == dt
        assert torch.equal(got, ref)


def _qkv(b, h, l, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, l, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("l", [50, 77, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_pallas(l, causal):
    """K4 plain vs the Pallas kernel in interpret mode, as tests/test_ops.py
    runs it: fp32, atol 2e-5, rtol 1e-4."""
    q, k, v = _qkv(2, 4, l, 32)
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, interpret=True, block_q=64, block_k=64)
    got = flash_attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_flash_mha_matches_pallas():
    """(B, L, D) convenience form, causal, text-tower head dim 64."""
    rng = np.random.RandomState(3)
    q, k, v = [rng.randn(2, 77, 128).astype(np.float32) for _ in range(3)]
    want = jax_flash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=2,
                               causal=True, interpret=True)
    got = flash_attention.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    num_heads=2, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_wrappers_raise_off_cpu_and_never_fall_back():
    """A tensor that is neither on the CPU nor usable by the CUDA kernel
    raises; the wrappers have no fallback to the plain version."""
    z, w, g, b, _ = (torch.from_numpy(a).to("meta") for a in _maa_inputs(16, 8, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_conv.matmul_affine_act(z, w, g, b)
    q = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention.flash_attention(q, q, q)
    before = (fused_conv.launches, flash_attention.launches)
    fused_conv.matmul_affine_act(*(torch.ones(8, 8) for _ in range(2)), torch.ones(8), torch.ones(8))
    assert (fused_conv.launches, flash_attention.launches) == before  # CPU path launches nothing


@pytest.mark.parametrize("op", ["matmul_affine_act", "flash_attention"])
def test_wrappers_on_cuda_tensors_without_a_card_raise(monkeypatch, tmp_path, op):
    """CUDA tensors (fake ones, so the test runs without a card) go to the
    kernel path, which raises because the kernels cannot be built without
    nvcc; the plain version is never taken."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fused_conv, "matmul_affine_act_plain", no_plain)
    monkeypatch.setattr(flash_attention, "flash_attention_plain", no_plain)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with FakeTensorMode():
        if op == "matmul_affine_act":
            z, w = torch.empty(16, 8, device="cuda"), torch.empty(8, 8, device="cuda")
            g, b = torch.empty(8, device="cuda"), torch.empty(8, device="cuda")
            assert z.is_cuda
            with pytest.raises(RuntimeError, match="nvcc not found"):
                fused_conv.matmul_affine_act(z, w, g, b)
        else:
            q = torch.empty(1, 2, 8, 64, device="cuda")
            with pytest.raises(RuntimeError, match="nvcc not found"):
                flash_attention.flash_attention(q, q, q, causal=True)


def test_wrappers_validate_inputs():
    z = torch.ones(16, 8)
    with pytest.raises(ValueError):
        fused_conv.matmul_affine_act(z, torch.ones(4, 8), torch.ones(8), torch.ones(8))
    with pytest.raises(TypeError):
        fused_conv.matmul_affine_act(z.double(), torch.ones(8, 8).double(), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError, match="identity"):
        fused_conv.matmul_affine_act(z, torch.ones(8, 8), torch.ones(8), torch.ones(8),
                                     identity=torch.ones(16, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(torch.ones(1, 2, 8, 4), torch.ones(1, 2, 9, 4), torch.ones(1, 2, 8, 4))


def test_build_without_nvcc_names_the_command(monkeypatch, tmp_path):
    """With no nvcc the build raises and shows the command it tried."""
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"nvcc.*-gencode arch=compute_90a,code=sm_90a"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_hash_covers_sources():
    digest = _build.source_hash()
    assert len(digest) == 64 and digest == _build.source_hash()
    names = {p.name for p in _build._sources()}
    assert {"fused_conv.cu", "flash_attention.cu"} <= names


def test_build_hash_follows_shared_headers(monkeypatch, tmp_path):
    """Editing a shared header (every kernel includes common.cuh or ptx.cuh)
    changes the hash, so the library is rebuilt."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.source_hash()
    assert {"common.cuh", "ptx.cuh"} <= {p.name for p in csrc.glob("*.cuh")}
    (csrc / "ptx.cuh").write_text((csrc / "ptx.cuh").read_text() + "// edited\n")
    assert _build.source_hash() != before


# --- K3 matmul_stats and the autograd Functions (training slice) -----------

import jax  # noqa: E402

from xclip_tpu.models import layers as jax_layers  # noqa: E402


@pytest.mark.parametrize("m", [128, 1000])
@pytest.mark.parametrize("k,c", [(36, 20), (64, 48)])
def test_matmul_stats_matches_pallas(m, k, c):
    """K3 plain vs the Pallas kernel in interpret mode, fp32 on both sides:
    y atol = rtol = 1e-5; the column sums over up to 1,000 rows of O(1)
    values differ by summation order only: rtol 1e-5, atol 1e-3."""
    z, w, _, _, _ = _maa_inputs(m, k, c, seed=4)
    wy, ws1, ws2 = jax_fused_conv.matmul_stats(jnp.asarray(z), jnp.asarray(w))
    y, s1, s2 = fused_conv.matmul_stats(torch.from_numpy(z), torch.from_numpy(w))
    assert y.dtype == torch.float32 and s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(ws1), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(ws2), atol=1e-3, rtol=1e-5)


def test_matmul_stats_ragged_m_and_dtypes():
    """M = 12,250 (the Pallas tiling refuses it) against float64 sums
    (rtol 1e-5); in bf16 the sums are those of the fp32 product, not of the
    rounded y, and y is that product rounded once."""
    z, w, _, _, _ = _maa_inputs(12250, 48, 24, seed=5)
    y64 = z.astype(np.float64) @ w.astype(np.float64)
    y, s1, s2 = fused_conv.matmul_stats(torch.from_numpy(z), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), y64, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s1.numpy(), y64.sum(0), atol=1e-2, rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), (y64 * y64).sum(0), rtol=1e-5)
    zb, wb = torch.from_numpy(z).bfloat16(), torch.from_numpy(w).bfloat16()
    yb, s1b, s2b = fused_conv.matmul_stats(zb, wb)
    y32 = zb.float() @ wb.float()
    assert yb.dtype == torch.bfloat16 and torch.equal(yb, y32.bfloat16())
    assert torch.equal(s1b, y32.sum(0)) and torch.equal(s2b, (y32 * y32).sum(0))


def _grads_close(got, want, atol, rtol=1e-5):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=rtol, err_msg=f"arg {i}")


@pytest.mark.parametrize("with_identity", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_affine_act_grads_match_jax(with_identity, relu):
    """Grads of MatmulAffineAct vs jax.grad of the custom-VJP
    ``matmul_affine_act`` (Pallas interpret forward) for a random cotangent,
    fp32: atol 1e-4 (dw/dg sum 256 rows), rtol 1e-5."""
    m, k, c = 256, 40, 24
    z, w, g, b, ident = _maa_inputs(m, k, c, seed=6)
    ct = np.random.RandomState(7).randn(m, c).astype(np.float32)
    args = [z, w, g, b] + ([ident] if with_identity else [])

    def jax_loss(*a):
        ident_arg = a[4] if with_identity else None
        out = jax_fused_conv.matmul_affine_act(a[0], a[1], a[2], a[3], ident_arg, relu=relu)
        return jnp.sum(out * ct)

    want = jax.grad(jax_loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    before = fused_conv.affine_act_backward_calls
    out = fused_conv.MatmulAffineAct.apply(ts[0], ts[1], ts[2], ts[3], ts[4] if with_identity else None, relu)
    (out * torch.from_numpy(ct)).sum().backward()
    assert fused_conv.affine_act_backward_calls == before + 1
    _grads_close([t.grad for t in ts], want, atol=1e-4)


def test_matmul_stats_grads_match_jax():
    """Grads of MatmulStats (y, s1 and s2 all in the loss) vs jax.grad of the
    custom-VJP ``matmul_stats``, fp32: atol 1e-3 (the s2 term scales with
    2 y over 256 rows), rtol 1e-5."""
    m, k, c = 256, 40, 24
    z, w, _, _, _ = _maa_inputs(m, k, c, seed=8)
    rng = np.random.RandomState(9)
    cy, c1, c2 = rng.randn(m, c).astype(np.float32), rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)

    def jax_loss(z_, w_):
        y, s1, s2 = jax_fused_conv.matmul_stats(z_, w_)
        return jnp.sum(y * cy) + jnp.sum(s1 * c1) + 1e-2 * jnp.sum(s2 * c2)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(w))
    zt, wt = torch.from_numpy(z).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = fused_conv.stats_backward_calls
    y, s1, s2 = fused_conv.MatmulStats.apply(zt, wt)
    ((y * torch.from_numpy(cy)).sum() + (s1 * torch.from_numpy(c1)).sum()
     + 1e-2 * (s2 * torch.from_numpy(c2)).sum()).backward()
    assert fused_conv.stats_backward_calls == before + 1
    _grads_close([zt.grad, wt.grad], want, atol=1e-3)


@pytest.mark.parametrize("l", [16, 77])
def test_flash_attention_grads_match_jax_and_plain(l):
    """FlashAttention's backward vs jax.grad of ``layers.attention`` with the
    additive causal mask (the JAX text tower's path) and vs autograd of
    ``flash_attention_plain``, fp32: atol 2e-5, rtol 1e-4."""
    b, h, hd = 2, 2, 32
    rng = np.random.RandomState(l)
    q, k, v = (rng.randn(b, l, h * hd).astype(np.float32) for _ in range(3))
    ct = rng.randn(b, l, h * hd).astype(np.float32)
    mask = jax_layers.causal_mask(l)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_layers.attention(q_, k_, v_, num_heads=h, mask=mask) * ct)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def heads(x):  # (B, L, D) -> contiguous (B, H, L, hd)
        return x.view(b, l, h, hd).transpose(1, 2).contiguous()

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = flash_attention.backward_calls
    out = flash_attention.FlashAttention.apply(*map(heads, ts), True)
    (out.transpose(1, 2).reshape(b, l, h * hd) * torch.from_numpy(ct)).sum().backward()
    assert flash_attention.backward_calls == before + 1
    _grads_close([t.grad for t in ts], want, atol=2e-5, rtol=1e-4)

    ps = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = flash_attention.flash_attention_plain(*map(heads, ps), causal=True)
    (ref.transpose(1, 2).reshape(b, l, h * hd) * torch.from_numpy(ct)).sum().backward()
    _grads_close([t.grad for t in ts], [p.grad.numpy() for p in ps], atol=2e-5, rtol=1e-4)


def test_matmul_stats_on_cuda_tensors_without_a_card_raises(monkeypatch, tmp_path):
    """Like the other wrappers: CUDA tensors go to the kernel path (which
    cannot build here), never to the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fused_conv, "matmul_stats_plain", no_plain)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with FakeTensorMode():
        z, w = torch.empty(16, 8, device="cuda"), torch.empty(8, 8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fused_conv.matmul_stats(z, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_conv.matmul_stats(torch.ones(8, 8, device="meta"), torch.ones(8, 8, device="meta"))


# --- K5 stream_scale (the bandwidth probe's kernel) -------------------------

from jax.experimental import pallas as pl  # noqa: E402

from xclip_tpu_torch.ops import stream_scale  # noqa: E402
from xclip_tpu_torch.tools import probe_bandwidth  # noqa: E402


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jax_bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def test_stream_scale_plain_matches_jax_and_pallas_bit_for_bit():
    """The plain version equals ``x * jnp.bfloat16(1.0001)`` and the probe's
    Pallas kernel (the same call, interpret mode, (256, 256) in 128-row
    blocks), bit for bit; bf16(1.0001) is 1.0, so all three equal x."""
    n, block = 256, 128
    x32 = np.random.RandomState(0).rand(n, n).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * jnp.bfloat16(1.0001)

    pallas_scale = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.bfloat16),
        grid=(n // block,),
        in_specs=[pl.BlockSpec((block, n), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block, n), lambda i: (i, 0)),
        interpret=True,
    )
    x = torch.from_numpy(x32).to(torch.bfloat16)
    got = stream_scale.stream_scale(x)
    assert got.dtype == torch.bfloat16 and got.shape == (n, n)
    np.testing.assert_array_equal(_bf16_bits(got), _jax_bf16_bits(xj * jnp.bfloat16(1.0001)))
    np.testing.assert_array_equal(_bf16_bits(got), _jax_bf16_bits(pallas_scale(xj)))
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(x))
    assert float(jnp.bfloat16(1.0001)) == 1.0


@pytest.mark.parametrize("scale", [0.3, 1.5, -2.7183])
def test_stream_scale_plain_rounds_as_jax(scale):
    """Scales that do round: fp32 product, round to nearest even, as JAX's
    bf16 multiply on the CPU."""
    x32 = (np.random.RandomState(1).randn(1000, 3) * 50).astype(np.float32)
    got = stream_scale.stream_scale_plain(torch.from_numpy(x32).to(torch.bfloat16), scale)
    want = jnp.asarray(x32).astype(jnp.bfloat16) * jnp.bfloat16(scale)
    np.testing.assert_array_equal(_bf16_bits(got), _jax_bf16_bits(want))
    ref = (torch.from_numpy(x32).to(torch.bfloat16).double() * float(jnp.bfloat16(scale))).to(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(ref))


def test_stream_scale_validates_and_never_falls_back(monkeypatch, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with pytest.raises(TypeError, match="bfloat16"):
        stream_scale.stream_scale(torch.ones(4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        stream_scale.stream_scale(torch.ones(4, 4, dtype=torch.bfloat16).t())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stream_scale.stream_scale(torch.ones(4, 4, dtype=torch.bfloat16, device="meta"))
    before = stream_scale.launches
    stream_scale.stream_scale(torch.ones(4, 4, dtype=torch.bfloat16))
    assert stream_scale.launches == before  # the CPU path launches nothing

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(stream_scale, "stream_scale_plain", no_plain)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with FakeTensorMode():
        x = torch.empty(64, 8, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            stream_scale.stream_scale(x, nan_fill_output=True)
    assert "stream_scale.cu" in {p.name for p in _build._sources()}


@pytest.mark.parametrize("chain", [0, 3])
def test_probe_bandwidth_runs_on_the_cpu(chain, capsys, monkeypatch):
    """The probe's entry point at a small side on the CPU: the plain
    version on both sides, the JAX probe's three result lines."""
    monkeypatch.setattr(probe_bandwidth, "SIDE", 64)
    argv = ["--device", "cpu"] + (["--chain", str(chain)] if chain else [])
    before = stream_scale.launches
    res = probe_bandwidth.main(argv)
    out = capsys.readouterr().out.splitlines()
    prefix = f"chain={chain} " if chain else ""
    assert out[0] == "device: cpu"
    assert out[1].startswith(f"{prefix}torch_stream_gbps: ") and out[2].startswith(f"{prefix}kernel_stream_gbps: ")
    assert out[3].startswith("ratio: ")
    assert res["bytes_per_pass"] == 2 * 64 * 64 * 2 and res["chain"] == chain
    assert res["torch_ms"] > 0 and res["kernel_ms"] > 0 and np.isfinite(res["ratio"])
    assert stream_scale.launches == before
    with pytest.raises(SystemExit):
        probe_bandwidth.main(["--device", "cpu", "--chain", "-1"])


def test_probe_bandwidth_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_bandwidth.main([])


def test_stream_scale_edge_lengths():
    """K5's edge cases sit on the kernel's row, block and wave boundaries,
    with tails of 1 to 7 elements: at the shipped kernel's geometry on an
    H100 (512 threads x 4 loads, 3 blocks per SM, 132 SMs) and at another."""
    for threads, vecs, per_sm, sms in ((512, 4, 3, 132), (256, 2, 4, 7)):
        row, block = threads * 8, threads * 8 * vecs
        wave = sms * per_sm * block
        lengths = stream_scale.edge_lengths(threads, vecs, per_sm, sms)
        assert tuple(lengths) == stream_scale.EDGE_CASES
        assert lengths == {"below_one_block": block - 8, "below_one_block_ragged": block - 3, "one_block": block,
                           "one_block_plus_1": block + 1, "one_block_and_a_row_plus_3": block + row + 3,
                           "wave_plus_1": wave + 1, "wave_plus_7": wave + 7, "wave_plus_8": wave + 8,
                           "two_waves_plus_13": 2 * wave + 13}
    assert stream_scale.edge_lengths(512, 4, 3, 132)["wave_plus_8"] == 6_488_072
