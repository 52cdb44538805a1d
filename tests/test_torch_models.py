"""The port's towers and CLIP bundle against the JAX package.

The JAX model is initialised from a seed, its BatchNorm statistics and
scales are set to random values (so the folded eval BatchNorm is
exercised), and its weights are carried into the port with
``core.checkpoint.state_dict_from_jax_params`` or through an open_clip
``.pt``. Both sides then see the same numpy inputs. On the CPU the port's
kernel wrappers take their plain versions; everything computes in fp32, so
the tolerance (atol 1e-4) only covers summation order through a few
layers.
"""

import ctypes
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xclip_tpu.core.checkpoint import pytrees_to_open_clip_state_dict, save_open_clip_checkpoint
from xclip_tpu.models import resnet as R
from xclip_tpu.models import transformer as T
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.models.clip import clip_cfg_from_dict as jax_clip_cfg_from_dict
from xclip_tpu.tokenizer import tokenize as jax_tokenize
from xclip_tpu_torch.core.checkpoint import (
    bottleneck_state_dict,
    load_open_clip_checkpoint,
    state_dict_from_jax_params,
)
from xclip_tpu_torch.core.precision import get_policy
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.models.clip import CLIP, clip_cfg_from_dict
from xclip_tpu_torch.models.resnet import Bottleneck
from xclip_tpu_torch.tokenizer import SimpleTokenizer, get_tokenizer, tokenize

@pytest.fixture(scope="module", autouse=True)
def release_memory_after_module():
    """After each port test module, hand JAX's compilation caches and the
    freed heap back to the system: under xdist the JAX CLI tests that follow
    these files in collection order need up to ~13 GB each, and a worker
    keeps whatever its earlier files left resident (about 0.5 GB less per
    module with this)."""
    yield
    jax.clear_caches()
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc only
    if trim is not None:
        trim(0)


TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 32, "heads": 4, "layers": 2},
}
ATOL = 1e-4

TOKENIZER_TEXTS = [
    "a photo of a cat.",
    "hello world",
    "A CLIPART of the Aircraft-Carrier!",
    "çafé über naïve",
    "x" * 500,
    "",
    "a quickdraw of a The Great Wall of China.",
    "don't stop; it's 99.9% fine &amp; dandy",
    "An    oddly \t spaced\n sentence",
]


def _randomize_bn(params, state, rng):
    """Random BN affine and running stats on every BatchNorm, in place."""
    def walk(p, s):
        if isinstance(p, list):
            for pi, si in zip(p, s):
                walk(pi, si)
            return
        for key, sub in p.items():
            if not isinstance(sub, dict) and not isinstance(sub, list):
                continue
            if isinstance(sub, dict) and set(sub) == {"scale", "bias"} and key.startswith("bn") or key == "bn":
                n = sub["scale"].shape[0]
                sub["scale"] = (rng.rand(n) + 0.5).astype(np.float32)
                sub["bias"] = (rng.randn(n) * 0.1).astype(np.float32)
                skey = "downsample_bn" if key == "bn" else key
                s[skey] = {"mean": (rng.randn(n) * 0.1).astype(np.float32),
                           "var": (rng.rand(n) + 0.5).astype(np.float32)}
            elif key == "downsample":
                walk(sub, s)
            elif key in s:
                walk(sub, s[key])
    walk(params, state)


@pytest.fixture(scope="module")
def jax_tiny():
    model = CLIPModel(jax_clip_cfg_from_dict(TINY))
    params, state = jax.device_get(model.init(jax.random.PRNGKey(0)))
    _randomize_bn(params["visual"], state["visual"], np.random.RandomState(1))
    block_state = state["visual"]["layer1"][0]
    assert not np.allclose(block_state["downsample_bn"]["var"], 1.0)
    assert not np.allclose(params["visual"]["layer4"][0]["bn3"]["scale"], 0.0)
    assert not np.allclose(state["visual"]["stem"]["bn1"]["mean"], 0.0)
    return model, params, state


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    _, params, state = jax_tiny
    cfg = clip_cfg_from_dict(TINY)
    with torch.device("meta"):
        model = CLIP(cfg)
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, state, cfg), strict=True)
    return model.eval()


def _images(n, size=32, seed=2):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_bottleneck_matches_jax(monkeypatch, pallas):
    """One stride-2 bottleneck with a downsample, bn3 scale 0.7, eval mode,
    against _bottleneck_apply on its XLA path (XCLIP_PALLAS_BLOCK unset) and
    on its Pallas path (=1, interpret mode), as tests/test_ops.py runs it."""
    if pallas == "1":
        monkeypatch.setenv("XCLIP_PALLAS_BLOCK", "1")
    else:
        monkeypatch.delenv("XCLIP_PALLAS_BLOCK", raising=False)
    x = np.random.RandomState(0).randn(2, 8, 8, 32).astype(np.float32)
    params, state = jax.device_get(R._bottleneck_init(jax.random.PRNGKey(0), 32, 8, stride=2))
    params["bn3"]["scale"] = np.full_like(params["bn3"]["scale"], 0.7)
    want, _ = R._bottleneck_apply(params, state, jnp.asarray(x), stride=2, train=False, dtype=None)

    block = Bottleneck(32, 8, stride=2)
    block.load_state_dict(bottleneck_state_dict(params, state), strict=True)
    block.eval()
    with torch.inference_mode():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_tiny_resnet_matches_jax(monkeypatch, jax_tiny, port_tiny, pallas):
    """layers=(1,1,1,1), width 16, 32 px, batch 8 (M % 8 == 0 at layer 4 for
    the Pallas path) against resnet_apply, eval mode."""
    if pallas == "1":
        monkeypatch.setenv("XCLIP_PALLAS_BLOCK", "1")
    else:
        monkeypatch.delenv("XCLIP_PALLAS_BLOCK", raising=False)
    model, params, state = jax_tiny
    x = _images(8)
    want, _, _ = R.resnet_apply(params["visual"], state["visual"], jnp.asarray(x), model.cfg.vision,
                                train=False)
    with torch.inference_mode():
        got = port_tiny.visual(torch.from_numpy(x))
    assert got.shape == (8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_tiny_text_tower_matches_jax(jax_tiny, port_tiny):
    """2 layers, width 32, 4 heads against text_apply with the default
    einsum attention (the JAX flash path needs a TPU: flash_mha passes
    interpret=False)."""
    model, params, _ = jax_tiny
    ids = jax_tokenize(TOKENIZER_TEXTS)
    want, _ = T.text_apply(params["text"], jnp.asarray(ids), model.cfg.text)
    with torch.inference_mode():
        got = port_tiny.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_tiny_bundle_normalized_features_match_jax(jax_tiny, port_tiny):
    model, params, state = jax_tiny
    x = _images(4, seed=3)
    ids = jax_tokenize(["a photo of a dog.", "a sketch of a barn."])
    want_img, _, _ = model.encode_image(params, jnp.asarray(x), state=state, normalize=True)
    want_txt, _ = model.encode_text(params, jnp.asarray(ids), normalize=True)
    with torch.inference_mode():
        got_img = port_tiny.encode_image(torch.from_numpy(x), normalize=True)
        got_txt = port_tiny.encode_text(torch.from_numpy(ids), normalize=True)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got_img.numpy(), axis=-1), 1.0, atol=1e-6)
    assert port_tiny.logit_scale.item() == pytest.approx(float(params["logit_scale"]))


def test_open_clip_pt_from_jax_loads_with_same_features(tmp_path, jax_tiny, port_tiny):
    """A .pt written by the JAX package loads into the port (strict) and
    gives the features of the weights carried over in memory."""
    model, params, state = jax_tiny
    path = tmp_path / "epoch_1.pt"
    save_open_clip_checkpoint(str(path), model, params, state, epoch=1)
    cfg = clip_cfg_from_dict(TINY)
    with torch.device("meta"):
        loaded = CLIP(cfg)
    loaded = loaded.to_empty(device="cpu")
    loaded.load_state_dict(load_open_clip_checkpoint(str(path)), strict=True)
    loaded.eval()
    x = torch.from_numpy(_images(2, seed=4))
    ids = torch.from_numpy(tokenize(["a painting of a lion."]))
    with torch.inference_mode():
        assert torch.equal(loaded.encode_image(x, normalize=True), port_tiny.encode_image(x, normalize=True))
        assert torch.equal(loaded.encode_text(ids, normalize=True), port_tiny.encode_text(ids, normalize=True))


def test_state_dict_keys_match_open_clip_export(jax_tiny, port_tiny):
    """The port's parameter names are exactly the open_clip keys the JAX
    exporter writes."""
    model, params, state = jax_tiny
    want = set(pytrees_to_open_clip_state_dict(model, params, state))
    assert set(port_tiny.state_dict()) == want


def test_module_prefix_is_stripped(tmp_path, port_tiny):
    sd = {f"module.{k}": v for k, v in port_tiny.state_dict().items()}
    torch.save({"epoch": 3, "state_dict": sd}, tmp_path / "ddp.pt")
    got = load_open_clip_checkpoint(str(tmp_path / "ddp.pt"))
    assert set(got) == set(port_tiny.state_dict())
    torch.save(port_tiny.state_dict(), tmp_path / "bare.pt")
    assert set(load_open_clip_checkpoint(str(tmp_path / "bare.pt"))) == set(got)


@pytest.mark.parametrize("text", TOKENIZER_TEXTS)
def test_tokenizer_token_exact(text):
    np.testing.assert_array_equal(tokenize([text]), jax_tokenize([text]))


def test_tokenizer_batch_and_context_length():
    np.testing.assert_array_equal(tokenize(TOKENIZER_TEXTS, context_length=32),
                                  jax_tokenize(TOKENIZER_TEXTS, context_length=32))
    tok = get_tokenizer("RN50")
    assert isinstance(tok, SimpleTokenizer) and tok.context_length == 77
    assert tok.decode(tok.encode("a photo of a dog")).strip() == "a photo of a dog"


def test_factory_configs_and_devices():
    assert {"RN50", "RN101", "RN50x4", "RN50-quickgelu"} <= set(factory.list_models())
    cfg = factory.get_clip_cfg("RN50-quickgelu")
    assert cfg.vision.layers == (3, 4, 6, 3) and cfg.text.act == "quick_gelu"
    assert cfg.vision.heads == 32 and cfg.embed_dim == 1024
    with pytest.raises(NotImplementedError):
        factory.get_clip_cfg("ViT-B-32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory.create_model("RN50")


def test_create_model_cpu_seeded_eval_only(monkeypatch):
    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRN", TINY)
    a = factory.create_model("TinyRN", device="cpu", seed=0)
    b = factory.create_model("TinyRN", device="cpu", seed=0)
    c = factory.create_model("TinyRN", device="cpu", seed=1)
    assert not a.training
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.visual.conv1.weight, c.visual.conv1.weight)
    assert torch.all(a.visual.layer1[0].bn3.weight == 0)  # zero-init bn3, as in JAX
    x = torch.from_numpy(_images(2))
    with torch.inference_mode():
        feats = a.encode_image(x, normalize=True)
    assert feats.shape == (2, 32) and torch.isfinite(feats).all()
    # create_model returns eval mode; train mode (batch statistics) now runs
    # and leaves the running statistics alone unless the caller applies them
    a.train()
    buffers = {k: v.clone() for k, v in a.visual.state_dict().items() if "running" in k}
    with torch.no_grad():
        train_feats = a.encode_image(x, normalize=True)
    assert torch.isfinite(train_feats).all() and not torch.allclose(train_feats, feats)
    for k, v in buffers.items():
        assert torch.equal(a.visual.state_dict()[k], v), k


@pytest.mark.parametrize("precision,compute", [
    ("fp32", torch.float32), ("bf16", torch.bfloat16), ("amp", torch.bfloat16),
    ("fp16", torch.bfloat16), ("float16", torch.float16),
])
def test_precision_policies_match_jax(precision, compute):
    from xclip_tpu.core.precision import get_policy as jax_get_policy

    got = get_policy(precision)
    want = jax_get_policy(precision)
    assert got.compute_dtype == compute
    assert str(got.compute_dtype).split(".")[-1] == jnp.dtype(want.compute_dtype).name
    assert str(got.param_dtype).split(".")[-1] == jnp.dtype(want.param_dtype).name


def test_bf16_bundle_close_to_fp32(port_tiny):
    """bf16 compute stays within bf16 rounding of the fp32 features (the
    kernels' dtype path on the CPU); unit-norm features, atol 3e-2."""
    x = torch.from_numpy(_images(4, seed=5))
    ids = torch.from_numpy(tokenize(["a photo of a cat.", "a clipart of a pizza."]))
    with torch.inference_mode():
        for enc, arg in ((port_tiny.encode_image, x), (port_tiny.encode_text, ids)):
            f32 = enc(arg, normalize=True)
            b16 = enc(arg, normalize=True, dtype=torch.bfloat16)
            assert b16.dtype == torch.float32
            torch.testing.assert_close(b16, f32, atol=3e-2, rtol=0)


# --- train mode (training slice) --------------------------------------------

@pytest.fixture
def one_torch_thread():
    """One intra-op thread for torch: the suite's workers share the CPU, and
    torch's thread pool then waits on preempted threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bottleneck_grads(params, state, x, ct, stride, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("XCLIP_PALLAS_BLOCK", "1")
    else:
        monkeypatch.delenv("XCLIP_PALLAS_BLOCK", raising=False)

    def loss(p, xx):
        out, new_state = R._bottleneck_apply(p, state, xx, stride=stride, train=True, dtype=None)
        return jnp.sum(out * ct), (out, new_state)

    (_, (out, new_state)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return jax.device_get((out, new_state, gp, gx))


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("inplanes,stride", [(32, 2), (32, 1)])
def test_train_bottleneck_matches_jax(monkeypatch, one_torch_thread, pallas, inplanes, stride):
    """Train-mode bottleneck (batch statistics) with a downsample (stride 2)
    and without one (stride 1, inplanes == 4 * planes): output, grads of every
    parameter and of x, and the new running statistics against
    ``_bottleneck_apply(train=True)`` on its Pallas path (K3 + K1/K2 with
    input moments, interpret mode) and on its default XLA path (plain BN),
    fp32. Tolerance atol = rtol = 1e-4 (BatchNorm's backward through the
    batch statistics over 32-128 rows)."""
    planes = 8
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 8, inplanes).astype(np.float32)
    params, state = jax.device_get(R._bottleneck_init(jax.random.PRNGKey(1), inplanes, planes, stride=stride))
    assert ("downsample" in params) == (stride > 1)
    params["bn3"]["scale"] = np.full_like(params["bn3"]["scale"], 0.7)
    _randomize_bn({"b": params}, {"b": state}, rng)
    oh = 8 // stride
    ct = rng.randn(2, oh, oh, planes * 4).astype(np.float32)
    want, new_state, gp, gx = _jax_bottleneck_grads(params, state, x, ct, stride, pallas, monkeypatch)

    block = Bottleneck(inplanes, planes, stride=stride)
    block.load_state_dict(bottleneck_state_dict(params, state), strict=True)
    block.train()
    xt = torch.from_numpy(x).requires_grad_()
    out, moments = block.forward_train(xt.permute(0, 3, 1, 2))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=1e-4, rtol=1e-4)
    want_grads = bottleneck_state_dict(gp, state)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    names = {"bn1": "bn1", "bn2": "bn2", "bn3": "bn3", "downsample.1": "downsample_bn"}
    assert set(moments) == {k for k, v in names.items() if v in new_state}
    for port_name, (mean, var) in moments.items():
        np.testing.assert_allclose(mean.numpy(), new_state[names[port_name]]["mean"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(var.numpy(), new_state[names[port_name]]["var"], atol=1e-5, rtol=1e-5)
    for name, buf in block.named_buffers():  # the forward wrote no buffer
        if "running" in name:
            assert torch.equal(buf, bottleneck_state_dict(params, state)[name]), name


def test_tiny_resnet_train_mode_matches_jax(monkeypatch, one_torch_thread, jax_tiny):
    """The whole tiny ResNet in train mode, with and without per-block
    recomputation: features and new running statistics of every BatchNorm
    against ``resnet_apply(train=True)`` (Pallas path), fp32, atol 1e-4; the
    recomputation changes nothing and updates no buffer."""
    from xclip_tpu_torch.models.resnet import apply_bn_moments

    monkeypatch.setenv("XCLIP_PALLAS_BLOCK", "1")
    model, params, state = jax_tiny
    x = _images(8, seed=6)
    want, new_state, _ = R.resnet_apply(params["visual"], state["visual"], jnp.asarray(x), model.cfg.vision,
                                        train=True)
    want_sd = state_dict_from_jax_params(params, {"visual": jax.device_get(new_state)}, clip_cfg_from_dict(TINY))
    cfg = clip_cfg_from_dict(TINY)
    results = []
    for remat in (False, True):
        with torch.device("meta"):
            port = CLIP(cfg)
        port = port.to_empty(device="cpu")
        port.load_state_dict(state_dict_from_jax_params(params, state, cfg), strict=True)
        port.train()
        moments = {}
        xt = torch.from_numpy(x)
        feats = port.visual(xt, moments=moments, grad_checkpointing=remat)
        feats.sum().backward()
        np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        assert len(moments) == 3 + 4 * 4  # stem + (bn1-3, downsample) of each block
        apply_bn_moments(port.visual, moments)
        for key, val in port.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(val.numpy(), want_sd[key].numpy(), atol=1e-5, rtol=1e-5, err_msg=key)
        results.append([p.grad.clone() for p in port.visual.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
