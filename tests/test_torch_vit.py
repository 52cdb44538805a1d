"""The port's ViT towers and the text tower's ViT-config variants against the
JAX package on the CPU.

Tiny configs (2 layers, width 64 or 128, head dim 64, patch 8 on 32-px
images, a 16-token text tower with a 1,000-word vocabulary). The port's
model is initialised from a seed; JAX's importer
(``open_clip_state_dict_to_pytrees``) carries its state dict into JAX's
pytrees, and ``core.checkpoint.state_dict_from_jax_params`` must carry
those back to the same state dict, with the keys of JAX's own export
(JAX's random init is left out: it costs seconds per config on the CPU).
Both sides see the same numpy inputs, in fp32, so the tolerance (atol
1e-4 on features of O(1)) covers summation order only; the JAX towers
run under ``jax.jit``. On the CPU, K4's wrapper takes its plain
version. Also: every plain-ViT config in the assets read as JAX reads it,
the sin-cos embedding, patch dropout, the ``.pt`` bridge both ways, two
train steps against ``make_train_step``, and the training CLI on a tiny
ViT with patch dropout.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_models import release_memory_after_module  # noqa: F401
from test_torch_train import _keep_grads
from xclip_tpu.core.checkpoint import (
    _resize_text_pos_embed,
    _resize_vit_pos_embed,
    load_checkpoint,
    open_clip_state_dict_to_pytrees,
    pytrees_to_open_clip_state_dict,
    save_open_clip_checkpoint,
)
from xclip_tpu.models import factory as jax_factory
from xclip_tpu.models import transformer as T
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.models.clip import clip_cfg_from_dict as jax_clip_cfg_from_dict
from xclip_tpu.parallel.mesh import create_mesh
from xclip_tpu.train import optim as jax_optim
from xclip_tpu.train import schedule as jax_schedule
from xclip_tpu.train import step as jax_step
from xclip_tpu_torch.core.checkpoint import (
    load_open_clip_checkpoint,
    load_training_checkpoint,
    resize_text_pos_embed,
    resize_vit_pos_embed,
    state_dict_from_jax_params,
)
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.models.clip import CLIP, clip_cfg_from_dict
from xclip_tpu_torch.models.transformer import get_2d_sincos_pos_embed, patch_dropout
from xclip_tpu_torch.ops import flash_attention
from xclip_tpu_torch.train import optim, schedule
from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

ATOL = 1e-4
TEXT = {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 1, "layers": 2}


def _tiny(vision=None, text=None, embed_dim=32, **top):
    v = {"image_size": 32, "patch_size": 8, "width": 64, "layers": 2, "head_width": 64}
    return {"embed_dim": embed_dim, "vision_cfg": {**v, **(vision or {})}, "text_cfg": {**TEXT, **(text or {})},
            **top}


VIT_VARIANTS = {
    "learnable": _tiny(),
    "sin_cos_2d": _tiny({"pos_embed_type": "sin_cos_2d"}),
    "layer_scale": _tiny({"ls_init_value": 0.5, "mlp_ratio": 2.0}),
    "clipa": _tiny({"no_ln_pre": True, "pool_type": "avg", "final_ln_after_pool": True}),
    # the pooler's d_model (embed_dim) differs from the tower width: separate
    # q/k/v weights; equal: the packed in_proj_weight
    "attentional_pool": _tiny({"attentional_pool": True, "attn_pooler_queries": 8, "attn_pooler_heads": 2}),
    "attentional_pool_packed": _tiny({"attentional_pool": True, "attn_pooler_queries": 8,
                                      "attn_pooler_heads": 2, "width": 128}, embed_dim=128),
    "quick_gelu": _tiny({"width": 128}, quick_gelu=True),
    # two heads at the head dims of ViT-g-14, ViT-bigG-14 and ViT-e-14
    "head_width_88": _tiny({"width": 176, "head_width": 88}),
    "head_width_104": _tiny({"width": 208, "head_width": 104}),
    "head_width_112": _tiny({"width": 224, "head_width": 112}),
}
TEXT_VARIANTS = {
    "no_causal_mask_last": _tiny(text={"no_causal_mask": True, "pool_type": "last"}),
    "no_causal_mask_first": _tiny(text={"no_causal_mask": True, "pool_type": "first"}),
    "layer_scale": _tiny(text={"ls_init_value": 0.5, "mlp_ratio": 2.0, "width": 128, "heads": 2}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread: the suite runs several workers on a shared
    CPU, where torch's thread pool stalls on preempted threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _ShapeInit:
    """A JAX ``CLIPModel`` for JAX's importer whose ``init`` is traced for
    its shapes only (``jax.eval_shape``): the importer takes the pytree's
    structure, shapes and dtypes from it and every value from the state
    dict, and still refuses a missing key or a wrong shape."""

    def __init__(self, model):
        self.cfg, self._model = model.cfg, model

    def init(self, rng):
        shapes = jax.eval_shape(self._model.init, rng)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _models(d, seed=0):
    """(JAX model, its params, its state, the port's model in eval mode):
    the port initialised from ``seed``, JAX's pytrees imported from its
    state dict; the bridge back gives the same state dict."""
    cfg = clip_cfg_from_dict(d)
    port = CLIP(cfg)
    port.init_parameters(torch.Generator().manual_seed(seed))
    model = CLIPModel(jax_clip_cfg_from_dict(d, quick_gelu=bool(d.get("quick_gelu"))))
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    params, state = jax.device_get(open_clip_state_dict_to_pytrees(sd, _ShapeInit(model)))
    back = state_dict_from_jax_params(params, state, cfg)
    assert set(back) == set(sd)
    for key, val in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), val, err_msg=key)
    return model, params, state, port.eval()


def _jax_encode_image(model, params, x, train=False):
    return np.array(jax.jit(lambda p, im: model.encode_image(p, im, train=train)[0])(params, jnp.asarray(x)))


def _images(n=3, seed=2):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _ids(n=3, seed=4):
    """Random token ids with one largest id per row (the argmax pool's EOT)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 900, (n, TEXT["context_length"])).astype(np.int32)
    ids[np.arange(n), rng.randint(0, TEXT["context_length"], n)] = 999
    return ids


@pytest.mark.parametrize("variant", list(VIT_VARIANTS))
def test_vit_matches_jax(variant):
    """``encode_image`` against JAX's ``vit_apply`` on the same weights, in
    eval mode and in train mode (patch dropout 0), atol 1e-4; the port's
    state dict has exactly the keys and values of JAX's open_clip export,
    and every self-attention went through K4's wrapper, non-causal."""
    d = VIT_VARIANTS[variant]
    model, params, state, port = _models(d)
    want_sd = pytrees_to_open_clip_state_dict(model, params, state)
    got_sd = port.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, val in want_sd.items():
        np.testing.assert_array_equal(got_sd[key].numpy(), val, err_msg=key)
    x = _images()
    calls = []
    real = flash_attention.flash_attention

    def recording(q, k, v, causal=False):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash_attention, "flash_attention", recording)
        for train in (False, True):
            want = _jax_encode_image(model, params, x, train)
            port.train(train)
            with torch.set_grad_enabled(train):
                got = port.encode_image(torch.from_numpy(x))
            np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0, err_msg=f"train={train}")
    assert calls == [False] * (2 * d["vision_cfg"]["layers"])


@pytest.mark.parametrize("variant", list(TEXT_VARIANTS))
def test_text_variants_match_jax(variant):
    """The text tower with ``no_causal_mask`` (K4 non-causal) and ``last`` or
    ``first`` pooling, and with LayerScale and ``mlp_ratio`` 2, against
    JAX's ``text_apply``: atol 1e-4."""
    d = TEXT_VARIANTS[variant]
    model, params, _, port = _models(d)
    ids = _ids()
    want = jax.jit(lambda p, t: model.encode_text(p, t)[0])(params, jnp.asarray(ids))
    with torch.inference_mode():
        got = port.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert port.transformer.resblocks[0].attn.causal == (not d["text_cfg"].get("no_causal_mask", False))


@pytest.mark.parametrize("dim,grid", [(64, 4), (768, 14), (1024, 16)])
def test_sincos_pos_embed_matches_jax(dim, grid):
    want = T.get_2d_sincos_pos_embed(dim, grid, cls_token=True)
    got = get_2d_sincos_pos_embed(dim, grid, cls_token=True)
    assert got.shape == (grid * grid + 1, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_patch_dropout_keeps_class_token_and_count():
    """The class token always leads, ``max(1, int(n * (1 - p)))`` patches are
    kept (distinct, from the input), one seed gives the same tokens twice,
    another seed others; eval mode and a missing generator as documented."""
    b, n, w = 4, 196, 8
    tokens = torch.arange(b * (n + 1) * w, dtype=torch.float32).view(b, n + 1, w)
    for p, n_keep in ((0.5, 98), (0.25, 147), (0.999, 1)):
        out = patch_dropout(tokens, p, torch.Generator().manual_seed(0))
        assert out.shape == (b, n_keep + 1, w)
        torch.testing.assert_close(out[:, 0], tokens[:, 0])
        rows = (out[:, 1:, 0] - tokens[:, :1, 0]) / w  # token index within its sample
        assert all(len(set(r.tolist())) == n_keep and min(r.tolist()) >= 1 for r in rows)
    a = patch_dropout(tokens, 0.5, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, patch_dropout(tokens, 0.5, torch.Generator().manual_seed(7)), rtol=0, atol=0)
    assert not torch.equal(a, patch_dropout(tokens, 0.5, torch.Generator().manual_seed(8)))

    d = _tiny({"patch_dropout": 0.5})
    model, params, _, port = _models(d)
    x = torch.from_numpy(_images())
    want = _jax_encode_image(model, params, x.numpy())
    with torch.inference_mode():
        np.testing.assert_allclose(port.encode_image(x).numpy(), want, atol=ATOL, rtol=0)
        port.train()
        with pytest.raises(ValueError, match="generator"):
            port.encode_image(x)
        f1 = port.encode_image(x, generator=torch.Generator().manual_seed(3))
        f2 = port.encode_image(x, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    assert not torch.allclose(f1, torch.from_numpy(want), atol=1e-3)


def test_open_clip_pt_round_trip_both_ways(tmp_path):
    """A ``.pt`` the JAX package writes loads strictly into the port with the
    same features, and one the port writes loads into JAX's
    ``load_checkpoint`` with the same parameters (LayerScale, attentional
    pooler with separate q/k/v weights, no ln_pre)."""
    d = _tiny({"ls_init_value": 0.5, "attentional_pool": True, "attn_pooler_queries": 8,
               "attn_pooler_heads": 2, "no_ln_pre": True})
    model, params, state, port = _models(d)
    path = tmp_path / "jax.pt"
    save_open_clip_checkpoint(str(path), model, params, state, epoch=1)
    loaded = CLIP(port.cfg).eval()
    loaded.load_state_dict(load_open_clip_checkpoint(str(path)), strict=True)
    x = torch.from_numpy(_images())
    with torch.inference_mode():
        torch.testing.assert_close(loaded.encode_image(x), port.encode_image(x), rtol=0, atol=0)

    torch.save({"epoch": 1, "state_dict": port.state_dict()}, tmp_path / "port.pt")
    got, _ = load_checkpoint(str(tmp_path / "port.pt"), _ShapeInit(model), None, None)
    want_flat = jax.tree_util.tree_leaves_with_path(params)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(got)))
    assert len(got_flat) == len(want_flat)
    for path_, leaf in want_flat:
        np.testing.assert_array_equal(np.asarray(got_flat[path_]), np.asarray(leaf), err_msg=str(path_))


def _plain_vit_configs():
    names = []
    for name in factory.list_models():
        cfg = factory.get_model_config(name)
        v, t = cfg["vision_cfg"], cfg["text_cfg"]
        if not isinstance(v.get("layers"), (list, tuple)) and "timm_model_name" not in v \
                and "hf_model_name" not in t and "multimodal_cfg" not in cfg:
            names.append(name)
    return names


@pytest.mark.parametrize("name", _plain_vit_configs())
def test_vit_config_matches_jax(name):
    """Every plain-ViT config in the assets: the port's config holds JAX
    ``factory.get_clip_cfg``'s value in each field both have (no weights
    built), SigLIP's ``init_logit_bias`` included (ported since the timm
    slice)."""
    want = jax_factory.get_clip_cfg(name)
    got = factory.get_clip_cfg(name)
    assert got.init_logit_bias == want.init_logit_bias
    for part in ("vision", "text"):
        g, w = getattr(got, part), getattr(want, part)
        for field in g.__dataclass_fields__:
            assert getattr(g, field) == getattr(w, field), f"{part}.{field}"
    assert (got.embed_dim, got.image_size) == (want.embed_dim, want.image_size)
    assert got.init_logit_scale == pytest.approx(want.init_logit_scale)


@pytest.mark.parametrize("old,new", [(7, 14), (16, 7), (14, 10)])
def test_vit_pos_embed_resize_matches_jax(old, new):
    """The grid of a ViT positional embedding resampled as JAX's loader does
    (bicubic, a = -0.5, antialiased when shrinking; the class token kept):
    up 7 -> 14, down 16 -> 7 and 14 -> 10, atol 1e-5."""
    pe = np.random.RandomState(old * 100 + new).randn(1 + old * old, 48).astype(np.float32)
    want = _resize_vit_pos_embed(pe, 1 + new * new)
    got = resize_vit_pos_embed(torch.from_numpy(pe), 1 + new * new)
    assert got.dtype == torch.float32 and torch.equal(got[0], torch.from_numpy(pe[0]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="non-square grid"):
        resize_vit_pos_embed(torch.from_numpy(pe), new * new)


@pytest.mark.parametrize("new", [32, 100])
def test_text_pos_embed_resize_matches_jax(new):
    """The text positional embedding resampled linearly to another context
    length (77 -> 32, a CLIPA config's; 77 -> 100), as JAX's loader does."""
    pe = np.random.RandomState(new).randn(77, 48).astype(np.float32)
    got = resize_text_pos_embed(torch.from_numpy(pe), new)
    np.testing.assert_allclose(got.numpy(), _resize_text_pos_embed(pe, new), atol=1e-5, rtol=0)


def test_pretrained_pt_loads_at_another_image_size_as_in_jax(tmp_path, monkeypatch):
    """A tiny ViT's ``.pt`` at 32 px (a 4 x 4 grid) loads under
    ``force_image_size`` 48 (6 x 6) through the port's
    ``create_model(pretrained=...)`` and through JAX's ``load_checkpoint``
    into the same config: the same features, atol 1e-4;
    ``load_training_checkpoint`` resizes the same way (shrinking is held
    by ``test_vit_pos_embed_resize_matches_jax``)."""
    d = VIT_VARIANTS["learnable"]
    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyViTresize", d)
    path = tmp_path / "epoch_1.pt"
    torch.save({"epoch": 1, "state_dict": factory.create_model("TinyViTresize", device="cpu", seed=3).state_dict()},
               path)
    port = factory.create_model("TinyViTresize", pretrained=str(path), device="cpu", force_image_size=48)
    model = CLIPModel(jax_clip_cfg_from_dict({**d, "vision_cfg": {**d["vision_cfg"], "image_size": 48}}))
    params, _ = load_checkpoint(str(path), _ShapeInit(model), None, None)
    x = np.random.RandomState(48).randn(2, 48, 48, 3).astype(np.float32)
    with torch.inference_mode():
        got = port.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _jax_encode_image(model, params, x), atol=1e-4, rtol=0)
    resumed = factory.create_model("TinyViTresize", device="cpu", seed=4, force_image_size=48)
    load_training_checkpoint(str(path), resumed)
    assert torch.equal(resumed.state_dict()["visual.positional_embedding"],
                       port.state_dict()["visual.positional_embedding"])


def test_factory_forces_image_size_and_patch_dropout():
    cfg = factory.get_clip_cfg("ViT-B-16", force_image_size=112, force_patch_dropout=0.5)
    want = jax_factory.get_clip_cfg("ViT-B-16", force_image_size=112, force_patch_dropout=0.5)
    assert (cfg.vision.image_size, cfg.vision.seq_len, cfg.vision.patch_dropout) == (112, 50, 0.5)
    assert (want.vision.image_size, want.vision.patch_dropout) == (112, 0.5)
    assert factory.get_clip_cfg("convnext_base", force_image_size=320).image_size == 320  # timm towers too
    with pytest.raises(NotImplementedError, match="swin.*later slice"):
        factory.get_clip_cfg("swin_base_patch4_window7_224")
    with pytest.raises(NotImplementedError, match="multimodal_cfg"):
        factory.get_clip_cfg("coca_ViT-B-32")
    with pytest.raises(NotImplementedError, match="hf_model_name"):
        factory.get_clip_cfg("roberta-ViT-B-32")


TRAIN_VIT = _tiny({"image_size": 64, "patch_size": 16, "ls_init_value": 0.5})
MICRO, STEPS, LR, WARMUP, CLIP_NORM, EPS = 8, 2, 1e-5, 1, 1.0, 1e-3


def _train_batches(n):
    rng = np.random.RandomState(5)
    return [(rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8), _ids(n, seed=10 + i)) for i in range(STEPS)]


def test_vit_train_step_matches_jax():
    """Two fp32 steps at accum-freq 2 (8 images per microbatch) of a tiny ViT
    with LayerScale, the port's with grad checkpointing, against JAX's
    ``make_train_step`` (recomputation changes no number; test_torch_train's
    tolerances: step 1's loss, grad
    norm and logit scale rtol 1e-5 and each clipped gradient within 5e-4 of
    its tensor's largest element; step 2's metrics rtol 1e-3; parameters
    after step 2 atol 5e-6). A ViT step has no BatchNorm state."""
    model, params, state, port = _models(TRAIN_VIT)
    assert state == {"visual": {}} and not list(port.buffers())
    cfg = jax_step.TrainStepCfg(precision="fp32", accum_freq=2)
    tx = optax.chain(optax.clip_by_global_norm(CLIP_NORM), _keep_grads(),
                     jax_optim.adamw(jax_schedule.cosine_lr(LR, WARMUP, STEPS), beta1=0.9, beta2=0.98, eps=EPS,
                                     weight_decay=0.2))
    mesh = create_mesh(jax.devices()[:1])
    step = jax_step.make_train_step(model, tx, mesh, cfg)
    # inputs placed as the step places its outputs, so the second step reuses the first's compilation
    replicated = NamedSharding(mesh, PartitionSpec())
    p, s = jax.device_put((params, state), replicated)
    opt = jax.device_put(tx.init(p), replicated)
    want_metrics, want_grads = [], None
    for images, texts in _train_batches(2 * MICRO):
        p, s, opt, m = step(p, s, opt, {"images": images, "texts": texts})
        want_metrics.append({k: float(v) for k, v in m.items()})
        want_grads = jax.device_get(opt[1]["g"]) if want_grads is None else want_grads
    port_cfg = clip_cfg_from_dict(TRAIN_VIT)
    g_sd = state_dict_from_jax_params(want_grads, state, port_cfg)
    want_sd = state_dict_from_jax_params(jax.device_get(p), state, port_cfg)

    port.train()
    popt = optim.adamw(port, lr=LR, beta1=0.9, beta2=0.98, eps=EPS, weight_decay=0.2)
    pstep = make_train_step(port, popt, schedule.cosine_lr(LR, WARMUP, STEPS),
                            TrainStepCfg(precision="fp32", grad_checkpointing=True, accum_freq=2,
                                         grad_clip_norm=CLIP_NORM))
    before = flash_attention.backward_calls
    for i, (images, texts) in enumerate(_train_batches(2 * MICRO)):
        m = pstep(torch.from_numpy(images), torch.from_numpy(texts), i)
        for key in ("loss", "grad_norm", "logit_scale"):
            rtol = 1e-5 if i == 0 or key == "logit_scale" else 1e-3
            np.testing.assert_allclose(float(m[key]), want_metrics[i][key], rtol=rtol, err_msg=f"step {i} {key}")
        if i == 0:
            for name, prm in port.named_parameters():
                want = g_sd[name].numpy()
                np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0, err_msg=name,
                                           atol=max(5e-4 * float(np.abs(want).max()), 1e-7))
    # 2 layers per tower, 2 microbatches, 2 steps: one backward per block and microbatch
    assert flash_attention.backward_calls - before == STEPS * 2 * 4
    for name, val in port.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want_sd[name].numpy(), atol=5e-6, rtol=0, err_msg=name)


def test_sincos_embedding_is_frozen_in_training():
    """The fixed sin-cos embedding has no gradient, is in no optimizer group
    and comes out of a step unchanged; the learnable one trains."""
    for pos, frozen in (("sin_cos_2d", True), ("learnable", False)):
        port = CLIP(clip_cfg_from_dict(_tiny({"pos_embed_type": pos, "image_size": 64, "patch_size": 16})))
        port.init_parameters(torch.Generator().manual_seed(0))
        port.train()
        pe = port.visual.positional_embedding
        before = pe.detach().clone()
        opt = optim.adamw(port, lr=1e-3)
        assert any(p is pe for g in opt.param_groups for p in g["params"]) != frozen
        step = make_train_step(port, opt, schedule.const_lr(1e-3, 1), TrainStepCfg(precision="fp32"))
        images, texts = _train_batches(4)[0]
        step(torch.from_numpy(images), torch.from_numpy(texts), 0)
        assert (pe.grad is None) == frozen
        assert torch.equal(pe.detach(), before) == frozen


def test_train_cli_tiny_vit_with_patch_dropout(tmp_path, monkeypatch):
    """``train.main`` on the CPU for a tiny ViT with ``--force-patch-dropout
    0.5``, 2 steps at accum-freq 2 with grad checkpointing: finite losses in
    reference-format log lines, and ``epoch_1.pt`` loads into the eval model.
    The same seed gives the same losses twice (the dropout draws are seeded)."""
    from xclip_tpu_torch.train import main as train_main

    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyViT", _tiny({"image_size": 64, "patch_size": 16},
                                                                 {"context_length": 77, "vocab_size": 49408}))
    losses = []
    for run in ("a", "b"):
        argv = ["--model", "TinyViT", "--dataset-type", "synthetic", "--train-num-samples", "16",
                "--batch-size", "4", "--accum-freq", "2", "--epochs", "1", "--warmup", "1", "--precision", "fp32",
                "--grad-checkpointing", "--force-patch-dropout", "0.5", "--workers", "1", "--device", "cpu",
                "--log-every-n-steps", "1", "--logs", str(tmp_path), "--name", run]
        assert train_main.main(argv) == 0
        with open(os.path.join(tmp_path, run, "out.log")) as fh:
            lines = [ln for ln in fh.read().splitlines() if "Train Epoch:" in ln]
        losses.append([float(ln.split("Loss: ")[1].split()[0]) for ln in lines])
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert losses[0] == losses[1]
    ckpt = os.path.join(tmp_path, "a", "checkpoints", "epoch_1.pt")
    model = factory.create_model("TinyViT", pretrained=ckpt, device="cpu")
    assert model.cfg.vision.patch_dropout == 0.0
    with torch.inference_mode():
        feats = model.encode_image(torch.randn(2, 64, 64, 3), normalize=True)
    assert feats.shape == (2, 32) and torch.isfinite(feats).all()
