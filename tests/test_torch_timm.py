"""The port's timm-tower families (ConvNeXt, EVA01/EVA02, timm ViT with the
SigLIP towers) against the JAX package on the CPU.

Tiny configs: the JAX tests' own (``tests/test_eva.py``, ``test_timm_vit.py``,
``test_convnext.py``: 32-px images, width 32 or dims up to 128, 2 layers).
Both packages get the same numpy-seeded weights: the JAX pytree's
structure comes from ``jax.eval_shape`` of JAX's init (JAX's random init is
left out: it costs seconds a config), its leaves from a numpy seed, and the
port's bridge carries them into the port's state dict, which must equal
JAX's own export key for key and value for value. Both sides see the same
numpy inputs in fp32, so the tolerance (1e-4) covers summation order only;
the JAX towers run under ``jax.jit``. On the CPU, K4's wrapper takes its
plain version. Also: the RoPE and relpos tables, tiny EVA, SigLIP and
ConvNeXt CLIPs (``custom_text``, ``logit_bias``, SigLIP's text options),
every shipped config of the three families read as JAX reads it, and the
families of later slices refused by name.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_convnext import TINY as JAX_CONVNEXT
from test_eva import EVA01, EVA02, EVA02E
from test_timm_vit import GAP, RELPOS, TINY as JAX_SIGLIP
from test_torch_lso import eval_tree  # noqa: F401
from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.core.checkpoint import open_clip_state_dict_to_pytrees, pytrees_to_open_clip_state_dict
from xclip_tpu.models import convnext as jax_convnext
from xclip_tpu.models import eva as jax_eva
from xclip_tpu.models import factory as jax_factory
from xclip_tpu.models import timm_vit as jax_timm_vit
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.models.clip import clip_cfg_from_dict as jax_clip_cfg_from_dict
from xclip_tpu_torch.core.checkpoint import state_dict_from_jax_params
from xclip_tpu_torch.models import clip as port_clip
from xclip_tpu_torch.models import convnext, eva, factory, native_timm, timm_vit

ATOL = 1e-4

# (name, JAX cfg, JAX module, fn prefix, port module)
TOWERS = [
    ("eva01", EVA01, jax_eva, "eva", eva),
    ("eva02", EVA02, jax_eva, "eva", eva),
    ("eva02e", EVA02E, jax_eva, "eva", eva),
    ("siglip", JAX_SIGLIP, jax_timm_vit, "timm_vit", timm_vit),
    ("gap", GAP, jax_timm_vit, "timm_vit", timm_vit),
    ("relpos", RELPOS, jax_timm_vit, "timm_vit", timm_vit),
    ("convnext", JAX_CONVNEXT, jax_convnext, "convnext", convnext),
]
TOWER_IDS = [t[0] for t in TOWERS]


def _family_configs():
    """The shipped configs whose timm tower is in JAX's ConvNeXt, EVA or
    timm-ViT table, without an HF text tower."""
    names = set(jax_eva.VARIANTS) | set(jax_timm_vit.VARIANTS) | set(jax_convnext.VARIANTS)
    out = []
    for name in factory.list_models():
        d = factory.get_model_config(name)
        if d["vision_cfg"].get("timm_model_name") in names and "hf_model_name" not in d["text_cfg"]:
            out.append(name)
    return sorted(out)


FAMILY_CONFIGS = _family_configs()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


PORT_CFGS = {"EvaCfg": eva.EvaCfg, "TimmViTCfg": timm_vit.TimmViTCfg, "ConvNeXtCfg": convnext.ConvNeXtCfg}


def _port_cfg(jax_cfg):
    """The port's cfg with the JAX cfg's fields (the names match)."""
    return PORT_CFGS[type(jax_cfg).__name__](**dataclasses.asdict(jax_cfg))


def _seeded_tree(shapes, seed: int):
    """numpy leaves of ``shapes``' structure: 0.1 N(0, 1), LayerNorm scales
    and LayerScale gammas around 1 (so every branch carries signal)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        val = 0.1 * rng.standard_normal(leaf.shape)
        if names[-1] in ("scale", "gamma", "ls1", "ls2", "gamma_1", "gamma_2"):
            val = val + 1.0
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tower_params(jax_cfg, jax_mod, prefix, seed=0):
    shapes = jax.eval_shape(lambda k: getattr(jax_mod, f"{prefix}_init")(k, jax_cfg), jax.random.PRNGKey(0))
    return _seeded_tree(shapes, seed)


def _images(cfg, n=2, seed=0):
    return np.random.RandomState(seed).randn(n, cfg.image_size, cfg.image_size, 3).astype(np.float32)


def _assert_sd_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(val), err_msg=key)


def _assert_tree_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name,jax_cfg,jax_mod,prefix,mod", TOWERS, ids=TOWER_IDS)
def test_tower_features_and_stages_match_jax(name, jax_cfg, jax_mod, prefix, mod):
    """Features and every captured stage of the tiny tower, fp32, the same
    weights, against ``<family>_apply`` under jit at 1e-4."""
    params = _tower_params(jax_cfg, jax_mod, prefix)
    cfg = _port_cfg(jax_cfg)
    tower = native_timm.build(cfg).eval()
    tower.load_state_dict(mod.params_to_state_dict(params, cfg), strict=True)
    names = native_timm.stage_names(cfg)
    assert names == getattr(jax_mod, f"{prefix}_stage_names")(jax_cfg) == tower.stage_names()
    x = _images(cfg)
    apply = jax.jit(lambda p, im: getattr(jax_mod, f"{prefix}_apply")(p, im, jax_cfg, capture=names))
    want, want_inters = jax.device_get(apply(params, x))
    with torch.no_grad():
        got, inters = tower.run(torch.from_numpy(x), capture=names)
        assert torch.equal(tower(torch.from_numpy(x)), got)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL, err_msg=f"{name} features")
    assert set(inters) == set(want_inters) == set(names)
    for stage in names:
        np.testing.assert_allclose(inters[stage].numpy(), want_inters[stage], atol=ATOL, rtol=ATOL,
                                   err_msg=f"{name} {stage}")


@pytest.mark.parametrize("name,jax_cfg,jax_mod,prefix,mod", TOWERS, ids=TOWER_IDS)
def test_tower_bridge_matches_jax_both_ways(name, jax_cfg, jax_mod, prefix, mod):
    """The port's writer equals JAX's ``<family>_params_to_state_dict`` key
    for key and value for value, its state dict has exactly the bridged
    keys, and its reader returns JAX's pytree from that state dict."""
    params = _tower_params(jax_cfg, jax_mod, prefix, seed=1)
    cfg = _port_cfg(jax_cfg)
    sd = native_timm.params_to_state_dict(params, cfg)
    _assert_sd_equal(sd, getattr(jax_mod, f"{prefix}_params_to_state_dict")(params, jax_cfg))
    tower = native_timm.build(cfg)
    assert set(tower.state_dict()) == set(sd)
    tower.load_state_dict(sd, strict=True)
    back = native_timm.state_dict_to_params(tower.state_dict(), cfg)
    _assert_tree_equal(back, params)
    jax_back = getattr(jax_mod, f"{prefix}_state_dict_to_params")({k: v.numpy() for k, v in sd.items()}, jax_cfg)
    _assert_tree_equal(back, jax.device_get(jax_back))


@pytest.mark.parametrize("grid,ref_grid,head_dim", [(4, 4, 8), (14, 16, 64), (16, 16, 64), (24, 16, 64),
                                                    (16, 16, 112)])
def test_rope_tables_match_jax(grid, ref_grid, head_dim):
    """EVA02's RoPE tables at the tiny, EVA02-B/L (224, 336 px) and a wide
    head's shapes at 1e-7."""
    for got, want in zip(eva.rope_tables(grid, ref_grid, head_dim),
                         jax_eva._rope_tables(grid, ref_grid, head_dim)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_rope_rotates_pairs_and_skips_the_class_token():
    t = torch.arange(2 * 5 * 2 * 8, dtype=torch.float32).reshape(2, 5, 2, 8)
    np.testing.assert_array_equal(eva.rotate_pairs(t).numpy(),
                                  np.asarray(jax_eva._rotate_pairs(jnp.asarray(t.numpy()))))
    sin, cos = (torch.from_numpy(a) for a in eva.rope_tables(2, 2, 8))
    out = eva.apply_rope(t, sin, cos)
    assert torch.equal(out[:, 0], t[:, 0])
    want = jax_eva._apply_rope(jnp.asarray(t.reshape(2, 5, 16).numpy()), sin.numpy(), cos.numpy(), heads=2)
    np.testing.assert_allclose(out.reshape(2, 5, 16).numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("grid", [4, 14])
def test_relpos_tables_and_bias_match_jax(grid):
    got, want = timm_vit.relpos_tables(grid), jax_timm_vit._relpos_tables(grid)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[1], want[1])
    cfg = dataclasses.replace(_port_cfg(RELPOS), image_size=grid * RELPOS.patch_size)
    jax_cfg = dataclasses.replace(RELPOS, image_size=cfg.image_size)
    params = _tower_params(jax_cfg, jax_timm_vit, "timm_vit", seed=2)
    tower = timm_vit.TimmViT(cfg)
    tower.load_state_dict(timm_vit.params_to_state_dict(params, cfg), strict=True)
    with torch.no_grad():
        bias = tower.trunk.blocks[0].attn.rel_pos(None)
    want_bias = jax_timm_vit._relpos_bias(params["blocks"][0]["attn"]["rel_pos"], jax_cfg)
    assert tuple(bias.shape) == (cfg.heads, cfg.seq_len, cfg.seq_len)
    np.testing.assert_allclose(bias.numpy(), np.asarray(want_bias), atol=1e-6)


def test_mlp_hidden_widths_round_as_jax():
    """SwiGLU's int(width * 8/3) and SO400M's int(1152 * 3.7362)."""
    for name in ("EVA02-L-14", "EVA02-B-16", "EVA01-g-14", "EVA02-E-14", "ViT-SO400M-14-SigLIP"):
        v = factory.get_clip_cfg(name).vision
        assert v.mlp_hidden == jax_factory.get_clip_cfg(name).vision.mlp_hidden
    assert factory.get_clip_cfg("EVA02-L-14").vision.mlp_hidden == 2730
    assert factory.get_clip_cfg("ViT-SO400M-14-SigLIP").vision.mlp_hidden == 4304


# -- tiny CLIPs: custom_text, logit_bias, SigLIP's text tower ---------------

TEXT = {"context_length": 12, "vocab_size": 300, "width": 32, "heads": 2, "layers": 2}
SIGLIP_TEXT = dict(TEXT, no_causal_mask=True, proj_bias=True, pool_type="last", norm_kwargs={"eps": 1e-6},
                   hf_tokenizer_name="timm/ViT-B-16-SigLIP", tokenizer_kwargs={"clean": "canonicalize"})
CLIPS = {
    "eva02": ({"embed_dim": 24, "custom_text": True, "text_cfg": TEXT,
               "vision_cfg": {"timm_model_name": "eva02_base_patch16_clip_224", "timm_pool": "token",
                              "timm_proj": None, "timm_model_pretrained": False}}, EVA02),
    "siglip": ({"embed_dim": 32, "custom_text": True, "init_logit_bias": -10, "text_cfg": SIGLIP_TEXT,
                "vision_cfg": {"timm_model_name": "vit_base_patch16_siglip_224", "timm_pool": "map",
                               "timm_proj": "none", "timm_model_pretrained": False}}, JAX_SIGLIP),
    "convnext": ({"embed_dim": 24, "text_cfg": TEXT,
                  "vision_cfg": {"timm_model_name": "convnext_tiny", "timm_pool": "", "timm_proj": "linear",
                                 "timm_drop": 0.0, "timm_drop_path": 0.1, "timm_model_pretrained": False}},
                 JAX_CONVNEXT),
}


def _tiny_clips(name):
    d, jax_vision = CLIPS[name]
    jax_cfg = dataclasses.replace(jax_clip_cfg_from_dict(json.loads(json.dumps(d))), vision=jax_vision)
    cfg = dataclasses.replace(port_clip.clip_cfg_from_dict(json.loads(json.dumps(d))),
                              vision=_port_cfg(jax_vision))
    return CLIPModel(jax_cfg), cfg


@pytest.mark.parametrize("name", list(CLIPS))
def test_tiny_clip_matches_jax(name):
    """encode_image and encode_text (normalized) of a tiny EVA02, SigLIP and
    ConvNeXt CLIP against JAX, with the state dict equal to JAX's open_clip
    export (``text.*`` keys with ``custom_text``, ``logit_bias``) and
    loadable both ways."""
    jmodel, cfg = _tiny_clips(name)
    params = _seeded_tree(jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0)), seed=3)
    sd = state_dict_from_jax_params(params, {"visual": {}}, cfg)
    _assert_sd_equal(sd, pytrees_to_open_clip_state_dict(jmodel, params, {"visual": {}}))
    assert any(k.startswith("text.") for k in sd) == cfg.custom_text
    assert ("logit_bias" in sd) == (cfg.init_logit_bias is not None)
    port = port_clip.CLIP(cfg).eval()
    port.load_state_dict(sd, strict=True)
    # JAX's importer reads the port's state dict back to the same pytree
    back, _ = open_clip_state_dict_to_pytrees({k: v.numpy() for k, v in port.state_dict().items()}, jmodel)
    _assert_tree_equal(jax.device_get(back), params)

    x = _images(cfg.vision, n=3, seed=4)
    rng = np.random.RandomState(5)
    ids = rng.randint(1, cfg.text.vocab_size - 2, size=(3, cfg.text.context_length)).astype(np.int32)
    ids[:, 0], ids[:, 5], ids[:, 6:] = cfg.text.vocab_size - 2, cfg.text.vocab_size - 1, 0
    enc_img = jax.jit(lambda p, im: jmodel.encode_image(p, im, normalize=True)[0])
    enc_txt = jax.jit(lambda p, t: jmodel.encode_text(p, t, normalize=True)[0])
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(x), normalize=True)
        txt = port.encode_text(torch.from_numpy(ids), normalize=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(enc_img(params, x)), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(enc_txt(params, ids)), atol=ATOL, rtol=ATOL)
    if cfg.init_logit_bias is not None:
        assert port.logit_bias.item() == float(params["logit_bias"])


def test_tiny_clip_random_init_and_open_clip_pt(tmp_path, monkeypatch):
    """A seeded tiny SigLIP CLIP from ``init_parameters`` (the JAX init's
    distributions: trunc normal(0.02) weights, zero biases, the logit bias
    at init_logit_bias) saved as an open_clip ``.pt`` with DDP's prefix and
    a 16-token text positional embedding loads strict through
    ``create_model(pretrained=...)``, the embedding resampled as JAX's
    loader does."""
    from xclip_tpu.core.checkpoint import _resize_text_pos_embed

    monkeypatch.setitem(timm_vit.VARIANTS, "vit_tiny_siglip_test",
                        {k: getattr(JAX_SIGLIP, k) for k in ("patch_size", "width", "layers", "heads")})
    d = json.loads(json.dumps(CLIPS["siglip"][0]))
    d["vision_cfg"].update(timm_model_name="vit_tiny_siglip_test", image_size=JAX_SIGLIP.image_size)
    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinySigLIP-test", d)
    model = factory.create_model("TinySigLIP-test", device="cpu", seed=0)
    assert model.logit_bias.item() == -10.0 and model.text.text_projection.bias.abs().max().item() == 0.0
    w = model.visual.trunk.blocks[0].attn.qkv.weight.detach()
    assert float(w.abs().max()) <= 0.04 + 1e-7 and 0.015 < float(w.std()) < 0.025
    sd = dict(model.state_dict())
    pe16 = torch.randn(16, TEXT["width"], generator=torch.Generator().manual_seed(6))
    sd["text.positional_embedding"] = pe16
    path = str(tmp_path / "tiny.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    loaded = factory.create_model("TinySigLIP-test", pretrained=path, device="cpu")
    np.testing.assert_allclose(loaded.text.positional_embedding.detach().numpy(),
                               _resize_text_pos_embed(pe16.numpy(), TEXT["context_length"]), atol=1e-6)
    x = torch.from_numpy(_images(JAX_SIGLIP))
    with torch.no_grad():
        assert torch.equal(loaded.encode_image(x), model.encode_image(x))


# -- the shipped configs ----------------------------------------------------


def test_every_family_config_builds_its_cfg_as_jax_reads_it():
    """Each of the 29 EVA, ConvNeXt and timm-ViT configs without an HF text
    tower yields a CLIPCfg (no weights) whose vision and text fields equal
    JAX's."""
    assert len(FAMILY_CONFIGS) == 29, FAMILY_CONFIGS
    counts = {"EvaCfg": 0, "ConvNeXtCfg": 0, "TimmViTCfg": 0}
    for name in FAMILY_CONFIGS:
        cfg, jcfg = factory.get_clip_cfg(name), jax_factory.get_clip_cfg(name)
        counts[type(cfg.vision).__name__] += 1
        assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(jcfg.vision), name
        jtext = dataclasses.asdict(jcfg.text)
        jtext.pop("attention_impl")
        assert dataclasses.asdict(cfg.text) == jtext, name
        assert (cfg.custom_text, cfg.init_logit_bias, cfg.embed_dim) == (
            jcfg.custom_text, jcfg.init_logit_bias, jcfg.embed_dim), name
        assert cfg.is_native_timm and not cfg.is_resnet
    assert counts == {"EvaCfg": 7, "ConvNeXtCfg": 11, "TimmViTCfg": 11}


@pytest.mark.parametrize("name,family", [
    ("swin_tiny_patch4_window7_224", "swin"), ("ViTamin-S", "ViTamin"), ("ViTamin-L2-336", "ViTamin"),
    ("MobileCLIP-B", "MobileCLIP"), ("MobileCLIP-S2", "MobileCLIP")])
def test_later_timm_families_refused_by_name(name, family):
    with pytest.raises(NotImplementedError, match=f"{family}.*later slice"):
        factory.get_clip_cfg(name)


@pytest.mark.parametrize("name,key", [("nllb-clip-base-siglip", "hf_model_name"),
                                      ("roberta-ViT-B-32", "hf_model_name"), ("coca_ViT-B-32", "multimodal_cfg")])
def test_hf_text_and_coca_configs_refused_by_name(name, key):
    with pytest.raises(NotImplementedError, match=key):
        factory.get_clip_cfg(name)


def test_unknown_timm_name_and_timm_options_refused():
    d = factory.get_model_config("convnext_tiny")
    d["vision_cfg"]["timm_model_name"] = "convnext_nano"
    with pytest.raises(NotImplementedError, match="convnext_nano"):
        port_clip.clip_cfg_from_dict(d)
    with pytest.raises(NotImplementedError, match="patch dropout"):
        factory.get_clip_cfg("EVA02-B-16", force_patch_dropout=0.5)
    assert factory.get_clip_cfg("EVA02-B-16", force_patch_dropout=0.0).vision.grid == 14
    d = factory.get_model_config("convnext_base")
    d["vision_cfg"]["timm_drop"] = 0.1
    with pytest.raises(NotImplementedError, match="timm_drop"):
        port_clip.clip_cfg_from_dict(d)
    assert factory.get_clip_cfg("convnext_large_d", force_image_size=320).image_size == 320
    with pytest.raises(NotImplementedError, match="Hugging Face tokenizer"):
        from xclip_tpu_torch.tokenizer import get_tokenizer

        get_tokenizer("ViT-B-16-SigLIP")


def test_drop_path_is_identity_in_eval_and_refused_in_train():
    cfg = _port_cfg(JAX_CONVNEXT)
    cfg = dataclasses.replace(cfg, drop_path_rate=0.1)
    tower = convnext.ConvNeXt(cfg)
    tower.init_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(cfg))
    with torch.no_grad():
        a = tower.eval()(x)
        b = tower.eval()(x)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="drop path"):
        tower.train()(x)


def test_timm_model_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.create_model("convnext_tiny")


# -- the slice as a whole: zero-shot LSO of a tiny EVA02 and ConvNeXt CLIP --

LSO_TEXT = {"context_length": 77, "vocab_size": 49408, "width": 32, "heads": 2, "layers": 2}
LSO_CLIPS = {
    "eva02": ("eva02_tiny_lso_test", EVA02, jax_eva, eva,
              {k: getattr(EVA02, k) for k in ("patch_size", "width", "layers", "heads", "mlp_ratio", "qkv_fused",
                                              "swiglu", "rope", "ref_grid")},
              {"custom_text": True, "vision_cfg": {"timm_pool": "token", "timm_proj": None}}),
    "convnext": ("convnext_tiny_lso_test", JAX_CONVNEXT, jax_convnext, convnext,
                 (JAX_CONVNEXT.depths, JAX_CONVNEXT.dims),
                 {"vision_cfg": {"timm_pool": "", "timm_proj": "mlp", "timm_drop_path": 0.1}}),
}


@pytest.mark.parametrize("name", list(LSO_CLIPS))
def test_lso_slice_matches_jax(name, eval_tree, tmp_path, monkeypatch):
    """``evals/run_lso.main`` on a tiny EVA02 CLIP (``custom_text``: a
    ``.pt`` with ``text.*`` keys) and a tiny ConvNeXt CLIP (``mlp`` head)
    against JAX's ``run_lso_evaluation`` on the same ``.pt`` and tree, as
    ``test_torch_lso.py`` holds the RN slice: equal counts and labels, and
    predictions equal away from JAX's near ties."""
    import xclip_tpu.evals.run_lso as jax_run_lso
    import xclip_tpu_torch.evals.run_lso as port_run_lso
    from test_torch_lso import IMAGENET_CLASSES, MARGIN
    from xclip_tpu.core.checkpoint import save_open_clip_checkpoint

    tname, jax_vision, jax_mod, mod, variant, extra = LSO_CLIPS[name]
    monkeypatch.setitem(jax_mod.VARIANTS, tname, variant)
    monkeypatch.setitem(mod.VARIANTS, tname, variant)
    d = {"embed_dim": 24, "text_cfg": LSO_TEXT, **{k: v for k, v in extra.items() if k != "vision_cfg"},
         "vision_cfg": {"timm_model_name": tname, "image_size": jax_vision.image_size, "timm_model_pretrained": False,
                        **extra["vision_cfg"]}}
    model_name = f"Tiny-{name}-lso"
    monkeypatch.setitem(jax_factory._MODEL_CONFIGS, model_name, d)
    monkeypatch.setitem(factory._MODEL_CONFIGS, model_name, d)
    monkeypatch.setattr(jax_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)
    monkeypatch.setattr(port_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)
    jmodel = CLIPModel(jax_factory.get_clip_cfg(model_name))
    params = _seeded_tree(jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0)), seed=7)
    ckpt = tmp_path / "epoch_1.pt"
    save_open_clip_checkpoint(str(ckpt), jmodel, params, {"visual": {}}, epoch=1)

    jax_scores = []

    class RecordingClassifier(jax_run_lso.OpenAIZeroShotClassifier):
        def predict_from_features(self, img_feat, return_scores=False):
            out = super().predict_from_features(img_feat, return_scores=return_scores)
            jax_scores.append(np.asarray(out["pred"]))
            return out

    monkeypatch.setattr(jax_run_lso, "OpenAIZeroShotClassifier", RecordingClassifier)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    want = jax_run_lso.run_lso_evaluation(model_name, [str(ckpt)], str(jax_out), str(eval_tree / "imagenet"),
                                          str(eval_tree / "domainnet"), domain="sketch", domain_invariant=True,
                                          num_workers=2)
    assert port_run_lso.main(["--model", model_name, "--domain", "sketch", "--ckpt_files", str(ckpt),
                              "--out_path", str(port_out), "--imagenet_path", str(eval_tree / "imagenet"),
                              "--domainnet_path", str(eval_tree / "domainnet"), "--num_workers", "0",
                              "--domain_invariant", "--device", "cpu"]) == 0
    got = json.loads((port_out / "results.json").read_text())
    assert set(got) == set(want) and got["steps"] == want["steps"] == [1]
    assert got["domainnet-val"]["num-samples"] == want["domainnet-val"]["num-samples"]
    mismatched = 0
    for pred, scores in (("val_pred", jax_scores[0]), ("domain_pred", jax_scores[1])):
        jp, pp = np.load(jax_out / f"{pred}.npy")[0], np.load(port_out / f"{pred}.npy")[0]
        top2 = np.sort(scores, axis=1)[:, -2:]
        assert np.all((jp == pp) | ((top2[:, 1] - top2[:, 0]) < MARGIN)), f"{pred}: predictions differ"
        mismatched += int(np.sum(jp != pp))
    for labels in ("val_labels", "domain_labels", "domain_ids"):
        np.testing.assert_array_equal(np.load(port_out / f"{labels}.npy"), np.load(jax_out / f"{labels}.npy"))
    if mismatched == 0:
        assert got["imagenet-val"] == want["imagenet-val"]
        assert got["domainnet-val"]["accuracy"] == want["domainnet-val"]["accuracy"]
