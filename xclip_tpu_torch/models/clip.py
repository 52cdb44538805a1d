"""CLIP bundle: an image tower + text tower + logit scale (+ logit bias).

Counterpart of ``xclip_tpu/models/clip.py`` (``clip_cfg_from_dict``,
``CLIPModel.encode_image``, ``encode_text``, ``_l2_normalize``; :31-161,
:190-267) as one ``nn.Module`` whose state-dict names are open_clip's CLIP
(``visual.*``, ``token_embedding``, ``positional_embedding``,
``transformer.*``, ``ln_final``, ``text_projection``, ``logit_scale``), so
an open_clip ``.pt`` loads with ``load_state_dict``. With ``custom_text``
(open_clip's ``CustomTextCLIP``: the EVA and SigLIP configs) the text tower
is the submodule ``text`` and its keys are ``text.*``; ``init_logit_bias``
adds the SigLIP ``logit_bias``. The image tower is a ModifiedResNet, a
plain ViT, or a timm tower (ConvNeXt, EVA01/EVA02, timm ViT with the
SigLIP towers: ``models/native_timm.py``, ``visual.trunk.*`` and
``visual.head.*``). HF text towers, CoCa and the timm families of later
slices are not ported. :meth:`CLIP.forward` is the contrastive training
forward (``CLIPModel.forward``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models import native_timm
from xclip_tpu_torch.models.resnet import ModifiedResNet, Moments, ResNetCfg
from xclip_tpu_torch.models.transformer import (
    TextTransformerCfg,
    Transformer,
    VisionTransformer,
    VisionTransformerCfg,
)


@dataclasses.dataclass(frozen=True)
class CLIPCfg:
    embed_dim: int
    vision: object  # ResNetCfg, VisionTransformerCfg or a timm family's cfg
    text: TextTransformerCfg
    init_logit_scale: float = math.log(1 / 0.07)
    init_logit_bias: Optional[float] = None  # SigLIP's logit bias; None: plain CLIP
    custom_text: bool = False  # the text tower's keys under "text."

    @property
    def image_size(self) -> int:
        return self.vision.image_size

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision, ResNetCfg)

    @property
    def is_native_timm(self) -> bool:
        return native_timm.is_native_timm(self.vision)


# open_clip config keys the port reads. The tokenizer-only keys are for
# the tokenizer, not the towers; any other key belongs to a family of a
# later slice (hf_model_name, multimodal_cfg, ...) and is refused by name.
_KEYS = {"embed_dim", "vision_cfg", "text_cfg", "quick_gelu", "custom_text", "init_logit_bias", "init_logit_scale"}
_RESNET_KEYS = {"image_size", "layers", "width", "patch_size"}
_VIT_KEYS = {"image_size", "layers", "width", "patch_size", "head_width", "mlp_ratio", "patch_dropout",
             "attentional_pool", "attn_pooler_queries", "attn_pooler_heads", "pool_type", "final_ln_after_pool",
             "no_ln_pre", "ls_init_value", "pos_embed_type"}
_TIMM_KEYS = {"image_size", "timm_model_name", "timm_model_pretrained", "timm_pool", "timm_proj", "timm_proj_bias",
              "timm_drop", "timm_drop_path", "patch_dropout"}
_TEXT_KEYS = {"context_length", "vocab_size", "width", "heads", "layers", "mlp_ratio", "pool_type",
              "no_causal_mask", "ls_init_value", "proj_bias", "norm_kwargs"}
_TOKENIZER_KEYS = {"hf_tokenizer_name", "tokenizer_kwargs"}


def _vision_cfg(v: dict, embed_dim: int, act: str):
    if "timm_model_name" in v:
        if v.get("timm_model_pretrained"):
            raise NotImplementedError("timm_model_pretrained: timm hub weights are not available to the port")
        if v.get("patch_dropout"):
            raise NotImplementedError("patch dropout in a timm tower is not ported yet (a later slice)")
        if v.get("timm_drop"):
            raise NotImplementedError("timm_drop (the timm head's dropout in training) is not ported yet "
                                      "(a later slice)")
        return native_timm.cfg_from_vision_dict(v, embed_dim)
    if isinstance(v.get("layers"), (list, tuple)):
        width = v.get("width", 64)
        return ResNetCfg(
            layers=tuple(v["layers"]),
            width=width,
            output_dim=embed_dim,
            heads=width * 32 // 64,  # open_clip's head_width 64
            image_size=v.get("image_size", 224),
        )
    return VisionTransformerCfg(
        image_size=v.get("image_size", 224),
        patch_size=v["patch_size"],
        width=v["width"],
        layers=v["layers"],
        heads=v["width"] // v.get("head_width", 64),
        mlp_ratio=v.get("mlp_ratio", 4.0),
        output_dim=embed_dim,
        act=act,
        pool_type=v.get("pool_type", "tok"),
        final_ln_after_pool=bool(v.get("final_ln_after_pool", False)),
        no_ln_pre=bool(v.get("no_ln_pre", False)),
        ls_init_value=v.get("ls_init_value"),
        patch_dropout=v.get("patch_dropout", 0.0),
        attentional_pool=bool(v.get("attentional_pool", False)),
        attn_pooler_queries=v.get("attn_pooler_queries", 256),
        attn_pooler_heads=v.get("attn_pooler_heads", 8),
        pos_embed_type=v.get("pos_embed_type", "learnable"),
    )


def clip_cfg_from_dict(d: dict) -> CLIPCfg:
    """CLIPCfg from an open_clip JSON model config (``clip.clip_cfg_from_dict``
    with ``quick_gelu`` read from the dict, as ``factory.get_clip_cfg``
    does) for ModifiedResNet, plain ViT and the ported timm image towers
    with the CLIP text tower; raises ``NotImplementedError`` naming any
    other key, and for a timm family not ported yet."""
    v, t = d["vision_cfg"], d["text_cfg"]
    vision_keys = (_TIMM_KEYS if "timm_model_name" in v
                   else _RESNET_KEYS if isinstance(v.get("layers"), (list, tuple)) else _VIT_KEYS)
    unported = ((set(d) - _KEYS) | (set(v) - vision_keys) | (set(t) - _TEXT_KEYS - _TOKENIZER_KEYS)
                | (set(t.get("norm_kwargs") or {}) - {"eps"}))
    if unported:
        raise NotImplementedError(f"unported config keys {sorted(unported)}: only ModifiedResNet, plain ViT and "
                                  "the ConvNeXt, EVA and timm-ViT image towers with the CLIP text tower are "
                                  "ported so far")
    embed_dim = d["embed_dim"]
    act = "quick_gelu" if d.get("quick_gelu") else "gelu"
    vision = _vision_cfg(v, embed_dim, act)
    text = TextTransformerCfg(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512),
        heads=t.get("heads", 8),
        layers=t.get("layers", 12),
        mlp_ratio=t.get("mlp_ratio", 4.0),
        output_dim=embed_dim,
        act=act,
        pool_type=t.get("pool_type", "argmax"),
        no_causal_mask=bool(t.get("no_causal_mask", False)),
        ls_init_value=t.get("ls_init_value"),
        proj_bias=bool(t.get("proj_bias", False)),
        norm_eps=(t.get("norm_kwargs") or {}).get("eps", 1e-5),
    )
    extra = {"init_logit_scale": float(d["init_logit_scale"])} if "init_logit_scale" in d else {}
    bias = d.get("init_logit_bias")
    return CLIPCfg(embed_dim=embed_dim, vision=vision, text=text,
                   init_logit_bias=None if bias is None else float(bias),
                   custom_text=bool(d.get("custom_text", False)), **extra)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis in fp32 (``clip._l2_normalize``)."""
    x = x.float()
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp_min(eps)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPCfg):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        if cfg.is_resnet:
            self.visual = ModifiedResNet(cfg.vision)
        elif cfg.is_native_timm:
            self.visual = native_timm.build(cfg.vision)
        else:
            self.visual = VisionTransformer(cfg.vision)
        tower = self
        if cfg.custom_text:
            self.text = tower = nn.Module()
        tower.token_embedding = nn.Embedding(t.vocab_size, t.width)
        tower.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        tower.transformer = Transformer(t.width, t.layers, t.heads, act=t.act, mlp_ratio=t.mlp_ratio,
                                        ls_init_value=t.ls_init_value, causal=not t.no_causal_mask,
                                        ln_eps=t.norm_eps)
        tower.ln_final = nn.LayerNorm(t.width, eps=t.norm_eps)
        if t.proj_bias:
            tower.text_projection = nn.Linear(t.width, cfg.embed_dim)
        else:
            tower.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))
        if cfg.init_logit_bias is not None:
            self.logit_bias = nn.Parameter(torch.empty(()))

    normalize = staticmethod(l2_normalize)

    def text_tower(self) -> nn.Module:
        """The module holding the text tower's parameters: ``text`` with
        ``custom_text``, else the model itself."""
        return self.text if self.cfg.custom_text else self

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the JAX init's distributions
        (``resnet_init``, ``vit_init`` or the timm family's init,
        ``text_init``). The numbers differ from JAX's for the same seed:
        tests carry JAX weights over with
        ``core.checkpoint.state_dict_from_jax_params`` instead."""
        t, tower = self.cfg.text, self.text_tower()
        self.visual.init_parameters(generator)
        L.normal_(tower.token_embedding.weight, 0.02, generator)
        L.normal_(tower.positional_embedding, 0.01, generator)
        tower.transformer.init_parameters(generator)
        L.layer_norm_init_(tower.ln_final)
        if t.proj_bias:
            L.normal_(tower.text_projection.weight, t.width ** -0.5, generator)
            tower.text_projection.bias.zero_()
        else:
            L.normal_(tower.text_projection, t.width ** -0.5, generator)
        self.logit_scale.fill_(self.cfg.init_logit_scale)
        if self.cfg.init_logit_bias is not None:
            self.logit_bias.fill_(self.cfg.init_logit_bias)

    def encode_image(self, images: torch.Tensor, *, normalize: bool = False,
                     dtype: Optional[torch.dtype] = None, moments: Optional[Moments] = None,
                     generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC float -> (N, embed_dim) features. In
        train mode ``moments`` receives a ResNet's new BatchNorm running
        statistics (see ``ModifiedResNet.forward``) and ``generator`` drives
        a ViT's patch dropout. A timm tower takes neither."""
        if self.cfg.is_resnet:
            feats = self.visual(images, dtype=dtype, moments=moments, grad_checkpointing=grad_checkpointing)
        else:
            feats = self.visual(images, dtype=dtype, generator=generator, grad_checkpointing=grad_checkpointing)
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, text_ids: torch.Tensor, *, normalize: bool = False,
                    dtype: Optional[torch.dtype] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """text_ids: (N, L) int token ids -> (N, embed_dim) fp32 features."""
        tower = self.text_tower()
        emb_dtype = dtype or tower.token_embedding.weight.dtype
        ids = text_ids.long()
        x = tower.token_embedding.weight[ids].to(emb_dtype)
        x = x + tower.positional_embedding[: x.shape[1]].to(emb_dtype)
        x = tower.transformer(x, dtype=dtype, grad_checkpointing=grad_checkpointing)
        x = L.layer_norm(x, tower.ln_final)
        pool = self.cfg.text.pool_type
        if pool == "argmax":  # the EOT token has the highest id in each sequence
            pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        elif pool in ("first", "last"):
            pooled = x[:, 0 if pool == "first" else -1]
        else:
            raise ValueError(f"text pool_type {pool!r}")
        proj = tower.text_projection
        bias = None
        if isinstance(proj, nn.Linear):  # proj_bias: (out, in) weight, fp32 bias after the product
            proj, bias = proj.weight.t(), proj.bias
        if dtype is not None:
            # inputs rounded to the compute dtype, fp32 product and result
            # (jnp.dot with preferred_element_type=float32)
            pooled, proj = pooled.to(dtype), proj.to(dtype)
        feats = pooled.float() @ proj.float()
        if bias is not None:
            feats = feats + bias.float()
        return l2_normalize(feats) if normalize else feats

    def forward(self, images: torch.Tensor, texts: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                moments: Optional[Moments] = None, generator: Optional[torch.Generator] = None,
                grad_checkpointing: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Contrastive forward -> (normalized fp32 image features, normalized
        fp32 text features, ``logit_scale.exp()``)."""
        img = self.encode_image(images, normalize=True, dtype=dtype, moments=moments, generator=generator,
                                grad_checkpointing=grad_checkpointing)
        txt = self.encode_text(texts, normalize=True, dtype=dtype, grad_checkpointing=grad_checkpointing)
        return img, txt, self.logit_scale.exp()
