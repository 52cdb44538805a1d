"""CLIP bundle: a ModifiedResNet or ViT image tower + text tower + logit scale.

Counterpart of ``xclip_tpu/models/clip.py`` (``clip_cfg_from_dict``,
``CLIPModel.encode_image``, ``encode_text``, ``_l2_normalize``; :88-161,
:211-267) as one ``nn.Module`` whose state-dict names are open_clip's CLIP
(``visual.*``, ``token_embedding``, ``positional_embedding``,
``transformer.*``, ``ln_final``, ``text_projection``, ``logit_scale``), so
an open_clip ``.pt`` loads with ``load_state_dict``. The ResNet and plain
ViT image towers and the plain text tower are ported; timm towers, HF text
towers, CoCa and SigLIP are not. :meth:`CLIP.forward` is the contrastive
training forward (``CLIPModel.forward``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from xclip_tpu_torch.models import layers as L
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
    vision: Union[ResNetCfg, VisionTransformerCfg]
    text: TextTransformerCfg
    init_logit_scale: float = math.log(1 / 0.07)

    @property
    def image_size(self) -> int:
        return self.vision.image_size

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision, ResNetCfg)


# open_clip config keys the port reads. The tokenizer-only keys are for
# the tokenizer, not the towers; any other key belongs to a family of a
# later slice (timm_model_name, hf_model_name, multimodal_cfg,
# init_logit_bias, ...) and is refused by name.
_KEYS = {"embed_dim", "vision_cfg", "text_cfg", "quick_gelu"}
_RESNET_KEYS = {"image_size", "layers", "width", "patch_size"}
_VIT_KEYS = {"image_size", "layers", "width", "patch_size", "head_width", "mlp_ratio", "patch_dropout",
             "attentional_pool", "attn_pooler_queries", "attn_pooler_heads", "pool_type", "final_ln_after_pool",
             "no_ln_pre", "ls_init_value", "pos_embed_type"}
_TEXT_KEYS = {"context_length", "vocab_size", "width", "heads", "layers", "mlp_ratio", "pool_type",
              "no_causal_mask", "ls_init_value"}
_TOKENIZER_KEYS = {"hf_tokenizer_name", "tokenizer_kwargs"}


def clip_cfg_from_dict(d: dict) -> CLIPCfg:
    """CLIPCfg from an open_clip JSON model config (``clip.clip_cfg_from_dict``
    with ``quick_gelu`` read from the dict, as ``factory.get_clip_cfg``
    does) for ModifiedResNet or plain ViT image towers and the plain text
    tower; raises ``NotImplementedError`` naming any other key."""
    v, t = d["vision_cfg"], d["text_cfg"]
    resnet = isinstance(v.get("layers"), (list, tuple))
    unported = ((set(d) - _KEYS) | (set(v) - (_RESNET_KEYS if resnet else _VIT_KEYS))
                | (set(t) - _TEXT_KEYS - _TOKENIZER_KEYS))
    if unported:
        raise NotImplementedError(f"unported config keys {sorted(unported)}: only ModifiedResNet and plain "
                                  "ViT image towers with the plain text tower are ported so far")
    embed_dim = d["embed_dim"]
    act = "quick_gelu" if d.get("quick_gelu") else "gelu"
    if resnet:
        width = v.get("width", 64)
        vision = ResNetCfg(
            layers=tuple(v["layers"]),
            width=width,
            output_dim=embed_dim,
            heads=width * 32 // 64,  # open_clip's head_width 64
            image_size=v.get("image_size", 224),
        )
    else:
        vision = VisionTransformerCfg(
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
    )
    return CLIPCfg(embed_dim=embed_dim, vision=vision, text=text)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis in fp32 (``clip._l2_normalize``)."""
    x = x.float()
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp_min(eps)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPCfg):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.visual = ModifiedResNet(cfg.vision) if cfg.is_resnet else VisionTransformer(cfg.vision)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.transformer = Transformer(t.width, t.layers, t.heads, act=t.act, mlp_ratio=t.mlp_ratio,
                                       ls_init_value=t.ls_init_value, causal=not t.no_causal_mask)
        self.ln_final = nn.LayerNorm(t.width)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    normalize = staticmethod(l2_normalize)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the JAX init's distributions
        (``resnet_init`` or ``vit_init``, ``text_init``). The numbers differ
        from JAX's for the same seed: tests carry JAX weights over with
        ``core.checkpoint.state_dict_from_jax_params`` instead."""
        t = self.cfg.text
        self.visual.init_parameters(generator)
        L.normal_(self.token_embedding.weight, 0.02, generator)
        L.normal_(self.positional_embedding, 0.01, generator)
        self.transformer.init_parameters(generator)
        L.layer_norm_init_(self.ln_final)
        L.normal_(self.text_projection, t.width ** -0.5, generator)
        self.logit_scale.fill_(self.cfg.init_logit_scale)

    def encode_image(self, images: torch.Tensor, *, normalize: bool = False,
                     dtype: Optional[torch.dtype] = None, moments: Optional[Moments] = None,
                     generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC float -> (N, embed_dim) features. In
        train mode ``moments`` receives a ResNet's new BatchNorm running
        statistics (see ``ModifiedResNet.forward``) and ``generator`` drives
        a ViT's patch dropout."""
        if self.cfg.is_resnet:
            feats = self.visual(images, dtype=dtype, moments=moments, grad_checkpointing=grad_checkpointing)
        else:
            feats = self.visual(images, dtype=dtype, generator=generator, grad_checkpointing=grad_checkpointing)
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, text_ids: torch.Tensor, *, normalize: bool = False,
                    dtype: Optional[torch.dtype] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """text_ids: (N, L) int token ids -> (N, embed_dim) fp32 features."""
        emb_dtype = dtype or self.token_embedding.weight.dtype
        ids = text_ids.long()
        x = self.token_embedding.weight[ids].to(emb_dtype)
        x = x + self.positional_embedding[: x.shape[1]].to(emb_dtype)
        x = self.transformer(x, dtype=dtype, grad_checkpointing=grad_checkpointing)
        x = L.layer_norm(x, self.ln_final)
        pool = self.cfg.text.pool_type
        if pool == "argmax":  # the EOT token has the highest id in each sequence
            pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        elif pool in ("first", "last"):
            pooled = x[:, 0 if pool == "first" else -1]
        else:
            raise ValueError(f"text pool_type {pool!r}")
        proj = self.text_projection
        if dtype is not None:
            # inputs rounded to the compute dtype, fp32 product and result
            # (jnp.dot with preferred_element_type=float32)
            pooled, proj = pooled.to(dtype), proj.to(dtype)
        feats = pooled.float() @ proj.float()
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
