"""CLIP bundle: ModifiedResNet image tower + text tower + logit scale.

Counterpart of ``xclip_tpu/models/clip.py`` (``CLIPModel.encode_image``,
``encode_text``, ``_l2_normalize``; :211-267) as one ``nn.Module`` whose
state-dict names are open_clip's CLIP (``visual.*``, ``token_embedding``,
``positional_embedding``, ``transformer.*``, ``ln_final``,
``text_projection``, ``logit_scale``), so an open_clip ``.pt`` loads with
``load_state_dict``. Only ResNet image towers and the plain text tower are
ported so far. :meth:`CLIP.forward` is the contrastive training forward
(``CLIPModel.forward``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models.resnet import ModifiedResNet, Moments, ResNetCfg
from xclip_tpu_torch.models.transformer import TextTransformerCfg, Transformer


@dataclasses.dataclass(frozen=True)
class CLIPCfg:
    embed_dim: int
    vision: ResNetCfg
    text: TextTransformerCfg
    init_logit_scale: float = math.log(1 / 0.07)

    @property
    def image_size(self) -> int:
        return self.vision.image_size


# open_clip config keys this slice reads; configs with others (ViT/timm
# towers, HF text, SigLIP, LayerScale, ...) belong to later slices
_KEYS = {"embed_dim", "vision_cfg", "text_cfg", "quick_gelu"}
_VISION_KEYS = {"image_size", "layers", "width", "patch_size"}
_TEXT_KEYS = {"context_length", "vocab_size", "width", "heads", "layers"}


def clip_cfg_from_dict(d: dict) -> CLIPCfg:
    """CLIPCfg from an open_clip JSON model config (``clip.clip_cfg_from_dict``)
    for ModifiedResNet + plain text tower configs; raises on any other."""
    v, t = d["vision_cfg"], d["text_cfg"]
    unported = (set(d) - _KEYS) | (set(v) - _VISION_KEYS) | (set(t) - _TEXT_KEYS)
    if unported or not isinstance(v.get("layers"), (list, tuple)):
        raise NotImplementedError(
            "only ModifiedResNet + plain text tower configs are ported so far"
            + (f"; unported keys: {sorted(unported)}" if unported else "; this is a ViT config"))
    embed_dim = d["embed_dim"]
    width = v.get("width", 64)
    vision = ResNetCfg(
        layers=tuple(v["layers"]),
        width=width,
        output_dim=embed_dim,
        heads=width * 32 // 64,  # open_clip's head_width 64
        image_size=v.get("image_size", 224),
    )
    text = TextTransformerCfg(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512),
        heads=t.get("heads", 8),
        layers=t.get("layers", 12),
        output_dim=embed_dim,
        act="quick_gelu" if d.get("quick_gelu") else "gelu",
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
        self.visual = ModifiedResNet(cfg.vision)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.transformer = Transformer(t)
        self.ln_final = nn.LayerNorm(t.width)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    normalize = staticmethod(l2_normalize)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the JAX init's distributions
        (``resnet_init``, ``text_init``). The numbers differ from JAX's for
        the same seed: tests carry JAX weights over with
        ``core.checkpoint.state_dict_from_jax_params`` instead."""
        t = self.cfg.text
        self.visual.init_parameters(generator)
        L.normal_(self.token_embedding.weight, 0.02, generator)
        L.normal_(self.positional_embedding, 0.01, generator)
        for block in self.transformer.resblocks:
            block.init_parameters(generator, t.layers)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        L.normal_(self.text_projection, t.width ** -0.5, generator)
        self.logit_scale.fill_(self.cfg.init_logit_scale)

    def encode_image(self, images: torch.Tensor, *, normalize: bool = False,
                     dtype: Optional[torch.dtype] = None, moments: Optional[Moments] = None,
                     grad_checkpointing: bool = False) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC float -> (N, embed_dim) features. In
        train mode ``moments`` receives the new BatchNorm running statistics
        (see ``ModifiedResNet.forward``)."""
        feats = self.visual(images, dtype=dtype, moments=moments, grad_checkpointing=grad_checkpointing)
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
        # argmax pooling: the EOT token has the highest id in each sequence
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        proj = self.text_projection
        if dtype is not None:
            # inputs rounded to the compute dtype, fp32 product and result
            # (jnp.dot with preferred_element_type=float32)
            pooled, proj = pooled.to(dtype), proj.to(dtype)
        feats = pooled.float() @ proj.float()
        return l2_normalize(feats) if normalize else feats

    def forward(self, images: torch.Tensor, texts: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                moments: Optional[Moments] = None,
                grad_checkpointing: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Contrastive forward -> (normalized fp32 image features, normalized
        fp32 text features, ``logit_scale.exp()``)."""
        img = self.encode_image(images, normalize=True, dtype=dtype, moments=moments,
                                grad_checkpointing=grad_checkpointing)
        txt = self.encode_text(texts, normalize=True, dtype=dtype, grad_checkpointing=grad_checkpointing)
        return img, txt, self.logit_scale.exp()
