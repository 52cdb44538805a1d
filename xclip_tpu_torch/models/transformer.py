"""Text transformer tower: pre-LN residual blocks with causal self-attention.

Counterpart of the text half of ``xclip_tpu/models/transformer.py``
(``block_apply`` and ``text_apply``, :115-134 and :411-450). Parameter names
are open_clip's: ``transformer.resblocks.{i}.ln_1``, ``.attn.in_proj_weight``
(packed q/k/v), ``.attn.out_proj``, ``.ln_2``, ``.mlp.c_fc``, ``.mlp.c_proj``.
Self-attention is causal and goes through
:class:`ops.flash_attention.FlashAttention` (the K4 kernel forward, a plain
backward) with the causal flag, so no additive mask is built; pooling takes
the EOT (argmax) token. With ``grad_checkpointing`` each block is
recomputed in the backward (``jax.checkpoint`` per block,
transformer.py:194-199). The ViT towers come with a later slice.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.ops.flash_attention import FlashAttention


@dataclasses.dataclass(frozen=True)
class TextTransformerCfg:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    output_dim: int = 512
    act: str = "gelu"


class SelfAttention(nn.Module):
    """Packed-projection self-attention with ``nn.MultiheadAttention``'s
    parameter names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype]) -> torch.Tensor:
        b, seq_len, d = x.shape
        qkv = L.linear(x, self.in_proj_weight, self.in_proj_bias, dtype=dtype)
        # (B, L, 3, H, hd) -> three contiguous (B, H, L, hd)
        qkv = qkv.view(b, seq_len, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))
        o = FlashAttention.apply(q, k, v, True)
        o = o.transpose(1, 2).reshape(b, seq_len, d)
        return L.linear(o, self.out_proj.weight, self.out_proj.bias, dtype=dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        mlp_width = 4 * width
        self.act = act
        self.ln_1 = nn.LayerNorm(width)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, mlp_width)),
            ("c_proj", nn.Linear(mlp_width, width)),
        ]))

    def init_parameters(self, generator: torch.Generator, layers: int) -> None:
        """Distributions of ``transformer.block_init``."""
        width = self.ln_1.normalized_shape[0]
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        fc_std = (2 * width) ** -0.5
        for ln in (self.ln_1, self.ln_2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        L.normal_(self.attn.in_proj_weight, width ** -0.5, generator)
        self.attn.in_proj_bias.zero_()
        L.normal_(self.attn.out_proj.weight, proj_std, generator)
        self.attn.out_proj.bias.zero_()
        L.normal_(self.mlp.c_fc.weight, fc_std, generator)
        self.mlp.c_fc.bias.zero_()
        L.normal_(self.mlp.c_proj.weight, proj_std, generator)
        self.mlp.c_proj.bias.zero_()

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype]) -> torch.Tensor:
        x = x + self.attn(L.layer_norm(x, self.ln_1), dtype=dtype)
        y = L.layer_norm(x, self.ln_2)
        y = L.linear(y, self.mlp.c_fc.weight, self.mlp.c_fc.bias, dtype=dtype)
        y = L.ACT_FNS[self.act](y)
        y = L.linear(y, self.mlp.c_proj.weight, self.mlp.c_proj.bias, dtype=dtype)
        return x + y


class Transformer(nn.Module):
    def __init__(self, cfg: TextTransformerCfg):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, cfg.act)
            for _ in range(cfg.layers))

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype],
                grad_checkpointing: bool = False) -> torch.Tensor:
        remat = grad_checkpointing and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x = _checkpoint(block, x, dtype=dtype, use_reentrant=False)
            else:
                x = block(x, dtype=dtype)
        return x

