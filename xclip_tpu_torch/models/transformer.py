"""Transformer towers: the text tower's blocks and the ViT image tower.

Counterpart of ``xclip_tpu/models/transformer.py`` (``block_apply``,
``get_2d_sincos_pos_embed``, ``vit_apply``; :86-134, :219-368) and of the
attentional pooler of ``xclip_tpu/models/coca.py`` (:125-135). Parameter
names are open_clip's: ``transformer.resblocks.{i}.ln_1``,
``.attn.in_proj_weight`` (packed q/k/v), ``.attn.out_proj``, ``.ln_2``,
``.mlp.c_fc``, ``.mlp.c_proj``, ``.ls_1.gamma``/``.ls_2.gamma`` (LayerScale);
the ViT adds ``conv1``, ``class_embedding``, ``positional_embedding``,
``ln_pre``, ``ln_post``, ``proj`` and ``attn_pool.*``.

- Self-attention goes through :class:`ops.flash_attention.FlashAttention`
  (the K4 kernel forward, a plain backward): causal in the text tower
  unless the config sets ``no_causal_mask``, never in the ViT. No additive
  mask is built.
- The attentional pooler's 256 queries attend to L keys, and K4 needs
  Lq = Lk, so it uses ``layers.attention`` as the RN attnpool does.
- With ``grad_checkpointing`` each block is recomputed in the backward
  (``jax.checkpoint`` per block, transformer.py:194-199); the patch
  embedding and patch dropout stay outside the recomputed blocks.
- Patch dropout (train mode only) draws from an explicit
  ``torch.Generator`` and raises without one, as JAX raises without an
  rng: ``torch.utils.checkpoint`` restores only the global RNG state, so a
  draw inside a recomputed region would pick other tokens.
- A ``sin_cos_2d`` positional embedding is a parameter with
  ``requires_grad=False``, as the reference creates it (the JAX trainer
  zeroes its update with ``optim.sincos_freeze_mask``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
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
    mlp_ratio: float = 4.0
    output_dim: int = 512
    act: str = "gelu"
    pool_type: str = "argmax"
    no_causal_mask: bool = False
    ls_init_value: Optional[float] = None
    # SigLIP text towers: an nn.Linear projection with bias, and the
    # LayerNorms' eps from the config's norm_kwargs
    proj_bias: bool = False
    norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class VisionTransformerCfg:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    output_dim: int = 512
    act: str = "gelu"
    pool_type: str = "tok"  # or "avg"
    final_ln_after_pool: bool = False
    no_ln_pre: bool = False  # CLIPA towers skip the pre-LN
    ls_init_value: Optional[float] = None  # LayerScale init (None = off)
    patch_dropout: float = 0.0  # fraction of patch tokens dropped in training
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    pos_embed_type: str = "learnable"  # or "sin_cos_2d" (fixed)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


class SelfAttention(nn.Module):
    """Packed-projection self-attention with ``nn.MultiheadAttention``'s
    parameter names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype]) -> torch.Tensor:
        b, seq_len, d = x.shape
        qkv = L.linear(x, self.in_proj_weight, self.in_proj_bias, dtype=dtype)
        # (B, L, 3, H, hd) -> three contiguous (B, H, L, hd)
        qkv = qkv.view(b, seq_len, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))
        o = FlashAttention.apply(q, k, v, self.causal)
        o = o.transpose(1, 2).reshape(b, seq_len, d)
        return L.linear(o, self.out_proj.weight, self.out_proj.bias, dtype=dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str, *, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, causal: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        mlp_width = int(width * mlp_ratio)
        self.act = act
        self.ls_init_value = ls_init_value
        self.ln_1 = nn.LayerNorm(width, eps=ln_eps)
        self.attn = SelfAttention(width, heads, causal)
        self.ls_1 = L.LayerScale(width) if ls_init_value is not None else nn.Identity()
        self.ln_2 = nn.LayerNorm(width, eps=ln_eps)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, mlp_width)),
            ("c_proj", nn.Linear(mlp_width, width)),
        ]))
        self.ls_2 = L.LayerScale(width) if ls_init_value is not None else nn.Identity()

    def init_parameters(self, generator: torch.Generator, layers: int) -> None:
        """Distributions of ``transformer.block_init``."""
        width = self.ln_1.normalized_shape[0]
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        fc_std = (2 * width) ** -0.5
        for ln in (self.ln_1, self.ln_2):
            L.layer_norm_init_(ln)
        L.normal_(self.attn.in_proj_weight, width ** -0.5, generator)
        self.attn.in_proj_bias.zero_()
        L.normal_(self.attn.out_proj.weight, proj_std, generator)
        self.attn.out_proj.bias.zero_()
        L.normal_(self.mlp.c_fc.weight, fc_std, generator)
        self.mlp.c_fc.bias.zero_()
        L.normal_(self.mlp.c_proj.weight, proj_std, generator)
        self.mlp.c_proj.bias.zero_()
        if self.ls_init_value is not None:
            self.ls_1.gamma.fill_(self.ls_init_value)
            self.ls_2.gamma.fill_(self.ls_init_value)

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype]) -> torch.Tensor:
        x = x + self.ls_1(self.attn(L.layer_norm(x, self.ln_1), dtype=dtype))
        y = L.layer_norm(x, self.ln_2)
        y = L.linear(y, self.mlp.c_fc.weight, self.mlp.c_fc.bias, dtype=dtype)
        y = L.ACT_FNS[self.act](y)
        y = L.linear(y, self.mlp.c_proj.weight, self.mlp.c_proj.bias, dtype=dtype)
        return x + self.ls_2(y)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, *, act: str, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, causal: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act, mlp_ratio=mlp_ratio, ls_init_value=ls_init_value,
                                   causal=causal, ln_eps=ln_eps)
            for _ in range(layers))

    def init_parameters(self, generator: torch.Generator) -> None:
        for block in self.resblocks:
            block.init_parameters(generator, len(self.resblocks))

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype],
                grad_checkpointing: bool = False) -> torch.Tensor:
        remat = grad_checkpointing and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x = _checkpoint(block, x, dtype=dtype, use_reentrant=False)
            else:
                x = block(x, dtype=dtype)
        return x


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """Fixed 2D sine-cosine positional embedding (MoCo v3), as
    ``transformer.get_2d_sincos_pos_embed``: the first half of the channels
    encodes the row coordinate, the second half the column, each as
    [sin | cos] over a 10000^(2i/d) frequency ladder; an all-zeros class
    row is prepended with ``cls_token``. float32, (grid^2 [+ 1], embed_dim)."""
    assert embed_dim % 4 == 0, embed_dim
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_h, grid_h), axis=0)  # w first, then h

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=float) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([_1d(embed_dim // 2, grid[0]), _1d(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb.astype(np.float32)


def patch_dropout(tokens: torch.Tensor, prob: float, generator: torch.Generator) -> torch.Tensor:
    """Keep the class token and ``max(1, int(n * (1 - prob)))`` of the n patch
    tokens of each sample: those with the largest of n standard normal
    scores drawn from ``generator``, in descending score order (JAX's
    ``argsort(-scores)[:, :n_keep]``)."""
    cls_tok, patches = tokens[:, :1], tokens[:, 1:]
    b, n, width = patches.shape
    n_keep = max(1, int(n * (1.0 - prob)))
    scores = torch.randn(b, n, generator=generator, device=generator.device).to(tokens.device)
    keep = scores.topk(n_keep, dim=-1).indices
    patches = torch.gather(patches, 1, keep.unsqueeze(-1).expand(b, n_keep, width))
    return torch.cat([cls_tok, patches], dim=1)


class AttentionalPooler(nn.Module):
    """``n_queries`` learned queries attending to the tokens (open_clip's
    ``AttentionalPooler``, names of its ``nn.MultiheadAttention``: one packed
    ``in_proj_weight`` when the key width equals ``d_model``, else separate
    ``q_proj_weight``/``k_proj_weight``/``v_proj_weight``)."""

    def __init__(self, d_model: int, context_dim: int, heads: int, n_queries: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.attn = nn.Module()
        if context_dim == d_model:
            self.attn.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        else:
            self.attn.q_proj_weight = nn.Parameter(torch.empty(d_model, d_model))
            self.attn.k_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
            self.attn.v_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.attn.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.attn.out_proj = nn.Linear(d_model, d_model)
        self.ln_q = nn.LayerNorm(d_model)
        self.ln_k = nn.LayerNorm(context_dim)

    def _qkv_weights(self):
        a = self.attn
        if hasattr(a, "in_proj_weight"):
            return a.in_proj_weight.chunk(3)
        return a.q_proj_weight, a.k_proj_weight, a.v_proj_weight

    def init_parameters(self, generator: torch.Generator) -> None:
        """Distributions of ``coca.attn_pooler_init``: standard normal
        queries, torch's default uniform linears, zero biases."""
        L.normal_(self.query, 1.0, generator)
        for w in self._qkv_weights() + (self.attn.out_proj.weight,):
            L.uniform_(w, w.shape[1] ** -0.5, generator)
        self.attn.in_proj_bias.zero_()
        self.attn.out_proj.bias.zero_()
        L.layer_norm_init_(self.ln_q)
        L.layer_norm_init_(self.ln_k)

    def forward(self, x: torch.Tensor, *, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """x: (B, L, context_dim) -> (B, n_queries, d_model)."""
        keys = L.layer_norm(x, self.ln_k)
        q_in = L.layer_norm(self.query.to(x.dtype), self.ln_q).expand(x.shape[0], -1, -1)
        (wq, wk, wv), (bq, bk, bv) = self._qkv_weights(), self.attn.in_proj_bias.chunk(3)
        q = L.linear(q_in, wq, bq, dtype=dtype)
        k = L.linear(keys, wk, bk, dtype=dtype)
        v = L.linear(keys, wv, bv, dtype=dtype)
        o = L.attention(q, k, v, num_heads=self.heads)
        return L.linear(o, self.attn.out_proj.weight, self.attn.out_proj.bias, dtype=dtype)


class VisionTransformer(nn.Module):
    """The ViT image tower (``transformer.vit_init``/``vit_apply``)."""

    def __init__(self, cfg: VisionTransformerCfg):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        pool_dim = cfg.output_dim if cfg.attentional_pool else w
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, w),
                                                 requires_grad=cfg.pos_embed_type != "sin_cos_2d")
        if not cfg.no_ln_pre:
            self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.layers, cfg.heads, act=cfg.act, mlp_ratio=cfg.mlp_ratio,
                                       ls_init_value=cfg.ls_init_value)
        if cfg.attentional_pool:
            self.attn_pool = AttentionalPooler(cfg.output_dim, w, cfg.attn_pooler_heads, cfg.attn_pooler_queries)
        self.ln_post = nn.LayerNorm(pool_dim)
        self.proj = nn.Parameter(torch.empty(pool_dim, cfg.output_dim))

    def init_parameters(self, generator: torch.Generator) -> None:
        """Distributions of ``transformer.vit_init``."""
        cfg = self.cfg
        scale = cfg.width ** -0.5
        L.conv_init_(self.conv1, generator)
        L.normal_(self.class_embedding, scale, generator)
        if cfg.pos_embed_type == "learnable":
            L.normal_(self.positional_embedding, scale, generator)
        elif cfg.pos_embed_type == "sin_cos_2d":
            self.positional_embedding.copy_(torch.from_numpy(
                get_2d_sincos_pos_embed(cfg.width, cfg.grid, cls_token=True)))
        else:
            raise ValueError(f"pos_embed_type {cfg.pos_embed_type!r}")
        L.normal_(self.proj, scale, generator)
        L.layer_norm_init_(self.ln_post)
        if not cfg.no_ln_pre:
            L.layer_norm_init_(self.ln_pre)
        if cfg.attentional_pool:
            self.attn_pool.init_parameters(generator)
        self.transformer.init_parameters(generator)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.pool_type == "tok":
            return x[:, 0]
        return x[:, 1:].float().mean(dim=1).to(x.dtype)  # "avg": fp32 mean, as jnp.mean

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC -> (N, output_dim) fp32. In train mode
        with ``patch_dropout > 0`` the kept patches are drawn from
        ``generator``."""
        cfg = self.cfg
        x = images.permute(0, 3, 1, 2)
        if dtype is not None:
            x = x.to(dtype)
        x = L.conv2d(x, self.conv1.weight, stride=cfg.patch_size)  # (N, W, grid, grid)
        tokens = x.flatten(2).transpose(1, 2)  # row-major patches, as JAX's NHWC reshape
        cls = self.class_embedding.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.positional_embedding.to(tokens.dtype)
        if self.training and cfg.patch_dropout > 0.0:
            if generator is None:
                raise ValueError("patch_dropout > 0 in train mode needs a torch.Generator (generator=...)")
            tokens = patch_dropout(tokens, cfg.patch_dropout, generator)
        x = tokens if cfg.no_ln_pre else L.layer_norm(tokens, self.ln_pre)
        x = self.transformer(x, dtype=dtype, grad_checkpointing=grad_checkpointing)
        if cfg.attentional_pool:
            pooled = self._pool(L.layer_norm(self.attn_pool(x, dtype=dtype), self.ln_post))
        elif cfg.final_ln_after_pool:
            pooled = L.layer_norm(self._pool(x), self.ln_post)
        else:
            pooled = self._pool(L.layer_norm(x, self.ln_post))
        proj = self.proj if dtype is None else self.proj.to(dtype)
        # inputs rounded to the compute dtype, fp32 product and result
        return pooled.to(proj.dtype).float() @ proj.float()
