"""EVA image towers: the EVA01 and EVA02 configs.

Counterpart of ``xclip_tpu/models/eva.py`` (VARIANTS :50-67, RoPE :125-162,
attention :230-247, SwiGLU MLP :250-260, blocks :262-277, apply :283-335,
bridge :341-425), with open_clip's ``TimmModel`` state-dict names
(``visual.trunk.*``; the EVA configs pool the class token and have no
open_clip head: ``trunk.head`` is the CLIP projection):

- EVA01 (``eva_giant_patch14_224``): pre-LN ViT, fused ``attn.qkv`` without
  bias plus ``attn.q_bias`` and ``attn.v_bias`` (the k bias is zero), GELU
  MLP;
- EVA02 (``eva02_{base,large}_patch1x_clip_*``): separate ``q_proj``,
  ``k_proj`` (no bias) and ``v_proj``, 2D axial rotary embeddings on the
  patch tokens of q and k (never the class token; positions rescaled to
  ``ref_grid``), and the SwiGLU MLP with an inner LayerNorm
  (``mlp.fc1_g``, ``fc1_x``, ``norm``, ``fc2``; hidden ``int(width * 8/3)``);
- EVA02-E (``eva02_enormous_patch14_clip_224``): fused qkv, GELU MLP and
  post-norm blocks (each sublayer's output normed before the residual).

Self-attention goes through K4 (:class:`ops.flash_attention.FlashAttention`),
non-causal; RoPE is applied in (B, L, H, Dh) layout before the contiguous
(B, H, L, Dh) split. The pooled class token goes through ``trunk.head`` in
fp32, as JAX does. The RoPE tables are built with numpy in float64 and
cached per grid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models import tower_common as C
from xclip_tpu_torch.ops.flash_attention import FlashAttention

LN_EPS = 1e-6

# timm Eva variant table
VARIANTS = {
    "eva_giant_patch14_224": dict(
        patch_size=14, width=1408, layers=40, heads=16, mlp_ratio=6144 / 1408,
        qkv_fused=True, swiglu=False, rope=False),
    "eva02_base_patch16_clip_224": dict(
        patch_size=16, width=768, layers=12, heads=12, mlp_ratio=4 * 2 / 3,
        qkv_fused=False, swiglu=True, rope=True, ref_grid=16),
    "eva02_large_patch14_clip_224": dict(
        patch_size=14, width=1024, layers=24, heads=16, mlp_ratio=4 * 2 / 3,
        qkv_fused=False, swiglu=True, rope=True, ref_grid=16),
    "eva02_large_patch14_clip_336": dict(
        patch_size=14, width=1024, layers=24, heads=16, mlp_ratio=4 * 2 / 3,
        qkv_fused=False, swiglu=True, rope=True, ref_grid=16),
    "eva02_enormous_patch14_clip_224": dict(
        patch_size=14, width=1792, layers=64, heads=16, mlp_ratio=15360 / 1792,
        qkv_fused=True, swiglu=False, rope=False, post_norm=True),
}


@dataclasses.dataclass(frozen=True)
class EvaCfg:
    timm_name: str
    output_dim: int
    image_size: int = 224
    patch_size: int = 14
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    qkv_fused: bool = True
    swiglu: bool = False
    rope: bool = False
    ref_grid: int = 16  # RoPE's reference grid side (timm ref_feat_shape)
    post_norm: bool = False
    init_values: Optional[float] = None

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # the class token

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def patch_dropout(self) -> float:
        return 0.0


def cfg_from_vision_dict(v: dict, embed_dim: int) -> EvaCfg:
    name = v["timm_model_name"]
    return EvaCfg(timm_name=name, output_dim=embed_dim, image_size=v.get("image_size", 224), **VARIANTS[name])


def stage_names(cfg: EvaCfg) -> List[str]:
    return ["embed"] + [f"blocks.{i}" for i in range(cfg.layers)] + ["pool"]


@functools.lru_cache(maxsize=8)
def rope_tables(grid: int, ref_grid: int, head_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos), each (grid^2, head_dim) float32, of the 2D axial RoPE
    (``eva._rope_tables``): head_dim / 4 frequency bands per axis, rows
    then columns, each band's angle on an adjacent pair of channels."""
    n_bands = head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (np.arange(n_bands, dtype=np.float64) / n_bands))
    pos = (np.arange(grid, dtype=np.float64) / max(grid, 1)) * ref_grid
    ang = np.outer(pos, inv_freq)  # (grid, n_bands)
    yy, xx = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    angles = np.repeat(np.concatenate([ang[yy.reshape(-1)], ang[xx.reshape(-1)]], axis=-1), 2, axis=-1)
    return np.sin(angles).astype(np.float32), np.cos(angles).astype(np.float32)


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(-x2, x1, -x4, x3, ...) over the last axis (timm's ``rot``)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rope(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate the patch tokens of t (B, 1 + N, H, Dh) in t's dtype; the
    class token passes unrotated. sin, cos: (N, Dh)."""
    sin, cos = sin.to(t.dtype)[None, :, None, :], cos.to(t.dtype)[None, :, None, :]
    tok = t[:, 1:]
    return torch.cat([t[:, :1], tok * cos + rotate_pairs(tok) * sin], dim=1)


class Attention(nn.Module):
    def __init__(self, cfg: EvaCfg):
        super().__init__()
        d = cfg.width
        self.cfg = cfg
        if cfg.qkv_fused:
            self.qkv = nn.Linear(d, 3 * d, bias=False)
            self.q_bias = nn.Parameter(torch.empty(d))
            self.v_bias = nn.Parameter(torch.empty(d))
        else:
            self.q_proj = nn.Linear(d, d)
            self.k_proj = nn.Linear(d, d, bias=False)
            self.v_proj = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)

    def init_parameters(self, generator: torch.Generator) -> None:
        if self.cfg.qkv_fused:
            C.trunc_normal_(self.qkv.weight, generator)
            self.q_bias.zero_()
            self.v_bias.zero_()
        else:
            for lin in (self.q_proj, self.k_proj, self.v_proj):
                C.linear_init_(lin, generator)
        C.linear_init_(self.proj, generator)

    def forward(self, x: torch.Tensor, rope, dtype: Optional[torch.dtype]) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        if cfg.qkv_fused:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = L.linear(x, self.qkv.weight, bias, dtype=dtype)
            q, k, v = qkv.view(b, s, 3, cfg.heads, cfg.head_dim).unbind(2)
        else:
            q, k, v = (L.linear(x, lin.weight, lin.bias, dtype=dtype).view(b, s, cfg.heads, cfg.head_dim)
                       for lin in (self.q_proj, self.k_proj, self.v_proj))
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        o = FlashAttention.apply(q, k, v, False).transpose(1, 2).reshape(b, s, d)
        return L.linear(o, self.proj.weight, self.proj.bias, dtype=dtype)


class Mlp(nn.Module):
    """GELU MLP (``fc1``, ``fc2``) or SwiGLU (``fc1_g``, ``fc1_x``, ``norm``, ``fc2``)."""

    def __init__(self, cfg: EvaCfg):
        super().__init__()
        self.swiglu = cfg.swiglu
        d, h = cfg.width, cfg.mlp_hidden
        if cfg.swiglu:
            self.fc1_g = nn.Linear(d, h)
            self.fc1_x = nn.Linear(d, h)
            self.norm = nn.LayerNorm(h, eps=LN_EPS)
        else:
            self.fc1 = nn.Linear(d, h)
        self.fc2 = nn.Linear(h, d)

    def init_parameters(self, generator: torch.Generator) -> None:
        for lin in ((self.fc1_g, self.fc1_x) if self.swiglu else (self.fc1,)) + (self.fc2,):
            C.linear_init_(lin, generator)
        if self.swiglu:
            L.layer_norm_init_(self.norm)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        if self.swiglu:
            g = L.linear(x, self.fc1_g.weight, self.fc1_g.bias, dtype=dtype)
            y = torch.nn.functional.silu(g) * L.linear(x, self.fc1_x.weight, self.fc1_x.bias, dtype=dtype)
            y = L.layer_norm(y, self.norm)
        else:
            y = L.gelu(L.linear(x, self.fc1.weight, self.fc1.bias, dtype=dtype))
        return L.linear(y, self.fc2.weight, self.fc2.bias, dtype=dtype)


class Block(nn.Module):
    def __init__(self, cfg: EvaCfg):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.mlp = Mlp(cfg)
        if cfg.init_values is not None:
            self.gamma_1 = nn.Parameter(torch.empty(cfg.width))
            self.gamma_2 = nn.Parameter(torch.empty(cfg.width))

    def init_parameters(self, generator: torch.Generator) -> None:
        L.layer_norm_init_(self.norm1)
        L.layer_norm_init_(self.norm2)
        self.attn.init_parameters(generator)
        self.mlp.init_parameters(generator)
        if self.cfg.init_values is not None:
            self.gamma_1.fill_(self.cfg.init_values)
            self.gamma_2.fill_(self.cfg.init_values)

    def _gamma(self, name: str, y: torch.Tensor) -> torch.Tensor:
        return y * getattr(self, name).to(y.dtype) if self.cfg.init_values is not None else y

    def forward(self, x: torch.Tensor, rope, dtype: Optional[torch.dtype]) -> torch.Tensor:
        if self.cfg.post_norm:  # the normed sublayer output joins the residual
            x = x + self._gamma("gamma_1", L.layer_norm(self.attn(x, rope, dtype), self.norm1))
            return x + self._gamma("gamma_2", L.layer_norm(self.mlp(x, dtype), self.norm2))
        x = x + self._gamma("gamma_1", self.attn(L.layer_norm(x, self.norm1), rope, dtype))
        return x + self._gamma("gamma_2", self.mlp(L.layer_norm(x, self.norm2), dtype))


class Eva(nn.Module):
    """``visual`` of an EVA CLIP: ``trunk`` only."""

    def __init__(self, cfg: EvaCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        t = self.trunk = nn.Module()
        t.patch_embed = nn.Module()
        t.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        t.cls_token = nn.Parameter(torch.empty(1, 1, d))
        t.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, d))
        t.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        t.norm = nn.LayerNorm(d, eps=LN_EPS)
        t.head = nn.Linear(d, cfg.output_dim)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Distributions of ``eva_init``."""
        t = self.trunk
        C.trunc_normal_(t.patch_embed.proj.weight, generator)
        t.patch_embed.proj.bias.zero_()
        t.cls_token.zero_()
        C.trunc_normal_(t.pos_embed, generator)
        for block in t.blocks:
            block.init_parameters(generator)
        L.layer_norm_init_(t.norm)
        C.linear_init_(t.head, generator)

    def stage_names(self) -> List[str]:
        return stage_names(self.cfg)

    def run(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None,
            capture: Optional[Sequence[str]] = None, grad_checkpointing: bool = False):
        """NHWC images -> ``(features (B, output_dim) fp32, {stage: tokens})``
        for the stage names in ``capture`` (``eva_apply``)."""
        cfg, t = self.cfg, self.trunk
        capture = set(capture or ())
        inters: Dict[str, torch.Tensor] = {}
        p = t.patch_embed.proj
        tokens = L.conv2d_nhwc(images, p.weight, p.bias, stride=cfg.patch_size, dtype=dtype).flatten(1, 2)
        cls = t.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        x = torch.cat([cls, tokens], dim=1) + t.pos_embed.to(tokens.dtype)
        if "embed" in capture:
            inters["embed"] = x
        rope = None
        if cfg.rope:
            rope = tuple(torch.from_numpy(a).to(x.device)
                         for a in rope_tables(cfg.grid, cfg.ref_grid, cfg.head_dim))
        remat = grad_checkpointing and torch.is_grad_enabled()
        for i, block in enumerate(t.blocks):
            x = _checkpoint(block, x, rope, dtype, use_reentrant=False) if remat else block(x, rope, dtype)
            if f"blocks.{i}" in capture:
                inters[f"blocks.{i}"] = x
        pooled = L.layer_norm(x, t.norm)[:, 0].float()  # timm_pool 'token'
        out = L.linear(pooled, t.head.weight, t.head.bias)  # fp32: the trunk's classifier is the projection
        if "pool" in capture:
            inters["pool"] = out
        return out, inters

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        return self.run(images, dtype, grad_checkpointing=grad_checkpointing)[0]


# -- the JAX pytree bridge (open_clip TimmModel naming, without "visual.") --


def params_to_state_dict(params: Mapping, cfg: EvaCfg) -> Dict[str, torch.Tensor]:
    """``eva_params_to_state_dict`` with PyTorch tensors."""
    sd: Dict[str, torch.Tensor] = {}
    C.write_conv(sd, "trunk.patch_embed.proj", params["patch_embed"])
    sd["trunk.cls_token"] = C.tensor(np.asarray(params["cls_token"])[None, None])
    sd["trunk.pos_embed"] = C.tensor(np.asarray(params["pos_embed"])[None])
    for i, bp in enumerate(params["blocks"]):
        base = f"trunk.blocks.{i}"
        C.write_ln(sd, f"{base}.norm1", bp["norm1"])
        a = bp["attn"]
        if cfg.qkv_fused:
            C.write_linear(sd, f"{base}.attn.qkv", a["qkv"])
            sd[f"{base}.attn.q_bias"] = C.tensor(a["q_bias"])
            sd[f"{base}.attn.v_bias"] = C.tensor(a["v_bias"])
        else:
            for n in ("q_proj", "k_proj", "v_proj"):
                C.write_linear(sd, f"{base}.attn.{n}", a[n])
        C.write_linear(sd, f"{base}.attn.proj", a["proj"])
        C.write_ln(sd, f"{base}.norm2", bp["norm2"])
        for n in ("fc1_g", "fc1_x", "fc2") if cfg.swiglu else ("fc1", "fc2"):
            C.write_linear(sd, f"{base}.mlp.{n}", bp["mlp"][n])
        if cfg.swiglu:
            C.write_ln(sd, f"{base}.mlp.norm", bp["mlp"]["norm"])
        for g in ("gamma_1", "gamma_2"):
            if g in bp:
                sd[f"{base}.{g}"] = C.tensor(bp[g])
    C.write_ln(sd, "trunk.norm", params["norm"])
    C.write_linear(sd, "trunk.head", params["head"])
    return sd


def state_dict_to_params(sd: Mapping, cfg: EvaCfg) -> Dict:
    """``eva_state_dict_to_params`` with numpy leaves."""
    params: Dict = {"patch_embed": C.read_conv(sd, "trunk.patch_embed.proj"),
                    "cls_token": C.array(sd["trunk.cls_token"]).reshape(-1),
                    "pos_embed": C.array(sd["trunk.pos_embed"])[0],
                    "blocks": [], "norm": C.read_ln(sd, "trunk.norm"), "head": C.read_linear(sd, "trunk.head")}
    for i in range(cfg.layers):
        base = f"trunk.blocks.{i}"
        if cfg.qkv_fused:
            attn = {"qkv": C.read_linear(sd, f"{base}.attn.qkv"), "q_bias": C.array(sd[f"{base}.attn.q_bias"]),
                    "v_bias": C.array(sd[f"{base}.attn.v_bias"])}
        else:
            attn = {n: C.read_linear(sd, f"{base}.attn.{n}") for n in ("q_proj", "k_proj", "v_proj")}
        attn["proj"] = C.read_linear(sd, f"{base}.attn.proj")
        mlp = {n: C.read_linear(sd, f"{base}.mlp.{n}") for n in (("fc1_g", "fc1_x", "fc2") if cfg.swiglu
                                                               else ("fc1", "fc2"))}
        if cfg.swiglu:
            mlp["norm"] = C.read_ln(sd, f"{base}.mlp.norm")
        blk: Dict = {"norm1": C.read_ln(sd, f"{base}.norm1"), "attn": attn, "norm2": C.read_ln(sd, f"{base}.norm2"),
                     "mlp": mlp}
        for g in ("gamma_1", "gamma_2"):
            if f"{base}.{g}" in sd:
                blk[g] = C.array(sd[f"{base}.{g}"])
        params["blocks"].append(blk)
    return params
