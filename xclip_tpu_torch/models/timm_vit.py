"""timm ViT image towers: the SigLIP towers and the gap / relpos medium ViTs.

Counterpart of ``xclip_tpu/models/timm_vit.py`` (VARIANTS :51-70, cfg
:118-134, relpos :141-183, block :255-273, MAP pool :276-292, bridge
:371-466), with open_clip's ``TimmModel`` state-dict names
(``visual.trunk.*``, ``visual.head.*``):

- ``trunk.patch_embed.proj`` (conv with bias), an optional
  ``trunk.cls_token``, and ``trunk.pos_embed`` unless the tower uses
  per-block relative-position biases (``vit_relpos``: timm ``RelPosMlp``,
  mode 'cr', ``attn.rel_pos.mlp.fc1``/``fc2``);
- pre-LN blocks (eps 1e-6): ``norm1``, fused ``attn.qkv`` (bias optional),
  ``attn.proj``, LayerScale ``ls1.gamma``; ``norm2``, ``mlp.fc1``, GELU,
  ``mlp.fc2``, ``ls2.gamma``;
- ``trunk.norm``, then the pool: ``map`` (SigLIP: timm's
  ``AttentionPoolLatent``, one latent query, ``trunk.attn_pool.*``),
  ``avg`` (fp32 mean over the patch tokens) or ``token``; then open_clip's
  head, if any, in fp32.

Self-attention goes through K4, non-causal. Two attentions stay in plain
PyTorch, as JAX computes them outside any Pallas kernel (the einsum path of
``layers.attention``): relpos attention, whose additive bias K4 does not
take, and the MAP pool's latent query, where Lq = 1 differs from Lk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models import tower_common as C
from xclip_tpu_torch.ops.flash_attention import FlashAttention

LN_EPS = 1e-6

# timm variant table (patch, width, depth, heads, mlp_ratio, pool overrides)
VARIANTS = {
    "vit_base_patch16_siglip_224": dict(patch_size=16, width=768, layers=12, heads=12),
    "vit_base_patch16_siglip_256": dict(patch_size=16, width=768, layers=12, heads=12),
    "vit_base_patch16_siglip_384": dict(patch_size=16, width=768, layers=12, heads=12),
    "vit_base_patch16_siglip_512": dict(patch_size=16, width=768, layers=12, heads=12),
    "vit_large_patch16_siglip_256": dict(patch_size=16, width=1024, layers=24, heads=16),
    "vit_large_patch16_siglip_384": dict(patch_size=16, width=1024, layers=24, heads=16),
    "vit_so400m_patch14_siglip_224": dict(patch_size=14, width=1152, layers=27, heads=16, mlp_ratio=3.7362),
    "vit_so400m_patch14_siglip_384": dict(patch_size=14, width=1152, layers=27, heads=16, mlp_ratio=3.7362),
    "vit_medium_patch16_gap_256": dict(
        patch_size=16, width=512, layers=12, heads=8, qkv_bias=False, init_values=1e-6, default_pool="avg"),
    "vit_relpos_medium_patch16_cls_224": dict(
        patch_size=16, width=512, layers=12, heads=8, qkv_bias=False, init_values=1e-6, class_token=True,
        rel_pos=True, rel_pos_dim=256, default_pool="token"),
}


@dataclasses.dataclass(frozen=True)
class TimmViTCfg:
    timm_name: str
    output_dim: int
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    pool: str = "map"  # trunk pool: map | avg | token
    proj: str = "none"  # open_clip head: none | linear | mlp
    proj_bias: bool = False
    class_token: bool = False
    qkv_bias: bool = True
    init_values: Optional[float] = None  # LayerScale (ls1/ls2.gamma)
    rel_pos: bool = False  # RelPosMlp biases instead of pos_embed
    rel_pos_dim: int = 256

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_prefix(self) -> int:
        return 1 if self.class_token else 0

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + self.num_prefix

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def patch_dropout(self) -> float:
        return 0.0


def cfg_from_vision_dict(v: dict, embed_dim: int) -> TimmViTCfg:
    """open_clip timm_model.py:57-88: pool ``map`` keeps the trunk's latent
    pool; pool ``""`` leaves the variant's default pool."""
    name = v["timm_model_name"]
    var = dict(VARIANTS[name])
    default_pool = var.pop("default_pool", "avg")
    pool = v.get("timm_pool", "avg")
    return TimmViTCfg(timm_name=name, output_dim=embed_dim, image_size=v.get("image_size", 224),
                      pool=default_pool if pool in ("", None) else pool, proj=v.get("timm_proj", "linear") or "none",
                      proj_bias=bool(v.get("timm_proj_bias", False)), **var)


def stage_names(cfg: TimmViTCfg) -> List[str]:
    return ["embed"] + [f"blocks.{i}" for i in range(cfg.layers)] + ["pool"]


@functools.lru_cache(maxsize=8)
def relpos_tables(grid: int) -> Tuple[np.ndarray, np.ndarray]:
    """(log relative coords ((2g-1)^2, 2) float32, gather index (g^4,) int32)
    of timm's ``gen_relative_log_coords(mode='cr')`` and
    ``gen_relative_position_index`` (``timm_vit._relpos_tables``)."""
    span = np.arange(2 * grid - 1) - (grid - 1)
    coords = np.stack(np.meshgrid(span, span, indexing="ij"), axis=-1).astype(np.float32)
    log_coords = (np.sign(coords) * np.log1p(np.abs(coords))).reshape(-1, 2)
    pos = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"), axis=-1).reshape(-1, 2)
    rel = pos[:, None, :] - pos[None, :, :] + (grid - 1)
    return log_coords, (rel[..., 0] * (2 * grid - 1) + rel[..., 1]).reshape(-1).astype(np.int32)


class RelPosMlp(nn.Module):
    def __init__(self, cfg: TimmViTCfg):
        super().__init__()
        self.cfg = cfg
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(2, cfg.rel_pos_dim)
        self.mlp.fc2 = nn.Linear(cfg.rel_pos_dim, cfg.heads, bias=False)

    def forward(self, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """The per-head additive bias (H, S, S), fp32, prefix rows and
        columns zero (``timm_vit._relpos_bias``)."""
        cfg = self.cfg
        coords, index = (torch.from_numpy(a).to(self.mlp.fc1.weight.device) for a in relpos_tables(cfg.grid))
        h = torch.relu(L.linear(coords, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype=dtype))
        table = L.linear(h, self.mlp.fc2.weight, dtype=dtype)  # ((2g-1)^2, H)
        n = cfg.grid * cfg.grid
        bias = table[index.long()].reshape(n, n, cfg.heads).permute(2, 0, 1).float()
        p = cfg.num_prefix
        return F.pad(bias, (p, 0, p, 0)) if p else bias


class Block(nn.Module):
    def __init__(self, cfg: TimmViTCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.attn.proj = nn.Linear(d, d)
        if cfg.rel_pos:
            self.attn.rel_pos = RelPosMlp(cfg)
        layer_scale = cfg.init_values is not None
        self.ls1 = L.LayerScale(d) if layer_scale else nn.Identity()
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.mlp_hidden)
        self.mlp.fc2 = nn.Linear(cfg.mlp_hidden, d)
        self.ls2 = L.LayerScale(d) if layer_scale else nn.Identity()

    def init_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        for ln in (self.norm1, self.norm2):
            L.layer_norm_init_(ln)
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            C.linear_init_(lin, generator)
        if cfg.rel_pos:
            C.linear_init_(self.attn.rel_pos.mlp.fc1, generator)
            C.linear_init_(self.attn.rel_pos.mlp.fc2, generator)
        if cfg.init_values is not None:
            self.ls1.gamma.fill_(cfg.init_values)
            self.ls2.gamma.fill_(cfg.init_values)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        y = L.layer_norm(x, self.norm1)
        qkv = L.linear(y, self.attn.qkv.weight, self.attn.qkv.bias, dtype=dtype)
        if cfg.rel_pos:
            q, k, v = qkv.split(d, dim=-1)
            o = L.attention(q, k, v, num_heads=cfg.heads, bias=self.attn.rel_pos(dtype))
        else:
            q, k, v = (t.contiguous() for t in qkv.view(b, s, 3, cfg.heads, cfg.head_dim).permute(2, 0, 3, 1, 4))
            o = FlashAttention.apply(q, k, v, False).transpose(1, 2).reshape(b, s, d)
        x = x + self.ls1(L.linear(o, self.attn.proj.weight, self.attn.proj.bias, dtype=dtype))
        y = L.layer_norm(x, self.norm2)
        y = L.gelu(L.linear(y, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype=dtype))
        return x + self.ls2(L.linear(y, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype=dtype))


class AttentionPoolLatent(nn.Module):
    """timm's ``AttentionPoolLatent`` with one latent query: cross-attention
    to the tokens (plain PyTorch, Lq = 1), ``proj``, then a residual MLP
    behind ``norm``; the latent's output token."""

    def __init__(self, cfg: TimmViTCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        self.latent = nn.Parameter(torch.empty(1, 1, d))
        self.q = nn.Linear(d, d)
        self.kv = nn.Linear(d, 2 * d)
        self.proj = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.mlp_hidden)
        self.mlp.fc2 = nn.Linear(cfg.mlp_hidden, d)

    def init_parameters(self, generator: torch.Generator) -> None:
        C.trunc_normal_(self.latent, generator)
        for lin in (self.q, self.kv, self.proj, self.mlp.fc1, self.mlp.fc2):
            C.linear_init_(lin, generator)
        L.layer_norm_init_(self.norm)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        d = self.cfg.width
        latent = self.latent.to(x.dtype).expand(x.shape[0], 1, d)
        q = L.linear(latent, self.q.weight, self.q.bias, dtype=dtype)
        k, v = L.linear(x, self.kv.weight, self.kv.bias, dtype=dtype).split(d, dim=-1)
        o = L.linear(L.attention(q, k, v, num_heads=self.cfg.heads), self.proj.weight, self.proj.bias, dtype=dtype)
        y = L.gelu(L.linear(L.layer_norm(o, self.norm), self.mlp.fc1.weight, self.mlp.fc1.bias, dtype=dtype))
        return (o + L.linear(y, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype=dtype))[:, 0]


class TimmViT(nn.Module):
    """``visual`` of a timm-ViT CLIP: ``trunk`` and ``head`` (absent for
    ``timm_proj`` none)."""

    def __init__(self, cfg: TimmViTCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        t = self.trunk = nn.Module()
        t.patch_embed = nn.Module()
        t.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        if cfg.class_token:
            t.cls_token = nn.Parameter(torch.empty(1, 1, d))
        if not cfg.rel_pos:
            t.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, d))
        t.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        t.norm = nn.LayerNorm(d, eps=LN_EPS)
        if cfg.pool == "map":
            t.attn_pool = AttentionPoolLatent(cfg)
        elif cfg.pool not in ("avg", "token"):
            raise ValueError(f"unknown trunk pool {cfg.pool!r}")
        head = C.make_head(cfg.proj, d, cfg.output_dim, proj_bias=cfg.proj_bias)
        if head is not None:
            self.head = head

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Distributions of ``timm_vit_init``."""
        cfg, t = self.cfg, self.trunk
        C.trunc_normal_(t.patch_embed.proj.weight, generator)
        t.patch_embed.proj.bias.zero_()
        if cfg.class_token:
            t.cls_token.zero_()
        if not cfg.rel_pos:
            C.trunc_normal_(t.pos_embed, generator)
        for block in t.blocks:
            block.init_parameters(generator)
        L.layer_norm_init_(t.norm)
        if cfg.pool == "map":
            t.attn_pool.init_parameters(generator)
        if hasattr(self, "head"):
            self.head.init_parameters(generator)

    def stage_names(self) -> List[str]:
        return stage_names(self.cfg)

    def run(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None,
            capture: Optional[Sequence[str]] = None, grad_checkpointing: bool = False):
        """NHWC images -> ``(features (B, output_dim) fp32, {stage: tokens})``
        for the stage names in ``capture`` (``timm_vit_apply``)."""
        cfg, t = self.cfg, self.trunk
        capture = set(capture or ())
        inters: Dict[str, torch.Tensor] = {}
        p = t.patch_embed.proj
        x = L.conv2d_nhwc(images, p.weight, p.bias, stride=cfg.patch_size, dtype=dtype).flatten(1, 2)
        if cfg.class_token:
            x = torch.cat([t.cls_token.to(x.dtype).expand(x.shape[0], 1, -1), x], dim=1)
        if not cfg.rel_pos:
            x = x + t.pos_embed.to(x.dtype)
        if "embed" in capture:
            inters["embed"] = x
        remat = grad_checkpointing and torch.is_grad_enabled()
        for i, block in enumerate(t.blocks):
            x = _checkpoint(block, x, dtype, use_reentrant=False) if remat else block(x, dtype)
            if f"blocks.{i}" in capture:
                inters[f"blocks.{i}"] = x
        x = L.layer_norm(x, t.norm)
        if cfg.pool == "map":
            pooled = t.attn_pool(x, dtype)
        elif cfg.pool == "avg":
            pooled = x[:, cfg.num_prefix:].float().mean(dim=1)
        else:
            pooled = x[:, 0]
        out = pooled.float()
        if hasattr(self, "head"):
            out = self.head(out)
        if "pool" in capture:
            inters["pool"] = out
        return out, inters

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        return self.run(images, dtype, grad_checkpointing=grad_checkpointing)[0]


# -- the JAX pytree bridge (open_clip TimmModel naming, without "visual.") --


def params_to_state_dict(params: Mapping, cfg: TimmViTCfg) -> Dict[str, torch.Tensor]:
    """``timm_vit_params_to_state_dict`` with PyTorch tensors."""
    sd: Dict[str, torch.Tensor] = {}
    C.write_conv(sd, "trunk.patch_embed.proj", params["patch_embed"])
    if "cls_token" in params:
        sd["trunk.cls_token"] = C.tensor(np.asarray(params["cls_token"])[None, None])
    if "pos_embed" in params:
        sd["trunk.pos_embed"] = C.tensor(np.asarray(params["pos_embed"])[None])
    for i, bp in enumerate(params["blocks"]):
        base = f"trunk.blocks.{i}"
        C.write_ln(sd, f"{base}.norm1", bp["norm1"])
        C.write_linear(sd, f"{base}.attn.qkv", bp["attn"]["qkv"])
        C.write_linear(sd, f"{base}.attn.proj", bp["attn"]["proj"])
        if "rel_pos" in bp["attn"]:
            C.write_linear(sd, f"{base}.attn.rel_pos.mlp.fc1", bp["attn"]["rel_pos"]["fc1"])
            C.write_linear(sd, f"{base}.attn.rel_pos.mlp.fc2", bp["attn"]["rel_pos"]["fc2"])
        if "ls1" in bp:
            sd[f"{base}.ls1.gamma"] = C.tensor(bp["ls1"])
            sd[f"{base}.ls2.gamma"] = C.tensor(bp["ls2"])
        C.write_ln(sd, f"{base}.norm2", bp["norm2"])
        C.write_linear(sd, f"{base}.mlp.fc1", bp["mlp"]["fc1"])
        C.write_linear(sd, f"{base}.mlp.fc2", bp["mlp"]["fc2"])
    C.write_ln(sd, "trunk.norm", params["norm"])
    if "attn_pool" in params:
        ap = params["attn_pool"]
        sd["trunk.attn_pool.latent"] = C.tensor(np.asarray(ap["latent"])[None])
        for n in ("q", "kv", "proj"):
            C.write_linear(sd, f"trunk.attn_pool.{n}", ap[n])
        C.write_ln(sd, "trunk.attn_pool.norm", ap["norm"])
        C.write_linear(sd, "trunk.attn_pool.mlp.fc1", ap["mlp"]["fc1"])
        C.write_linear(sd, "trunk.attn_pool.mlp.fc2", ap["mlp"]["fc2"])
    if "head" in params:
        C.write_head(sd, params["head"])
    return sd


def state_dict_to_params(sd: Mapping, cfg: TimmViTCfg) -> Dict:
    """``timm_vit_state_dict_to_params`` with numpy leaves."""
    params: Dict = {"patch_embed": C.read_conv(sd, "trunk.patch_embed.proj"), "blocks": [],
                    "norm": C.read_ln(sd, "trunk.norm")}
    if "trunk.cls_token" in sd:
        params["cls_token"] = C.array(sd["trunk.cls_token"]).reshape(-1)
    if "trunk.pos_embed" in sd:
        params["pos_embed"] = C.array(sd["trunk.pos_embed"])[0]
    for i in range(cfg.layers):
        base = f"trunk.blocks.{i}"
        blk: Dict = {"norm1": C.read_ln(sd, f"{base}.norm1"),
                     "attn": {"qkv": C.read_linear(sd, f"{base}.attn.qkv"),
                              "proj": C.read_linear(sd, f"{base}.attn.proj")},
                     "norm2": C.read_ln(sd, f"{base}.norm2"),
                     "mlp": {"fc1": C.read_linear(sd, f"{base}.mlp.fc1"), "fc2": C.read_linear(sd, f"{base}.mlp.fc2")}}
        if f"{base}.attn.rel_pos.mlp.fc1.weight" in sd:
            blk["attn"]["rel_pos"] = {"fc1": C.read_linear(sd, f"{base}.attn.rel_pos.mlp.fc1"),
                                      "fc2": C.read_linear(sd, f"{base}.attn.rel_pos.mlp.fc2")}
        if f"{base}.ls1.gamma" in sd:
            blk["ls1"] = C.array(sd[f"{base}.ls1.gamma"])
            blk["ls2"] = C.array(sd[f"{base}.ls2.gamma"])
        params["blocks"].append(blk)
    if "trunk.attn_pool.latent" in sd:
        params["attn_pool"] = {
            "latent": C.array(sd["trunk.attn_pool.latent"])[0],
            **{n: C.read_linear(sd, f"trunk.attn_pool.{n}") for n in ("q", "kv", "proj")},
            "norm": C.read_ln(sd, "trunk.attn_pool.norm"),
            "mlp": {"fc1": C.read_linear(sd, "trunk.attn_pool.mlp.fc1"),
                    "fc2": C.read_linear(sd, "trunk.attn_pool.mlp.fc2")}}
    head = C.read_head(sd)
    if head is not None:
        params["head"] = head
    return params
