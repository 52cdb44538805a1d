"""ConvNeXt image towers: the ``convnext_*`` configs.

Counterpart of ``xclip_tpu/models/convnext.py`` (VARIANTS :38-45, blocks
:163-192, head :253-266, bridge :274-354), with open_clip's ``TimmModel``
state-dict names (``visual.trunk.*``, ``visual.head.*``):

- stem ``trunk.stem.0`` (4x4 / stride 4 conv) and ``trunk.stem.1``
  (LayerNorm, eps 1e-6);
- four stages ``trunk.stages.{s}``; stages 1-3 open with
  ``downsample.0`` (LayerNorm) and ``downsample.1`` (2x2 / stride 2 conv);
  each block is a 7x7 depthwise conv, LayerNorm, the pointwise MLP (4x,
  GELU), the LayerScale ``gamma`` and the residual (drop path: the
  identity in eval mode);
- ``trunk.head.norm``: the LayerNorm after an fp32 global mean; then
  ``head.proj`` (linear), ``head.mlp`` (convnext_large_d) or no head.

Activations are NHWC, as in JAX: LayerNorm and the MLP act on the last
axis, and the convolutions see the same memory as a channels-last NCHW
tensor. The depthwise conv is ``F.conv2d(groups=C)``: JAX computes it with
``lax.conv`` outside any Pallas kernel, so no kernel of the port runs in
this tower.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models import tower_common as C

# timm convnext variant table (depths, dims)
VARIANTS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}

LN_EPS = 1e-6
LS_INIT = 1e-6


@dataclasses.dataclass(frozen=True)
class ConvNeXtCfg:
    depths: Tuple[int, int, int, int]
    dims: Tuple[int, int, int, int]
    output_dim: int
    image_size: int = 256
    proj: str = "linear"  # timm_proj: linear | mlp | none
    drop_path_rate: float = 0.0
    timm_name: str = "convnext_base"

    @property
    def width(self) -> int:
        return self.dims[-1]

    @property
    def patch_dropout(self) -> float:
        return 0.0


def cfg_from_vision_dict(v: dict, embed_dim: int) -> ConvNeXtCfg:
    depths, dims = VARIANTS[v["timm_model_name"]]
    return ConvNeXtCfg(depths=depths, dims=dims, output_dim=embed_dim, image_size=v.get("image_size", 256),
                       proj=v.get("timm_proj", "linear") or "none",
                       drop_path_rate=float(v.get("timm_drop_path") or 0.0), timm_name=v["timm_model_name"])


def stage_names(cfg: ConvNeXtCfg) -> List[str]:
    names = ["stem"]
    for s, depth in enumerate(cfg.depths):
        names += [f"stages.{s}.{b}" for b in range(depth)]
    return names + ["head"]


class Block(nn.Module):
    def __init__(self, dim: int, drop_path: float):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))
        self.drop_path = L.DropPath(drop_path)

    def init_parameters(self, generator: torch.Generator) -> None:
        C.trunc_normal_(self.conv_dw.weight, generator)
        self.conv_dw.bias.zero_()
        L.layer_norm_init_(self.norm)
        C.linear_init_(self.mlp.fc1, generator)
        C.linear_init_(self.mlp.fc2, generator)
        self.gamma.fill_(LS_INIT)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        y = L.conv2d_nhwc(x, self.conv_dw.weight, self.conv_dw.bias, padding=3, groups=x.shape[-1], dtype=dtype)
        y = L.layer_norm(y, self.norm)
        y = L.gelu(L.linear(y, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype=dtype))
        y = L.linear(y, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype=dtype)
        return x + self.drop_path(y * self.gamma.to(y.dtype))


class ConvNeXt(nn.Module):
    """``visual`` of a ConvNeXt CLIP: ``trunk`` and ``head`` (absent for
    ``timm_proj`` none)."""

    def __init__(self, cfg: ConvNeXtCfg):
        super().__init__()
        self.cfg = cfg
        dims = cfg.dims
        n_blocks = sum(cfg.depths)
        # timm: drop-path rates linearly spaced from 0 to the config's rate
        rates = np.linspace(0.0, cfg.drop_path_rate, n_blocks) if n_blocks > 1 else [0.0]
        t = self.trunk = nn.Module()
        t.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=LN_EPS))
        t.stages = nn.ModuleList()
        gi = 0
        for s, depth in enumerate(cfg.depths):
            stage = nn.Module()
            if s > 0:
                stage.downsample = nn.Sequential(nn.LayerNorm(dims[s - 1], eps=LN_EPS),
                                                 nn.Conv2d(dims[s - 1], dims[s], 2, stride=2))
            stage.blocks = nn.ModuleList(Block(dims[s], float(rates[gi + b])) for b in range(depth))
            gi += depth
            t.stages.append(stage)
        t.head = nn.Module()
        t.head.norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        head = C.make_head(cfg.proj, dims[-1], cfg.output_dim)
        if head is not None:
            self.head = head

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Distributions of ``convnext_init``."""
        t = self.trunk
        C.trunc_normal_(t.stem[0].weight, generator)
        t.stem[0].bias.zero_()
        L.layer_norm_init_(t.stem[1])
        for s, stage in enumerate(t.stages):
            if s > 0:
                L.layer_norm_init_(stage.downsample[0])
                C.trunc_normal_(stage.downsample[1].weight, generator)
                stage.downsample[1].bias.zero_()
            for block in stage.blocks:
                block.init_parameters(generator)
        L.layer_norm_init_(t.head.norm)
        if hasattr(self, "head"):
            self.head.init_parameters(generator)

    def stage_names(self) -> List[str]:
        return stage_names(self.cfg)

    def run(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None,
            capture: Optional[Sequence[str]] = None, grad_checkpointing: bool = False):
        """NHWC images -> ``(features (B, output_dim) fp32, {stage: NHWC
        activation})`` for the stage names in ``capture`` (``convnext_apply``)."""
        capture = set(capture or ())
        inters: Dict[str, torch.Tensor] = {}
        t = self.trunk
        y = L.conv2d_nhwc(images, t.stem[0].weight, t.stem[0].bias, stride=4, dtype=dtype)
        y = L.layer_norm(y, t.stem[1])
        if "stem" in capture:
            inters["stem"] = y
        remat = grad_checkpointing and torch.is_grad_enabled()
        for s, stage in enumerate(t.stages):
            if s > 0:
                y = L.layer_norm(y, stage.downsample[0])
                y = L.conv2d_nhwc(y, stage.downsample[1].weight, stage.downsample[1].bias, stride=2, dtype=dtype)
            for b, block in enumerate(stage.blocks):
                y = _checkpoint(block, y, dtype, use_reentrant=False) if remat else block(y, dtype)
                if f"stages.{s}.{b}" in capture:
                    inters[f"stages.{s}.{b}"] = y
        # trunk head: fp32 global mean and LayerNorm, then open_clip's head
        out = L.layer_norm(y.float().mean(dim=(1, 2)), t.head.norm)
        if hasattr(self, "head"):
            out = self.head(out)
        if "head" in capture:
            inters["head"] = out
        return out, inters

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                generator: Optional[torch.Generator] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        return self.run(images, dtype, grad_checkpointing=grad_checkpointing)[0]


# -- the JAX pytree bridge (open_clip TimmModel naming, without "visual.") --


def params_to_state_dict(params: Mapping, cfg: ConvNeXtCfg) -> Dict[str, torch.Tensor]:
    """``convnext_params_to_state_dict`` with PyTorch tensors."""
    sd: Dict[str, torch.Tensor] = {}
    C.write_conv(sd, "trunk.stem.0", params["stem"]["conv"])
    C.write_ln(sd, "trunk.stem.1", params["stem"]["norm"])
    for s, stage in enumerate(params["stages"]):
        if s > 0:
            C.write_ln(sd, f"trunk.stages.{s}.downsample.0", stage["downsample"]["norm"])
            C.write_conv(sd, f"trunk.stages.{s}.downsample.1", stage["downsample"]["conv"])
        for b, bp in enumerate(stage["blocks"]):
            base = f"trunk.stages.{s}.blocks.{b}"
            C.write_conv(sd, f"{base}.conv_dw", bp["conv_dw"])
            C.write_ln(sd, f"{base}.norm", bp["norm"])
            C.write_linear(sd, f"{base}.mlp.fc1", bp["mlp"]["fc1"])
            C.write_linear(sd, f"{base}.mlp.fc2", bp["mlp"]["fc2"])
            sd[f"{base}.gamma"] = C.tensor(bp["gamma"])
    C.write_ln(sd, "trunk.head.norm", params["head_norm"])
    if "head" in params:
        C.write_head(sd, params["head"])
    return sd


def state_dict_to_params(sd: Mapping, cfg: ConvNeXtCfg) -> Dict:
    """``convnext_state_dict_to_params`` with numpy leaves."""
    params: Dict = {"stem": {"conv": C.read_conv(sd, "trunk.stem.0"), "norm": C.read_ln(sd, "trunk.stem.1")},
                    "stages": [], "head_norm": C.read_ln(sd, "trunk.head.norm")}
    for s in range(4):
        stage: Dict = {"blocks": []}
        if s > 0:
            stage["downsample"] = {"norm": C.read_ln(sd, f"trunk.stages.{s}.downsample.0"),
                                   "conv": C.read_conv(sd, f"trunk.stages.{s}.downsample.1")}
        for b in range(cfg.depths[s]):
            base = f"trunk.stages.{s}.blocks.{b}"
            stage["blocks"].append({
                "conv_dw": C.read_conv(sd, f"{base}.conv_dw"), "norm": C.read_ln(sd, f"{base}.norm"),
                "mlp": {"fc1": C.read_linear(sd, f"{base}.mlp.fc1"), "fc2": C.read_linear(sd, f"{base}.mlp.fc2")},
                "gamma": C.array(sd[f"{base}.gamma"])})
        params["stages"].append(stage)
    head = C.read_head(sd)
    if head is not None:
        params["head"] = head
    return params
