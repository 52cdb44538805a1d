"""ModifiedResNet image tower (RN50, RN101, RN50x4, ...), eval mode.

Counterpart of ``xclip_tpu/models/resnet.py``: CLIP's anti-aliased ResNet
with a 3-conv stem, bottlenecks whose strided convs are avgpool + conv, and
an attention pool that queries only the mean token. Parameter names are
open_clip's (``visual.layer1.0.conv1.weight``, ``visual.attnpool.q_proj``...).

The bottleneck follows the eval branch of ``_bottleneck_apply_pallas``
(resnet.py:157-229): conv1, the downsample conv and conv3 are 1x1 convs run
through :func:`ops.fused_conv.matmul_affine_act` with the BatchNorm folded
into an fp32 epilogue (conv3 adds the identity there); conv2 is a plain 3x3
conv. Activations stay in ``torch.channels_last``, so the input of each 1x1
conv is an ``(N*H*W, C)`` view with no copy. Training (batch statistics,
backward) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import torch
from torch import nn

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.ops.fused_conv import matmul_affine_act

EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ResNetCfg:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224

    @property
    def embed_dim(self) -> int:
        return self.width * 32

    @property
    def grid(self) -> int:
        return self.image_size // 32


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels_last -> its (N*H*W, C) rows, a view."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).view(n * h * w, c)


def _from_rows(rows: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N*H*W, C) rows -> (N, C, H, W) in channels_last, a view."""
    return rows.view(n, h, w, rows.shape[1]).permute(0, 3, 1, 2)


def _weight_kc(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """1x1 conv weight (C, K, 1, 1) -> contiguous (K, C) in ``dtype``."""
    return conv.weight[:, :, 0, 0].t().to(dtype).contiguous()


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _check_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "ModifiedResNet runs in eval mode only in this port; train mode (BatchNorm batch "
            "statistics, backward, the matmul_stats kernel) comes with the training slice. "
            "Call model.eval().")


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * EXPANSION)
        self.downsample = None
        if stride > 1 or inplanes != planes * EXPANSION:
            self.downsample = nn.Sequential(OrderedDict([
                ("0", nn.Conv2d(inplanes, planes * EXPANSION, 1, bias=False)),
                ("1", nn.BatchNorm2d(planes * EXPANSION)),
            ]))

    def init_parameters(self, generator: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            L.conv_init_(conv, generator)
        L.bn_init_(self.bn1)
        L.bn_init_(self.bn2)
        L.bn_init_(self.bn3, scale=0.0)  # zero-init bn3 scale, as the JAX init does
        if self.downsample is not None:
            L.conv_init_(self.downsample[0], generator)
            L.bn_init_(self.downsample[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) channels_last in the compute dtype."""
        _check_eval(self)
        n, cin, h, w = x.shape
        dt = x.dtype
        g1, b1 = L.bn_factors(self.bn1)
        out = matmul_affine_act(_as_rows(x), _weight_kc(self.conv1, dt), g1, b1, relu=True)
        out = _from_rows(out, n, h, w)

        out = L.conv2d(out, self.conv2.weight, padding=1)
        out = torch.relu(L.batchnorm_eval(out, self.bn2))
        if self.stride > 1:
            out = L.avg_pool(out, self.stride)
        out = _channels_last(out)
        oh, ow = out.shape[2], out.shape[3]

        if self.downsample is not None:
            idin = _channels_last(L.avg_pool(x, self.stride)) if self.stride > 1 else x
            gd, bd = L.bn_factors(self.downsample[1])
            identity = matmul_affine_act(_as_rows(idin), _weight_kc(self.downsample[0], dt), gd, bd,
                                         relu=False)
        else:
            identity = _as_rows(x)
        g3, b3 = L.bn_factors(self.bn3)
        out = matmul_affine_act(_as_rows(out), _weight_kc(self.conv3, dt), g3, b3, identity, relu=True)
        return _from_rows(out, n, oh, ow)


class AttentionPool2d(nn.Module):
    """Attention pool that queries only the mean token (output row 0 of the
    reference's full attention; ``resnet.attnpool_apply``)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def init_parameters(self, generator: torch.Generator) -> None:
        std = self.positional_embedding.shape[1] ** -0.5
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            L.normal_(lin.weight, std, generator)
            lin.bias.zero_()
        L.normal_(self.positional_embedding, std, generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        n, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        mean_tok = tokens.float().mean(dim=1, keepdim=True).to(tokens.dtype)
        tokens = torch.cat([mean_tok, tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        q = L.linear(tokens[:, :1], self.q_proj.weight, self.q_proj.bias, dtype=dtype)
        k = L.linear(tokens, self.k_proj.weight, self.k_proj.bias, dtype=dtype)
        v = L.linear(tokens, self.v_proj.weight, self.v_proj.bias, dtype=dtype)
        o = L.attention(q, k, v, num_heads=self.num_heads)
        return L.linear(o, self.c_proj.weight, self.c_proj.bias, dtype=dtype)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ResNetCfg):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(w)
        inplanes = w
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), cfg.layers)):
            planes = w * mult
            stride = 1 if stage == 0 else 2
            stage_blocks = []
            for b in range(blocks):
                stage_blocks.append(Bottleneck(inplanes, planes, stride if b == 0 else 1))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stage_blocks))
        self.attnpool = AttentionPool2d(cfg.grid, cfg.embed_dim, cfg.heads, cfg.output_dim)

    def init_parameters(self, generator: torch.Generator) -> None:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            L.conv_init_(conv, generator)
            L.bn_init_(bn)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                block.init_parameters(generator)
        self.attnpool.init_parameters(generator)

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC, as the JAX tower takes them ->
        (N, output_dim) in the compute dtype."""
        _check_eval(self)
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        if dtype is not None:
            x = x.to(dtype)
        x = _channels_last(x)
        for i, (conv, bn) in enumerate(((self.conv1, self.bn1), (self.conv2, self.bn2),
                                        (self.conv3, self.bn3))):
            x = L.conv2d(x, conv.weight, stride=2 if i == 0 else 1, padding=1)
            x = torch.relu(L.batchnorm_eval(x, bn))
        x = _channels_last(L.avg_pool(x, 2))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x)
        return self.attnpool(x, dtype=dtype)
