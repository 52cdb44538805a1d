"""ModifiedResNet image tower (RN50, RN101, RN50x4, ...), train and eval.

Counterpart of ``xclip_tpu/models/resnet.py``: CLIP's anti-aliased ResNet
with a 3-conv stem, bottlenecks whose strided convs are avgpool + conv, and
an attention pool that queries only the mean token. Parameter names are
open_clip's (``visual.layer1.0.conv1.weight``, ``visual.attnpool.q_proj``...).

The bottleneck follows ``_bottleneck_apply_pallas`` (resnet.py:157-229).
Activations stay in ``torch.channels_last``, so the input of each 1x1 conv
is an ``(N*H*W, C)`` view with no copy; conv2 is a plain 3x3 conv.

- Eval: conv1, the downsample conv and conv3 run through K1/K2 with the
  BatchNorm folded into an fp32 epilogue from the running statistics (conv3
  adds the identity there), by the autograd Function
  :class:`ops.fused_conv.MatmulAffineAct` (the kernel forward, a plain
  backward), so that gradients reach the input of an eval tower as JAX's
  ``custom_vjp`` lets them (integrated gradients, ``interp.attribution``);
  under ``torch.no_grad`` it records nothing and launches the same kernels.
- Train: conv1 through :class:`ops.fused_conv.MatmulStats` (K3: the batch
  moments come out of the matmul), then the affine and relu; conv2 with
  train BatchNorm; the downsample and conv3 take their batch moments from
  their inputs (``conv1x1_moments_from_input``, 1x1 linearity) and run
  through :class:`ops.fused_conv.MatmulAffineAct` (K1/K2). The stem is plain
  conv + train BatchNorm. Every BatchNorm returns its new running
  statistics instead of writing them; the caller applies them once
  (:func:`apply_bn_moments`), so checkpoint recomputation and the no-grad
  cache pass of accumulation update nothing.

In eval mode the tower is stage-addressable, as ``resnet_apply``'s
``start``, ``stop`` and ``capture`` make JAX's: :func:`resnet_stage_names`
lists the stages (``stem.act1-3``, ``stem.avgpool``, ``layer{s}.{b}``,
``attnpool``) and :meth:`ModifiedResNet.run_stages` runs a range of them
and returns the activations it was asked to capture.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.ops.fused_conv import MatmulAffineAct, MatmulStats

# BatchNorm module name (relative to the tower) -> new (running_mean, running_var)
Moments = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

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


def resnet_stage_names(cfg: ResNetCfg) -> List[str]:
    """The tower's sequential stages (``resnet.resnet_stage_names``): the
    circuit and CKA granularity of the reference."""
    names = ["stem.act1", "stem.act2", "stem.act3", "stem.avgpool"]
    for i, blocks in enumerate(cfg.layers):
        names += [f"layer{i + 1}.{b}" for b in range(blocks)]
    names.append("attnpool")
    return names


@torch.no_grad()
def apply_bn_moments(module: nn.Module, moments: Moments) -> None:
    """Write new running statistics (from a train-mode forward) into the
    BatchNorm buffers of ``module``, each once."""
    for name, (mean, var) in moments.items():
        bn = module.get_submodule(name)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        bn.num_batches_tracked += 1


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

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, Moments]:
        """Train mode (the train branch of ``_bottleneck_apply_pallas``):
        x: (N, C, H, W) channels_last in the compute dtype -> (out, new
        running statistics of bn1, bn2, bn3 and downsample.1)."""
        n, cin, h, w = x.shape
        dt = x.dtype
        moments: Moments = {}
        zf = _as_rows(x)
        n1 = zf.shape[0]
        y1, s1, s2 = MatmulStats.apply(zf, _weight_kc(self.conv1, dt))
        mean1 = s1 / n1
        var1 = torch.clamp_min(s2 / n1 - mean1 * mean1, 0.0)
        g1, b1 = L.bn_factors_from_stats(self.bn1, mean1, var1)
        moments["bn1"] = L.running_stats_update(self.bn1, mean1, var1, n1)
        out = _from_rows(torch.relu(y1 * g1.to(dt) + b1.to(dt)), n, h, w)

        out = L.conv2d(out, self.conv2.weight, padding=1)
        out, moments["bn2"] = L.batchnorm_train(out, self.bn2)
        out = torch.relu(out)
        if self.stride > 1:
            out = L.avg_pool(out, self.stride)
        out = _channels_last(out)
        oh, ow = out.shape[2], out.shape[3]
        z2 = _as_rows(out)
        n3 = z2.shape[0]

        if self.downsample is not None:
            idin = _channels_last(L.avg_pool(x, self.stride)) if self.stride > 1 else x
            idf = _as_rows(idin)
            conv, bn = self.downsample[0], self.downsample[1]
            wd32 = conv.weight[:, :, 0, 0].t().float()
            mean_d, var_d = L.conv1x1_moments_from_input(idf, wd32, n3)
            gd, bd = L.bn_factors_from_stats(bn, mean_d, var_d)
            moments["downsample.1"] = L.running_stats_update(bn, mean_d, var_d, n3)
            identity = MatmulAffineAct.apply(idf, wd32.to(dt).contiguous(), gd, bd, None, False)
        else:
            identity = _as_rows(x)
        w3_32 = self.conv3.weight[:, :, 0, 0].t().float()
        mean3, var3 = L.conv1x1_moments_from_input(z2, w3_32, n3)
        g3, b3 = L.bn_factors_from_stats(self.bn3, mean3, var3)
        moments["bn3"] = L.running_stats_update(self.bn3, mean3, var3, n3)
        out = MatmulAffineAct.apply(z2, w3_32.to(dt).contiguous(), g3, b3, identity, True)
        return _from_rows(out, n, oh, ow), moments

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) channels_last in the compute dtype. In train mode
        the new running statistics are dropped (see :meth:`forward_train`)."""
        if self.training:
            return self.forward_train(x)[0]
        n, cin, h, w = x.shape
        dt = x.dtype
        g1, b1 = L.bn_factors(self.bn1)
        out = MatmulAffineAct.apply(_as_rows(x), _weight_kc(self.conv1, dt), g1, b1, None, True)
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
            identity = MatmulAffineAct.apply(_as_rows(idin), _weight_kc(self.downsample[0], dt), gd, bd, None,
                                             False)
        else:
            identity = _as_rows(x)
        g3, b3 = L.bn_factors(self.bn3)
        out = MatmulAffineAct.apply(_as_rows(out), _weight_kc(self.conv3, dt), g3, b3, identity, True)
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

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                moments: Optional[Moments] = None, grad_checkpointing: bool = False) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC, as the JAX tower takes them ->
        (N, output_dim) in the compute dtype.

        In train mode BatchNorm uses batch statistics and ``moments``, when
        given, receives every BatchNorm's new running statistics (names
        relative to this module) for :func:`apply_bn_moments`.
        ``grad_checkpointing`` recomputes each bottleneck in the backward
        (``jax.checkpoint`` per block, resnet.py:360-398)."""
        if not self.training:
            return self.run_stages(images, dtype=dtype)[0]
        x = _channels_last(self._image_nchw(images, dtype))
        new: Moments = {}
        for i, (conv, bn) in enumerate(((self.conv1, self.bn1), (self.conv2, self.bn2),
                                        (self.conv3, self.bn3))):
            x = L.conv2d(x, conv.weight, stride=2 if i == 0 else 1, padding=1)
            x, new[f"bn{i + 1}"] = L.batchnorm_train(x, bn)
            x = torch.relu(x)
        x = _channels_last(L.avg_pool(x, 2))
        remat = grad_checkpointing and torch.is_grad_enabled()
        for si, stage in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            for bi, block in enumerate(stage):
                if remat:
                    x, block_moments = _checkpoint(block.forward_train, x, use_reentrant=False)
                else:
                    x, block_moments = block.forward_train(x)
                new.update({f"layer{si + 1}.{bi}.{k}": v for k, v in block_moments.items()})
        if moments is not None:
            moments.update(new)
        return self.attnpool(x, dtype=dtype)

    @staticmethod
    def _image_nchw(images: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        return x.to(dtype) if dtype is not None else x

    def run_stages(self, x: torch.Tensor, *, start: int = 0, stop: Optional[int] = None,
                   capture: Sequence[str] = (), dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Eval mode: run stages ``start:stop`` of :func:`resnet_stage_names`
        (``resnet_apply``'s ``start``, ``stop`` and ``capture``) -> (output,
        {captured stage name: its output}).

        ``x`` is the input of stage ``start``: the (N, H, W, 3) NHWC image
        for ``start=0``, else the output of stage ``start - 1``: (N, C, H, W)
        (made ``channels_last``) or, before nothing, attnpool's (N, D)."""
        if self.training:
            raise RuntimeError("run_stages is the eval-mode tower; call .eval() first")
        names = resnet_stage_names(self.cfg)
        stop = len(names) if stop is None else stop
        if start == 0:
            x = self._image_nchw(x, dtype)
        elif dtype is not None:
            x = x.to(dtype)
        if x.dim() == 4:
            x = _channels_last(x)
        inters: Dict[str, torch.Tensor] = {}
        for name in names[start:stop]:
            if name.startswith("stem.act"):
                i = int(name[-1])
                conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
                x = L.conv2d(x, conv.weight, stride=2 if i == 1 else 1, padding=1)
                x = torch.relu(L.batchnorm_eval(x, bn))
            elif name == "stem.avgpool":
                x = _channels_last(L.avg_pool(x, 2))
            elif name == "attnpool":
                x = self.attnpool(x, dtype=dtype)
            else:
                stage, block = name.split(".")
                x = getattr(self, stage)[int(block)](x)
            if name in capture:
                inters[name] = x
        return x, inters
