"""Functional layer math shared by the towers.

Counterpart of ``xclip_tpu/models/layers.py``, with the same numerics
choices: matmul/conv inputs are cast to the compute dtype at use (weights
stay in their stored dtype), LayerNorm and the BatchNorm fold compute in
fp32, softmax is fp32. BatchNorm in train mode is written out here (not
``F.batch_norm``, whose numerics and buffer update differ). Weights are in PyTorch's layouts: linear
``(out, in)``, conv OIHW.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the activation OpenAI CLIP was trained with."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


ACT_FNS = {"gelu": gelu, "quick_gelu": quick_gelu}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in the compute dtype; the bias is added after
    the product is rounded, as ``layers.linear_apply`` does."""
    if dtype is not None:
        x = x.to(dtype)
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in fp32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """Convolution in x's dtype (the weight is cast to it)."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding, groups=groups)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                stride: int = 1, padding: int = 0, groups: int = 1,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layers.conv_apply`` on NHWC: x (and the OIHW weight) in the compute
    dtype, the bias added after the product is rounded; NHWC out."""
    if dtype is not None:
        x = x.to(dtype)
    y = conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=padding, groups=groups).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def bn_factors(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm folded to a per-channel fp32 affine ``(g, b)`` from the
    running statistics, as ``layers.bn_factors_from_stats`` computes it."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    scale = bn.weight.float()
    return scale * inv, bn.bias.float() - scale * bn.running_mean.float() * inv


def batchnorm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm over NCHW: the fp32 affine cast to x's dtype and applied
    there (``layers.batchnorm_apply``, train=False)."""
    g, b = bn_factors(bn)
    return x * g.to(x.dtype).view(1, -1, 1, 1) + b.to(x.dtype).view(1, -1, 1, 1)


# Train-mode BatchNorm. The running statistics are updated functionally, as
# the JAX package carries them in a state pytree: each function returns the
# new (running_mean, running_var) pair, detached, and the caller writes it
# into the buffers (see ``resnet.apply_bn_moments``). A re-run forward
# (checkpoint recomputation, the no-grad cache pass of accumulation) then
# cannot update a buffer twice.

BN_MOMENTUM = 0.1


def bn_factors_from_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                          var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 affine ``(g, b)`` from batch moments (``layers.
    bn_factors_from_stats``, train=True); differentiable in the moments."""
    inv = torch.rsqrt(var + bn.eps)
    scale = bn.weight.float()
    return scale * inv, bn.bias.float() - scale * mean * inv


def running_stats_update(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                         n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """New running ``(mean, var)`` from the batch ``mean`` and biased ``var``
    over ``n`` values: unbiased variance, momentum ``BN_MOMENTUM``, fp32."""
    mean, var = mean.detach(), var.detach()
    unbiased = var * (n / max(n - 1, 1))
    return ((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean,
            (1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased)


def batchnorm_train(x: torch.Tensor, bn: nn.BatchNorm2d):
    """Train BatchNorm over NCHW with batch statistics (``layers.
    batchnorm_apply``, train=True): fp32 mean and E[x^2] (x^2 rounded in x's
    dtype, summed in fp32), the affine computed in fp32 and applied in x's
    dtype. Returns ``(y, (new_running_mean, new_running_var))``."""
    dims = (0, 2, 3)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean = torch.mean(x, dim=dims, dtype=torch.float32)
    mean_sq = torch.mean(x * x, dim=dims, dtype=torch.float32)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    g, b = bn_factors_from_stats(bn, mean, var)
    y = x * g.to(x.dtype).view(1, -1, 1, 1) + b.to(x.dtype).view(1, -1, 1, 1)
    return y, running_stats_update(bn, mean, var, n)


def conv1x1_moments_from_input(z: torch.Tensor, w32: torch.Tensor, n: int):
    """Batch mean and biased variance of ``y = z @ w`` from z's first and
    second moments (``layers.conv1x1_moments_from_input``). z: (N, K) in any
    dtype, upcast to fp32 so the covariance ``z^T z / n`` is an fp32 product;
    w32: (K, C) fp32."""
    z32 = z.float()
    m_z = z32.mean(dim=0)
    cov = (z32.t() @ z32) / n
    mean = m_z @ w32
    mean_sq = ((cov @ w32) * w32).sum(dim=0)
    return mean, torch.clamp_min(mean_sq - mean * mean, 0.0)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping average pool over NCHW spatial dims, native dtype."""
    return F.avg_pool2d(x, window)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, L, D) tensors with Lq != Lk
    allowed (``layers.attention``, einsum path): fp32 logits plus the
    additive fp32 ``bias`` (broadcastable to (B, H, Lq, Lk)) when given,
    fp32 softmax, weights cast to q's dtype before the product with v."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // num_heads
    qh = q.reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    logits = (qh.float() @ kh.float().transpose(-1, -2)) * (hd ** -0.5)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = weights @ vh
    return out.transpose(1, 2).reshape(b, lq, d)


class LayerScale(nn.Module):
    """Per-channel learnable gamma on a residual branch (open_clip's
    ``ls_1``/``ls_2``, timm's ``ls1``/``ls2``), applied in y's dtype."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(width))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.gamma.to(y.dtype)


class DropPath(nn.Module):
    """Stochastic depth at ``rate`` (timm ``DropPath``): the identity in eval
    mode. Training the timm towers is later work, so train mode with a
    nonzero rate raises instead of dropping."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("drop path in train mode is not ported yet (a later slice); "
                                      "call .eval() or set the rate to 0")
        return y


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=generator, device=generator.device) * 2 - 1) * bound)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)


def layer_norm_init_(ln: nn.LayerNorm) -> None:
    ln.weight.fill_(1.0)
    ln.bias.zero_()


def conv_init_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as ``layers.conv_init``."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    uniform_(conv.weight, 1.0 / math.sqrt(fan_in), generator)


def bn_init_(bn: nn.BatchNorm2d, scale: float = 1.0) -> None:
    bn.weight.fill_(scale)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()
