"""Init helpers, the projection head and the state-dict bridge of the timm towers.

Counterpart of ``xclip_tpu/models/tower_common.py``. Every timm family
(``convnext``, ``timm_vit``, ``eva``) shares:

- timm's init: truncated normal (std 0.02, cut at +-2 std) weights and zero
  biases (:func:`trunc_normal_`, :func:`linear_init_`);
- open_clip's ``TimmModel`` projection head (``visual.head.proj`` or
  ``visual.head.mlp.fc1``/``fc2``, timm_model.py:101-106) as
  :class:`ProjHead`;
- the bridge between the JAX package's param pytrees (numpy leaves) and
  PyTorch state dicts: writers (pytree -> state dict: (in, out) linear
  kernels become (out, in), HWIO convs OIHW, LayerNorm ``scale`` becomes
  ``weight``) and readers (state dict -> pytree, the inverse).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from xclip_tpu_torch.models import layers as L

TRUNC_STD = 0.02


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = TRUNC_STD) -> None:
    """``std * truncated_normal(-2, 2)`` drawn from ``generator``, in place."""
    draw = torch.empty(t.shape, device=generator.device)
    nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=generator)
    t.copy_(draw)


def linear_init_(linear: nn.Linear, generator: torch.Generator, std: float = TRUNC_STD) -> None:
    trunc_normal_(linear.weight, generator, std)
    if linear.bias is not None:
        linear.bias.zero_()


class ProjHead(nn.Module):
    """open_clip's projection head after a timm trunk: ``proj`` (a linear) or
    ``mlp`` (fc1, GELU, fc2 at 2 x out hidden); fp32 in and out, as the JAX
    towers apply it to the fp32 pooled features."""

    def __init__(self, kind: str, width: int, out: int, *, proj_bias: bool = False):
        super().__init__()
        self.kind = kind
        if kind == "linear":
            self.proj = nn.Linear(width, out, bias=proj_bias)
        elif kind == "mlp":
            self.mlp = nn.Module()
            self.mlp.fc1 = nn.Linear(width, 2 * out)
            self.mlp.fc2 = nn.Linear(2 * out, out, bias=proj_bias)
        else:
            raise ValueError(f"projection head {kind!r}")

    def init_parameters(self, generator: torch.Generator) -> None:
        for lin in ((self.proj,) if self.kind == "linear" else (self.mlp.fc1, self.mlp.fc2)):
            linear_init_(lin, generator)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        if self.kind == "linear":
            return L.linear(pooled, self.proj.weight, self.proj.bias)
        h = L.gelu(L.linear(pooled, self.mlp.fc1.weight, self.mlp.fc1.bias))
        return L.linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)


def make_head(kind: str, width: int, out: int, *, proj_bias: bool = False) -> Optional[ProjHead]:
    """The head for open_clip's ``timm_proj`` (``"none"``: no head)."""
    return None if kind == "none" else ProjHead(kind, width, out, proj_bias=proj_bias)


# -- writers (JAX pytree, numpy leaves -> PyTorch state dict) ---------------


def tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


def write_ln(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = tensor(p["scale"])
    sd[f"{dst}.bias"] = tensor(p["bias"])


def write_linear(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = tensor(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{dst}.bias"] = tensor(p["bias"])


def write_conv(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))  # HWIO -> OIHW
    if "bias" in p:
        sd[f"{dst}.bias"] = tensor(p["bias"])


def write_head(sd: Dict, p: Mapping) -> None:
    """``head.proj`` or ``head.mlp.*`` from the pytree's ``head`` entry."""
    if "proj" in p:
        write_linear(sd, "head.proj", p["proj"])
    else:
        write_linear(sd, "head.mlp.fc1", p["mlp"]["fc1"])
        write_linear(sd, "head.mlp.fc2", p["mlp"]["fc2"])


# -- readers (PyTorch state dict -> JAX pytree, numpy leaves) ---------------


def array(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


def read_ln(sd: Mapping, src: str) -> Dict:
    return {"scale": array(sd[f"{src}.weight"]), "bias": array(sd[f"{src}.bias"])}


def read_linear(sd: Mapping, src: str) -> Dict:
    p = {"kernel": array(sd[f"{src}.weight"]).T.copy()}
    if f"{src}.bias" in sd:
        p["bias"] = array(sd[f"{src}.bias"])
    return p


def read_conv(sd: Mapping, src: str) -> Dict:
    p = {"kernel": np.transpose(array(sd[f"{src}.weight"]), (2, 3, 1, 0)).copy()}  # OIHW -> HWIO
    if f"{src}.bias" in sd:
        p["bias"] = array(sd[f"{src}.bias"])
    return p


def read_head(sd: Mapping) -> Optional[Dict]:
    if "head.proj.weight" in sd:
        return {"proj": read_linear(sd, "head.proj")}
    if "head.mlp.fc1.weight" in sd:
        return {"mlp": {"fc1": read_linear(sd, "head.mlp.fc1"), "fc2": read_linear(sd, "head.mlp.fc2")}}
    return None
