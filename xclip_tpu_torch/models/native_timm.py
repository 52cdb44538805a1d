"""Registry of the timm-tower families: the one place that knows the list.

Counterpart of ``xclip_tpu/models/native_timm.py:38-129``. open_clip builds
every ``vision_cfg.timm_model_name`` through timm; the port, like the JAX
package, has its own implementation of each family, and ``CLIP``, the
factory and the checkpoint bridge reach them only through this module:

- :func:`cfg_from_vision_dict` routes a timm vision config to the family
  that owns its ``timm_model_name`` and raises ``NotImplementedError`` for
  the families of a later slice (swin, ViTamin, MobileCLIP) and for names
  no family knows;
- :func:`build` returns the family's ``nn.Module`` (``visual``), whose
  ``run(images, dtype, capture)`` returns the features and the captured
  stages named by :func:`stage_names`;
- :func:`params_to_state_dict` / :func:`state_dict_to_params`: the JAX
  pytree bridge in open_clip's ``TimmModel`` naming (keys without
  ``visual.``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from xclip_tpu_torch.models import convnext, eva, timm_vit

# (cfg class, module, tower class)
_FAMILIES = (
    (convnext.ConvNeXtCfg, convnext, convnext.ConvNeXt),
    (timm_vit.TimmViTCfg, timm_vit, timm_vit.TimmViT),
    (eva.EvaCfg, eva, eva.Eva),
)

# timm names of the families still to port, by family (their JAX modules'
# VARIANTS tables)
LATER_FAMILIES = {
    "swin": ("swin_tiny_patch4_window7_224", "swin_base_patch4_window7_224"),
    "ViTamin": ("vitamin_small_224", "vitamin_base_224", "vitamin_large_224", "vitamin_large_256",
                "vitamin_large_336", "vitamin_large2_224", "vitamin_large2_256", "vitamin_large2_336",
                "vitamin_xlarge_256", "vitamin_xlarge_336", "vitamin_xlarge_384"),
    "MobileCLIP (mci_vit)": ("vit_base_mci_224",),
    "MobileCLIP (fastvit)": ("fastvit_mci1", "fastvit_mci2"),
}


def is_native_timm(vision_cfg) -> bool:
    return any(isinstance(vision_cfg, cls) for cls, _, _ in _FAMILIES)


def cfg_from_vision_dict(v: dict, embed_dim: int):
    name = v["timm_model_name"]
    for _, mod, _ in _FAMILIES:
        if name in mod.VARIANTS:
            return mod.cfg_from_vision_dict(v, embed_dim)
    for family, names in LATER_FAMILIES.items():
        if name in names:
            raise NotImplementedError(f"timm tower {name!r} belongs to the {family} family, which is not "
                                      "ported yet (a later slice)")
    known = sorted(n for _, mod, _ in _FAMILIES for n in mod.VARIANTS)
    raise NotImplementedError(f"timm tower {name!r} is not implemented; the ported variants: {known}")


def _entry(vision_cfg):
    for cls, mod, tower in _FAMILIES:
        if isinstance(vision_cfg, cls):
            return mod, tower
    raise TypeError(f"not a timm tower config: {type(vision_cfg)!r}")


def build(vision_cfg) -> nn.Module:
    return _entry(vision_cfg)[1](vision_cfg)


def stage_names(vision_cfg) -> List[str]:
    return _entry(vision_cfg)[0].stage_names(vision_cfg)


def params_to_state_dict(params: Mapping, vision_cfg) -> Dict[str, torch.Tensor]:
    return _entry(vision_cfg)[0].params_to_state_dict(params, vision_cfg)


def state_dict_to_params(sd: Mapping, vision_cfg) -> Dict:
    return _entry(vision_cfg)[0].state_dict_to_params(sd, vision_cfg)
