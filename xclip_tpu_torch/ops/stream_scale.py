"""Streaming copy-and-scale of a bf16 tensor (K5, the bandwidth probe's kernel).

Counterpart of the Pallas ``pallas_scale`` of ``tools/probe_mosaic.py``
(``o = x * bf16(1.0001)``): read x once, write a new tensor once.

- :func:`stream_scale` launches ``csrc/stream_scale.cu`` for CUDA tensors
  and uses the plain version for CPU tensors; nothing else.
- :func:`stream_scale_plain` is ``x * bf16(scale)`` in PyTorch, the CPU
  path and the kernel's reference.
- ``launches`` counts kernel launches.

``bf16(1.0001)`` rounds to exactly 1.0, so at the probe's scale the right
output equals its input bit for bit. The kernel always writes a freshly
allocated tensor; ``nan_fill_output=True`` fills it with NaN before the
launch, so a check that compares bits sees any element the kernel did not
write.
"""

from __future__ import annotations

import torch

from xclip_tpu_torch.ops import _build

launches = 0

PROBE_SCALE = 1.0001  # tools/probe_mosaic.py's factor


def _bf16_scale(scale: float) -> torch.Tensor:
    return torch.tensor(scale, dtype=torch.bfloat16)


def stream_scale_plain(x: torch.Tensor, scale: float = PROBE_SCALE) -> torch.Tensor:
    """``x * bf16(scale)``: fp32 product rounded to bf16 (torch.mul)."""
    return x * _bf16_scale(scale)  # a 0-dim CPU tensor acts as a scalar on any device


def stream_scale(x: torch.Tensor, scale: float = PROBE_SCALE, *, nan_fill_output: bool = False) -> torch.Tensor:
    """``x * bf16(scale)`` for a bf16 tensor, into a new contiguous tensor.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    the plain version. ``x`` must be contiguous; a view that starts off a
    16-byte boundary is taken by the kernel's scalar loop.
    """
    global launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"stream_scale takes bfloat16 tensors, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stream_scale needs a contiguous tensor")
    if x.device.type == "cpu":
        return stream_scale_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"stream_scale runs on CUDA or CPU tensors, not {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if nan_fill_output:
        out.fill_(float("nan"))
    n = x.numel()
    if n == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.xk_stream_scale(x.data_ptr(), out.data_ptr(), n, float(_bf16_scale(scale)), stream)
    if err != 0:
        raise RuntimeError(f"stream_scale kernel launch failed with CUDA error {err} (n={n})")
    launches += 1
    return out
