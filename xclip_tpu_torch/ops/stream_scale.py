"""Streaming copy-and-scale of a bf16 tensor (K5, the bandwidth probe's kernel).

Counterpart of the Pallas ``pallas_scale`` of ``tools/probe_mosaic.py``
(``o = x * bf16(1.0001)``): read x once, write a new tensor once.

- :func:`stream_scale` launches ``csrc/stream_scale.cu`` for CUDA tensors
  and uses the plain version for CPU tensors; nothing else.
- :func:`stream_scale_plain` is ``x * bf16(scale)`` in PyTorch, the CPU
  path and the kernel's reference.
- ``launches`` counts kernel launches.
- :func:`geometry` and :func:`edge_lengths` place lengths on the kernel's
  block and wave boundaries, for the tests that hold it there.

``bf16(1.0001)`` rounds to exactly 1.0, so at the probe's scale the right
output equals its input bit for bit. The kernel always writes a freshly
allocated tensor; ``nan_fill_output=True`` fills it with NaN before the
launch, so a check that compares bits sees any element the kernel did not
write.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from xclip_tpu_torch.ops import _build

launches = 0

PROBE_SCALE = 1.0001  # tools/probe_mosaic.py's factor

# K5's edge cases, in the order of :func:`edge_lengths`
EDGE_CASES = ("below_one_block", "below_one_block_ragged", "one_block", "one_block_plus_1",
              "one_block_and_a_row_plus_3", "wave_plus_1", "wave_plus_7", "wave_plus_8", "two_waves_plus_13")


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


def geometry(device: int = 0) -> Dict[str, int]:
    """The vector kernel's threads per block, 16-byte loads per thread,
    resident blocks per SM and the card's SMs (asked of the kernel's
    library, so CUDA only)."""
    lib = _build.load_library()
    threads, vecs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.xk_stream_scale_geometry(ctypes.byref(threads), ctypes.byref(vecs), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"stream_scale's occupancy query failed with CUDA error {err}")
    return {"threads": threads.value, "vecs_per_thread": vecs.value, "blocks_per_sm": per_sm.value,
            "sms": torch.cuda.get_device_properties(device).multi_processor_count}


def edge_lengths(threads: int, vecs_per_thread: int, blocks_per_sm: int, sms: int) -> Dict[str, int]:
    """Lengths on the kernel's edges (:data:`EDGE_CASES`): a row is one
    16-byte load (8 elements) of every thread of a block, a block
    ``vecs_per_thread`` rows, a wave one block in every block slot of the
    card; tails of 1 to 7 elements go to the scalar code."""
    row = threads * 8
    block = row * vecs_per_thread
    wave = sms * blocks_per_sm * block
    lengths = {"below_one_block": block - 8, "below_one_block_ragged": block - 3, "one_block": block,
               "one_block_plus_1": block + 1, "one_block_and_a_row_plus_3": block + row + 3,
               "wave_plus_1": wave + 1, "wave_plus_7": wave + 7, "wave_plus_8": wave + 8,
               "two_waves_plus_13": 2 * wave + 13}
    assert tuple(lengths) == EDGE_CASES
    return lengths
