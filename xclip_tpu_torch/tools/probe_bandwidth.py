"""Streaming-bandwidth probe: the K5 kernel against ``torch.mul``.

Counterpart of ``tools/probe_mosaic.py``: scale an (8192, 8192) bf16 array
(``RandomState(0).rand``) by ``bf16(1.0001)``, once through ``torch.mul``
and once through the hand-written kernel (``ops.stream_scale``), and report
each as read + write GB/s and their ratio.

    python -m xclip_tpu_torch.tools.probe_bandwidth             # one launch per timed call
    python -m xclip_tpu_torch.tools.probe_bandwidth --chain 10  # 10 chained launches per timed call

On the card each rate is the mean over timed calls between CUDA events,
after one warm-up call: 20 calls of one launch, or with ``--chain N`` 5
calls of N launches, each feeding the next. ``--device cpu`` times the
plain version on the host clock and prints CPU rates.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.ops import stream_scale

SIDE = 8192  # tools/probe_mosaic.py's n


def _mean_ms(fn: Callable[[], torch.Tensor], reps: int, device: torch.device) -> float:
    fn()  # warm-up
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_probe(device: torch.device, *, side: int = SIDE, chain: int = 0) -> Dict[str, float]:
    """Time ``torch.mul`` and the kernel on a (side, side) bf16 array; the
    returned ms are per pass over the array."""
    x = torch.from_numpy(np.random.RandomState(0).rand(side, side).astype(np.float32))
    x = x.to(torch.bfloat16).to(device)
    nbytes = 2 * x.numel() * x.element_size()  # read x, write the output
    scale = stream_scale.PROBE_SCALE

    def chained(op):
        def fn():
            y = x
            for _ in range(chain):
                y = op(y, scale)
            return y
        return fn

    if chain:
        torch_fn, kernel_fn = chained(stream_scale.stream_scale_plain), chained(stream_scale.stream_scale)
        reps, passes = 5, chain
    else:
        torch_fn = lambda: stream_scale.stream_scale_plain(x, scale)  # noqa: E731
        kernel_fn = lambda: stream_scale.stream_scale(x, scale)  # noqa: E731
        reps, passes = 20, 1
    torch_ms = _mean_ms(torch_fn, reps, device) / passes
    kernel_ms = _mean_ms(kernel_fn, reps, device) / passes
    return {"side": side, "chain": chain, "bytes_per_pass": nbytes, "torch_ms": torch_ms,
            "kernel_ms": kernel_ms, "torch_stream_gbps": nbytes / torch_ms / 1e6,
            "kernel_stream_gbps": nbytes / kernel_ms / 1e6, "ratio": torch_ms / kernel_ms}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="bf16 streaming bandwidth: hand-written kernel vs torch.mul")
    parser.add_argument("--chain", type=int, default=0, help="launches chained in each timed call (0: one)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.chain < 0:
        parser.error("--chain must be >= 0")
    device = resolve_device(args.device)
    res = run_probe(device, side=SIDE, chain=args.chain)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    prefix = f"chain={args.chain} " if args.chain else ""
    print(f"device: {name}")
    print(f"{prefix}torch_stream_gbps: {res['torch_stream_gbps']:.1f}")
    print(f"{prefix}kernel_stream_gbps: {res['kernel_stream_gbps']:.1f}")
    print(f"ratio: {res['ratio']:.3f}")
    return res


if __name__ == "__main__":
    main()
