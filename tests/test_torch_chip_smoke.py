"""The shape lists and the report logic of ``chip_smoke.py`` on the CPU.

``chip_smoke.py`` holds each kernel at the main paths' shapes and fails on
inexact launch counts, so the shapes it derives are checked here against
RN50's layers; its per-shape summary (share of the bound, the shapes at
which a kernel is slower than its library call) is checked on made-up
records. Neither needs a card: the script imports torch and the port only
inside its phases.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from xclip_tpu_torch.models import factory  # noqa: E402


@pytest.fixture(scope="module")
def rn50():
    return factory.get_clip_cfg("RN50").vision


def test_eval_and_training_shapes_of_rn50(rn50):
    """36 fused-conv launches per 250-image eval batch (16 conv1, 16 conv3
    with the identity, 4 downsamples), 16 conv1 launches (K3) per
    128-image training forward, with RN50's widths."""
    shapes = chip_smoke.fused_conv_shapes(rn50, chip_smoke.BATCH)
    roles = [s[0] for s in shapes]
    assert len(shapes) == 36
    assert (roles.count("conv1"), roles.count("conv3"), roles.count("downsample")) == (16, 16, 4)
    assert all(ident == (role == "conv3") for role, _, _, _, ident, _ in shapes)
    assert {m for _, m, _, _, _, _ in shapes} == {784000, 196000, 49000, 12250}
    conv1 = chip_smoke.conv1_shapes(rn50, chip_smoke.TRAIN_BATCH)
    assert len(conv1) == 16 and conv1[0] == (401408, 64, 64) and conv1[-1] == (6272, 2048, 512)
    # the late layers summed apart as "deep_k": 7 distinct K1 shapes of the eval, 5 of K3
    k1 = {(m, k, c) for role, m, k, c, ident, _ in shapes if not ident and k >= chip_smoke.DEEP_K}
    assert len(k1) == 7 and (12250, 2048, 512) in k1
    assert len({s for s in conv1 if s[1] >= chip_smoke.DEEP_K}) == 5


def test_share_of_bound_and_slower_than_library():
    fast = {"kernel": "K1", "dtype": "bf16", "M": 12250, "K": 2048, "C": 512,
            "kernel_ms": 0.05, "library_ms": 0.08, "bound_ms": 0.026}
    slow = {"kernel": "K3", "dtype": "fp16", "M": 6272, "K": 2048, "C": 512,
            "kernel_ms": 0.1, "library_ms": 0.05, "bound_ms": 0.02}
    k5 = {"kernel": "K5", "dtype": "bf16", "shape": [8192, 8192],
          "kernel_ms": 0.099, "library_ms": 0.092, "bound_ms": 0.080}
    for rec in (fast, slow, k5):
        chip_smoke.share(rec)
    assert fast["share_of_bound"] == pytest.approx(0.52) and not fast["slower_than_library"]
    assert slow["share_of_bound"] == pytest.approx(0.2) and slow["slower_than_library"]
    assert chip_smoke.slower_list([fast, slow, k5]) == [
        "K3 fp16 M=6272 K=2048 C=512: 0.1000 > 0.0500 ms",
        "K5 bf16 8192x8192: 0.0990 > 0.0920 ms"]
