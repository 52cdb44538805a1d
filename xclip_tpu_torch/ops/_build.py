"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``ops/csrc/*.cu`` compile at first use, one ``nvcc`` per source started
together, for ``sm_90a`` (H100), into
``build/xclip_tpu_torch/libxclip_kernels.so`` under the repository root.
Each source has a plain C interface, so no PyTorch header is compiled and
a build takes seconds. The library is rebuilt when the hash of the sources
and flags changes. Importing this module builds nothing.

    python -m xclip_tpu_torch.ops._build    # build now and print nvcc's report
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

from xclip_tpu_torch._assets import REPO_ROOT

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "xclip_tpu_torch"
LIB_NAME = "libxclip_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: registers, shared memory and spills of every kernel, kept in build.log
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype codes of the C interface (csrc/common.cuh xk::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    return str(candidate) if candidate.exists() else None


def build() -> Path:
    """Compile the kernels if the library is missing or stale; return its path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path

    nvcc = _find_nvcc()
    objs = [BUILD_DIR / (src.stem + ".o") for src in _sources()]
    compiles = [[nvcc or "nvcc", *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's CUDA "
            "kernels need the CUDA toolkit. Tried to run: " + " ".join(compiles[0]))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = []
    failed = []
    for cmd, proc in zip(compiles, procs):
        out, _ = proc.communicate()
        logs.append("$ " + " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append("$ " + " ".join(link) + "\n" + res.stdout)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.xk_matmul_affine_act.argtypes = [i, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
            lib.xk_matmul_affine_act.restype = i
            lib.xk_matmul_stats.argtypes = [i, p, p, p, p, p, p, ctypes.c_longlong, i, i, p]
            lib.xk_matmul_stats.restype = i
            lib.xk_matmul_stats_tile_m.argtypes = []
            lib.xk_matmul_stats_tile_m.restype = i
            lib.xk_flash_attention.argtypes = [i, p, p, p, p, i, i, i, ctypes.c_float, i, p]
            lib.xk_flash_attention.restype = i
            lib.xk_stream_scale.argtypes = [p, p, ctypes.c_longlong, ctypes.c_float, p]
            lib.xk_stream_scale.restype = i
            _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())
    log = BUILD_DIR / "build.log"
    if log.exists():
        print(log.read_text())
