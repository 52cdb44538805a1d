"""The port stands alone: importing every module of ``xclip_tpu_torch``
pulls in neither jax nor any module of the JAX package ``xclip_tpu``, and
no source file of the port (or ``chip_smoke.py``) imports them."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "xclip_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m.startswith('jaxlib.') or m == 'xclip_tpu' or m.startswith('xclip_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|jaxlib|xclip_tpu)\b(?!_torch)|from\s+(jax|jaxlib|xclip_tpu)\b(?!_torch))",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax or the JAX package"


def test_forbidden_pattern_catches_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from xclip_tpu.ops import x",
                "import xclip_tpu", "  from jax import numpy"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import xclip_tpu_torch", "from xclip_tpu_torch.ops import fused_conv",
               "# the JAX package xclip_tpu"):
        assert not _FORBIDDEN.search(ok), ok
