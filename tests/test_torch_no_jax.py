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


def test_modules_import_and_run_with_jax_blocked():
    """With an import hook that refuses jax, jaxlib and the JAX package, every
    module of the port imports, and the slice's CPU paths run: the
    bandwidth probe, an SAE train step, resample and checkpoint."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        root = name.split('.')[0]\n"
        "        if root in ('jax', 'jaxlib', 'xclip_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np, tempfile, torch\n"
        "from xclip_tpu_torch.tools import probe_bandwidth\n"
        "from xclip_tpu_torch.sae import losses, model, optim, pipeline, resampler\n"
        "probe_bandwidth.SIDE = 32\n"
        "probe_bandwidth.main(['--device', 'cpu', '--chain', '2'])\n"
        "p = model.sae_init(torch.Generator().manual_seed(0), model.SAECfg(8, 16, 1))\n"
        "p['encoder']['bias'][0, :3] = -100.0\n"
        "r = resampler.ActivationResampler(16, resample_interval=1, n_activations_activity_collate=1,\n"
        "                                  resample_dataset_size=32, seed=0)\n"
        "d = tempfile.mkdtemp()\n"
        "np.save(d + '/s.npy', np.random.RandomState(0).randn(64, 8).astype(np.float16))\n"
        "pipe = pipeline.Pipeline(p, losses.SAELossCfg(), optim.adam(1e-3), d, activation_resampler=r)\n"
        "pipe.run_pipeline(train_batch_size=16, train_fnames=[d + '/s.npy'])\n"
        "assert float(pipe.params['encoder']['bias'][0, 0]) == 0.0  # resampled\n"
        "print('OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
