"""The port stands alone: importing every module of ``xclip_tpu_torch``
pulls in neither jax nor any module of the JAX package ``xclip_tpu``, nor
scikit-learn, networkx, graphviz, webdataset or umap-learn (the machine
with the card has none of them), and no source file of the port (or
``chip_smoke.py``) imports them, or matplotlib outside a function."""

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'xclip_tpu', 'sklearn', 'networkx',\n"
        "                                                        'graphviz'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


_BANNED = "jax|jaxlib|xclip_tpu|sklearn|networkx|graphviz|webdataset|umap"
_FORBIDDEN = re.compile(rf"^\s*(import\s+({_BANNED})\b(?!_torch)|from\s+({_BANNED})\b(?!_torch))", re.MULTILINE)
_TOP_LEVEL_MATPLOTLIB = re.compile(r"^(import|from)\s+matplotlib\b", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), (f"{path} imports jax, the JAX package, scikit-learn, networkx, graphviz, "
                                         "webdataset or umap")
    assert not _TOP_LEVEL_MATPLOTLIB.search(text), f"{path} imports matplotlib at module level"


def test_forbidden_pattern_catches_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from xclip_tpu.ops import x",
                "import xclip_tpu", "  from jax import numpy", "import sklearn",
                "    from sklearn.metrics import f1_score", "import networkx as nx", "from graphviz import Digraph",
                "import webdataset as wds", "    import umap", "from umap import UMAP"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import xclip_tpu_torch", "from xclip_tpu_torch.ops import fused_conv",
               "# the JAX package xclip_tpu", "from xclip_tpu_torch.evals.umap import umap_embed"):
        assert not _FORBIDDEN.search(ok), ok
    assert _TOP_LEVEL_MATPLOTLIB.search("import matplotlib\n") and not _TOP_LEVEL_MATPLOTLIB.search(
        "    import matplotlib\n")


def test_modules_import_and_run_with_jax_blocked():
    """With an import hook that refuses jax, jaxlib, the JAX package and
    scikit-learn, every module of the port imports, and the slice's CPU
    paths run: the bandwidth probe, an SAE train step, resample and
    checkpoint, a ViT tower in train mode with patch dropout, a supervised
    classifier step with its native checkpoint, the macro F1, a tiny
    RN's class circuit with its graph, WL similarity and DOT source, CKA
    and concept names (networkx and graphviz refused too), DomainNet
    captions and an LSO mixture, a tar shard read, the embedding
    analysis (webdataset, umap-learn and matplotlib refused: no figures),
    and tiny towers of the timm families (EVA02 with RoPE, ConvNeXt, a
    SigLIP timm ViT and a relpos ViT) built through ``native_timm`` with
    ``tower_common``'s init."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "import importlib.machinery\n"
        "class Refuse(importlib.abc.Loader):\n"
        "    def create_module(self, spec):\n"
        "        raise ImportError('blocked: ' + spec.name)\n"
        "    def exec_module(self, module):\n"
        "        raise ImportError('blocked: ' + module.__name__)\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        root = name.split('.')[0]\n"
        "        if root in ('jax', 'jaxlib', 'xclip_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        if root in ('sklearn', 'networkx', 'graphviz', 'webdataset', 'umap', 'matplotlib'):  # refused on import\n"
        "            return importlib.machinery.ModuleSpec(name, Refuse())\n"
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
        "from xclip_tpu_torch.models import factory\n"
        "factory._MODEL_CONFIGS['T'] = {'embed_dim': 16, 'text_cfg': {'context_length': 8, 'vocab_size': 100,\n"
        "    'width': 64, 'heads': 1, 'layers': 1}, 'vision_cfg': {'image_size': 32, 'patch_size': 16, 'width': 64,\n"
        "    'layers': 1, 'patch_dropout': 0.5}}\n"
        "vit = factory.create_model('T', device='cpu').train()\n"
        "assert vit.encode_image(torch.randn(2, 32, 32, 3), generator=torch.Generator()).shape == (2, 16)\n"
        "from xclip_tpu_torch.train import learner\n"
        "factory._MODEL_CONFIGS['R'] = {'embed_dim': 16, 'text_cfg': {'context_length': 8, 'vocab_size': 100,\n"
        "    'width': 64, 'heads': 1, 'layers': 1}, 'vision_cfg': {'image_size': 32, 'layers': [1, 1, 1, 1],\n"
        "    'width': 8, 'patch_size': None}}\n"
        "learner.ClassifierCfg.backbone_name = property(lambda self: 'R')\n"
        "learner.ClassifierCfg.feature_dim = property(lambda self: 16)\n"
        "clf = learner.create_classifier(learner.ClassifierCfg(num_classes=5), device='cpu').train()\n"
        "step, _ = learner.make_classifier_train_step(clf, steps_per_epoch=1, precision='fp32')\n"
        "m = step(torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8), torch.tensor([0, 4]))\n"
        "assert np.isfinite(float(m['loss']))\n"
        "learner.save_classifier(d + '/c.npz', clf, {'epoch': 1})\n"
        "assert learner.load_classifier(d + '/c.npz', clf) == {'epoch': 1}\n"
        "from xclip_tpu_torch.evals.lso import f1_macro\n"
        "assert f1_macro(np.array([0, 1, 1]), np.array([0, 1, 2])) == (1 + 2 / 3 + 0) / 3\n"
        "from xclip_tpu_torch.interp import circuit_model, circuits, cka, graph\n"
        "from xclip_tpu_torch.sae import naming\n"
        "cm = circuit_model.VisualCircuitModel(factory.create_model('R', device='cpu'), np.eye(3, 16, dtype=np.float32))\n"
        "nodes, feats, edges = circuits.compute_class_circuit(cm, np.ones((1, 32, 32, 3), np.float32), 1, steps=2,\n"
        "                                                     out_folder=d + '/circ')\n"
        "g = graph.build_circuit_graph({k: v.act.numpy() for k, v in nodes.items()}, edges, feats)\n"
        "assert graph.wl_kernel_similarity([g, g])[0, 1] == 1.0 and graph.render_circuit_graphviz(g, d + '/g')\n"
        "x = np.random.RandomState(0).randn(8, 3)\n"
        "assert abs(cka.linear_cka(x, x) - 1.0) < 1e-12\n"
        "assert naming.decode_sae_config('ef4_lr1e-3') == {'expansion_factor': 4, 'lr': 1e-3}\n"
        "import io, os, tarfile, contextlib\n"
        "from PIL import Image\n"
        "from xclip_tpu_torch.data import captions, lso, wds\n"
        "from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX\n"
        "names = [f'c{i}' for i in range(345)]\n"
        "for cls, idx in LSO_CLASS_TO_IDX.items():\n"
        "    names[idx] = cls.replace(' ', '_')\n"
        "dn = d + '/domainnet'\n"
        "os.makedirs(dn)\n"
        "for dom in ('clipart', 'infograph', 'painting', 'quickdraw', 'real', 'sketch'):\n"
        "    for split in ('train', 'test'):\n"
        "        open(f'{dn}/{dom}_{split}.txt', 'w').write(''.join(f'{dom}/{c}/i.jpg {i}\\n' for i, c in enumerate(names)))\n"
        "captions.generate_domainnet_captions(dn)\n"
        "for split in ('train', 'val'):\n"
        "    open(f'{d}/in-captions-{split}.tsv', 'w').write('filepath\\ttitle\\n/x/a.jpg\\tcap\\n')\n"
        "assert lso.subsample_domainnet_lso(dn, d, exclude='sketch', subsample=True) == 'lso-cipqrs-nosketchclasses'\n"
        "with tarfile.open(d + '/s.tar', 'w') as tf:\n"
        "    buf = io.BytesIO()\n"
        "    Image.new('RGB', (8, 8)).save(buf, format='JPEG')\n"
        "    for name, data in (('a.jpg', buf.getvalue()), ('a.txt', b'cap')):\n"
        "        info = tarfile.TarInfo(name)\n"
        "        info.size = len(data)\n"
        "        tf.addfile(info, io.BytesIO(data))\n"
        "assert [s['text'] for s in wds.WebDatasetReader(d + '/s.tar')] == ['cap']\n"
        "from xclip_tpu_torch.scripts import embedding_analysis\n"
        "os.makedirs(d + '/f')\n"
        "np.save(d + '/f/img_feat.npy', np.random.RandomState(0).randn(40, 8).astype(np.float32))\n"
        "np.save(d + '/f/domain_ids.npy', np.arange(40) % 6)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    embedding_analysis.main(['--features_path', d + '/f', '--out_path', d + '/e', '--device', 'cpu'])\n"
        "assert 'figures: none' in out.getvalue() and np.load(d + '/e/embedding.npy').shape == (40, 2)\n"
        "from xclip_tpu_torch.models import convnext, eva, native_timm, timm_vit, tower_common\n"
        "for tcfg in (eva.EvaCfg('t', 8, image_size=32, patch_size=8, width=32, layers=1, heads=2, mlp_ratio=8 / 3,\n"
        "                        qkv_fused=False, swiglu=True, rope=True, ref_grid=4),\n"
        "             convnext.ConvNeXtCfg((1, 1, 1, 1), (8, 16, 16, 32), 8, image_size=32, proj='mlp'),\n"
        "             timm_vit.TimmViTCfg('t', 8, image_size=32, patch_size=8, width=32, layers=1, heads=2,\n"
        "                                 proj='linear'),\n"
        "             timm_vit.TimmViTCfg('t', 8, image_size=32, patch_size=8, width=32, layers=1, heads=2,\n"
        "                                 pool='token', proj='linear', class_token=True, rel_pos=True, rel_pos_dim=8)):\n"
        "    tower = native_timm.build(tcfg)\n"
        "    tower.init_parameters(torch.Generator().manual_seed(0))\n"
        "    assert isinstance(tower.trunk, torch.nn.Module) and tower_common.TRUNC_STD == 0.02\n"
        "    assert tower.eval()(torch.randn(2, 32, 32, 3)).shape == (2, 8)\n"
        "for banned in ('sklearn', 'networkx', 'graphviz', 'webdataset', 'umap', 'matplotlib'):\n"
        "    try:\n"
        "        __import__(banned)\n"
        "        raise AssertionError(banned + ' imported')\n"
        "    except ImportError:\n"
        "        pass\n"
        "print('OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
