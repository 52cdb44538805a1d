"""The port's SAE slice against ``xclip_tpu.sae`` on the CPU in fp32.

Inputs are made from a seed with numpy and handed to both packages; JAX's
parameters are carried across with ``sae_params_from_numpy`` (``jax.random``
cannot be reproduced in torch). Sizes are the JAX package's own test sizes
(d=16, m=32, batches of 64). Tolerances, fp32 on both sides, differing in
summation order only:

- forward 1e-6 absolute; loss terms, unit-norm projection and the parallel
  gradient removal 1e-6 relative;
- one train step: loss rtol 1e-5, parameters and Adam moments within 1e-5
  of each tensor's largest magnitude; the moment reset exact;
- the resampler, fed identical loss arrays: the same dead indices and
  draws, updates within 1e-6;
- a pipeline run of three epochs over two shards with a forced resample:
  the same shard order, final parameters within 1e-4 of scale;
- the feature cache of a tiny RN CLIP: fp32 features within 1e-4, fp16
  shards within one fp16 ulp.

The JAX package's resampler cannot write resampled neurons into the
components layout (its update broadcasts (n, 1, d) into (n, d)); the port's
components layout is held against JAX's plain layout on the same data.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import xclip_tpu.models.factory as jax_factory
from test_torch_models import TINY, _randomize_bn, release_memory_after_module  # noqa: F401
from xclip_tpu.core.checkpoint import save_open_clip_checkpoint
from xclip_tpu.data import datasets as jax_datasets
from xclip_tpu.data.transforms import image_transform as jax_image_transform
from xclip_tpu.evals.features import extract_image_features as jax_extract_image_features
from xclip_tpu.evals.lso import domain_ids_from_samples as jax_domain_ids
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.sae import cache as jax_cache
from xclip_tpu.sae import losses as jax_losses
from xclip_tpu.sae import metrics as jax_metrics
from xclip_tpu.sae import model as jax_model
from xclip_tpu.sae import optim as jax_optim
from xclip_tpu.sae import pipeline as jax_pipeline
from xclip_tpu.sae import resampler as jax_resampler
from xclip_tpu_torch.data import datasets as port_datasets
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.models import factory as port_factory
from xclip_tpu_torch.sae import cache, losses, metrics, model, optim, pipeline, resampler
from xclip_tpu_torch.scripts import save_domainnet_features, train_sae

D, M, B = 16, 32, 64
DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(components, seed=0, d=D, m=M):
    cfg = jax_model.SAECfg(d, m, n_components=components)
    return jax.device_get(jax_model.sae_init(jax.random.PRNGKey(seed), cfg))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(components, n=B, seed=1, d=D):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32) * 0.5 + 0.1
    return x[:, None, :] if components else x


def _scale_err(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_tree_close(port_params, jax_params, tol):
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(_np(jax_params))[0],
                                 jax.tree_util.tree_leaves(model.sae_params_to_numpy(port_params))):
        assert got.shape == want.shape, path
        assert _scale_err(got, want) <= tol, (path, _scale_err(got, want))


@pytest.mark.parametrize("components", [None, 1])
def test_sae_apply_matches_jax(components):
    p = _jax_params(components)
    x = _x(components)
    want_l, want_d = jax_model.sae_apply(p, jnp.asarray(x))
    got_l, got_d = model.sae_apply(model.sae_params_from_numpy(p), torch.from_numpy(x))
    assert got_l.shape == want_l.shape and got_d.shape == want_d.shape
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6, rtol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("components", [None, 1])
def test_losses_match_jax(reduction, components):
    p = _jax_params(components)
    x = _x(components)
    learned, decoded = jax_model.sae_apply(p, jnp.asarray(x))
    cfg = dict(l1_coefficient=3e-4, l2_reduction=reduction)
    want_loss, want = jax_losses.sae_loss(jax_losses.SAELossCfg(**cfg), jnp.asarray(x), learned, decoded)
    got_loss, got = losses.sae_loss(losses.SAELossCfg(**cfg), torch.from_numpy(x),
                                    torch.from_numpy(np.array(learned)), torch.from_numpy(np.array(decoded)))
    assert set(got) == set(want) and len(got) == 4
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    items = losses.loss_per_item(losses.SAELossCfg(**cfg), torch.from_numpy(x),
                                 torch.from_numpy(np.array(learned)), torch.from_numpy(np.array(decoded)))
    want_items = jax_losses.loss_per_item(jax_losses.SAELossCfg(**cfg), jnp.asarray(x), learned, decoded)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items), rtol=1e-6)


def test_loss_cfg_refuses_unknown_reduction():
    with pytest.raises(ValueError, match="l2_reduction"):
        losses.SAELossCfg(l2_reduction="max")


@pytest.mark.parametrize("components", [None, 1])
def test_metrics_match_jax(components):
    p = _jax_params(components)
    x = _x(components)
    learned, decoded = jax_model.sae_apply(p, jnp.asarray(x))
    tl, td = torch.from_numpy(np.array(learned)), torch.from_numpy(np.array(decoded))
    for name in ("l0_norm", "feature_density", "capacities", "neuron_activity"):
        want = np.asarray(getattr(jax_metrics, name)(learned))
        got = getattr(metrics, name)(tl).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    want = jax_metrics.train_metrics(jnp.asarray(x), learned, decoded)
    got = metrics.train_metrics(torch.from_numpy(x), tl, td)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    rng = np.random.RandomState(2)
    args = (rng.rand(8), rng.rand(8) + 1, rng.rand(8) + 3)
    assert metrics.model_reconstruction_score(*args) == jax_metrics.model_reconstruction_score(*args)


@pytest.mark.parametrize("components", [None, 1])
def test_unit_norm_and_parallel_gradient_match_jax(components):
    p = _jax_params(components)
    rng = np.random.RandomState(3)
    p["decoder"]["weight"] = np.asarray(p["decoder"]["weight"]) * (rng.rand(*np.shape(p["decoder"]["weight"])) + 1)
    grads = jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)).astype(np.float32), _np(p))
    want_p = _np(jax_model.constrain_decoder_unit_norm(p))
    want_g = _np(jax_model.remove_parallel_gradient(want_p, grads))
    got_p = model.constrain_decoder_unit_norm(model.sae_params_from_numpy(p))
    got_g = model.remove_parallel_gradient(got_p, model.sae_params_from_numpy(grads))
    np.testing.assert_allclose(got_p["decoder"]["weight"].numpy(), want_p["decoder"]["weight"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(torch.linalg.vector_norm(got_p["decoder"]["weight"], dim=-2).numpy(), 1.0, atol=1e-6)
    assert _scale_err(got_g["decoder"]["weight"].numpy(), want_g["decoder"]["weight"]) <= 1e-6
    dots = torch.sum(got_g["decoder"]["weight"] * got_p["decoder"]["weight"], dim=-2)
    assert float(dots.abs().max()) <= 1e-5
    # the other gradients pass through untouched
    assert torch.equal(got_g["encoder"]["weight"], torch.from_numpy(grads["encoder"]["weight"]))


def test_sae_init_distributions_and_state_dict_bridge():
    for components in (None, 2):
        cfg = model.SAECfg(D, M, n_components=components)
        p = model.sae_init(torch.Generator().manual_seed(0), cfg)
        c = () if components is None else (components,)
        assert p["tied_bias"].shape == (*c, D) and not p["tied_bias"].any()
        assert p["encoder"]["weight"].shape == (*c, M, D) and p["decoder"]["weight"].shape == (*c, D, M)
        assert float(p["encoder"]["weight"].abs().max()) <= np.sqrt(6 / D)
        assert float(p["encoder"]["bias"].abs().max()) <= 1 / np.sqrt(D)
        np.testing.assert_allclose(torch.linalg.vector_norm(p["decoder"]["weight"], dim=-2).numpy(), 1, atol=1e-6)
        again = model.sae_init(torch.Generator().manual_seed(0), cfg)
        assert all(torch.equal(a, b) for a, b in zip(model.tree_leaves(p), model.tree_leaves(again)))
        sd = model.sae_params_to_state_dict(p)
        assert sorted(sd) == ["decoder._weight", "encoder._bias", "encoder._weight", "tied_bias"]
        back = model.sae_state_dict_to_params(sd)
        assert all(torch.equal(a, b) for a, b in zip(model.tree_leaves(p), model.tree_leaves(back)))
        # the JAX bridge reads the port's state dict, and the public key form loads too
        jp = jax_model.sae_state_dict_to_params({k: v.numpy() for k, v in sd.items()})
        _assert_tree_close(p, jp, 0.0)
        public = {"tied_bias": sd["tied_bias"], "encoder.weight": sd["encoder._weight"],
                  "encoder.bias": sd["encoder._bias"], "decoder.weight": sd["decoder._weight"]}
        assert torch.equal(model.sae_state_dict_to_params(public)["encoder"]["bias"], p["encoder"]["bias"])


def test_adam_matches_optax():
    """Five Adam steps on random gradients: optax's update order."""
    p = _jax_params(None)
    tx = jax_optim.adam(1e-3, b1=0.8, b2=0.99, eps=1e-6)
    state = tx.init(p)
    adam = optim.adam(1e-3, b1=0.8, b2=0.99, eps=1e-6)
    port_p = model.sae_params_from_numpy(p)
    port_state = adam.init(port_p)
    rng = np.random.RandomState(4)
    for _ in range(5):
        g = jax.tree_util.tree_map(lambda a: (rng.randn(*np.shape(a)) * 1e-3).astype(np.float32), _np(p))
        updates, state = tx.update(g, state, p)
        p = jax.device_get(jax.tree_util.tree_map(lambda a, u: a + u, p, updates))
        port_p = adam.update(model.sae_params_from_numpy(g), port_state, port_p)
    assert port_state.count == 5
    _assert_tree_close(port_p, p, 1e-6)
    _assert_tree_close(port_state.mu, state[0].mu, 1e-6)
    _assert_tree_close(port_state.nu, state[0].nu, 1e-6)


def _jax_pipeline(params, tmp_path, **kw):
    return jax_pipeline.Pipeline(params, jax_losses.SAELossCfg(3e-4), jax_optim.adam(1e-3), str(tmp_path / "jax"),
                                 **kw)


def _port_pipeline(params, tmp_path, **kw):
    return pipeline.Pipeline(model.sae_params_from_numpy(params), losses.SAELossCfg(3e-4), optim.adam(1e-3),
                             str(tmp_path / "port"), **kw)


@pytest.mark.parametrize("components", [None, 1])
def test_train_step_matches_jax(components, tmp_path):
    p = _jax_params(components)
    x = _x(components)
    jp = _jax_pipeline(p, tmp_path)
    want_p, want_state, want_m, want_fired = jp._train_step(p, jp.opt_state, jnp.asarray(x))
    port = _port_pipeline(p, tmp_path)
    got_p, got_m, got_fired = pipeline.train_step(port.params, port.optimizer, port.opt_state, port.loss_cfg,
                                                  torch.from_numpy(x))
    np.testing.assert_allclose(float(got_m["total_loss"]), float(want_m["total_loss"]), rtol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got_fired.numpy(), np.asarray(want_fired))
    _assert_tree_close(got_p, want_p, 1e-5)
    _assert_tree_close(port.opt_state.mu, want_state[0].mu, 1e-5)
    _assert_tree_close(port.opt_state.nu, want_state[0].nu, 1e-5)
    assert port.opt_state.count == int(want_state[0].count) == 1
    # the step leaves its inputs alone and the decoder at unit norm
    _assert_tree_close(port.params, p, 0.0)
    np.testing.assert_allclose(torch.linalg.vector_norm(got_p["decoder"]["weight"], dim=-2).numpy(), 1, atol=1e-6)


@pytest.mark.parametrize("components", [None, 1])
def test_reset_neuron_moments_exact(components):
    p = _jax_params(components)
    tx = jax_optim.adam(1e-3)
    rng = np.random.RandomState(5)
    g = jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)).astype(np.float32), _np(p))
    _, state = tx.update(g, tx.init(p), p)
    dead = np.array([1, 3, 30])
    want = jax_optim.reset_neuron_moments(state, dead, has_components=components is not None)
    adam = optim.adam(1e-3)
    port_state = adam.init(model.sae_params_from_numpy(p))
    adam.update(model.sae_params_from_numpy(g), port_state, model.sae_params_from_numpy(p))
    optim.reset_neuron_moments(port_state, dead, has_components=components is not None)
    for got, w in ((port_state.mu, want[0].mu), (port_state.nu, want[0].nu)):
        for a, b in zip(jax.tree_util.tree_leaves(model.sae_params_to_numpy(got)),
                        jax.tree_util.tree_leaves(_np(w))):
            np.testing.assert_array_equal(a, b)
    enc = port_state.mu["encoder"]["weight"].numpy()
    enc = enc[0] if components else enc
    assert not enc[dead].any() and enc[0].any()
    assert optim.reset_neuron_moments(port_state, np.array([], np.int64)) is port_state


def _dead_params(components, seed=0, dead=(2, 7, 11)):
    """JAX params whose encoder biases make ``dead`` never fire."""
    p = _jax_params(components, seed=seed)
    b = np.array(p["encoder"]["bias"])
    (b[0] if components else b)[list(dead)] = -100.0
    p["encoder"]["bias"] = b
    return jax.tree_util.tree_map(jnp.asarray, p)


def _squeeze(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[0], params)


@pytest.mark.parametrize("components", [None, 1])
def test_resampler_matches_jax(components, monkeypatch):
    """Port (plain or components layout) vs JAX (plain layout) on one store:
    the same loss up to fp32 summation order; then, fed JAX's loss array,
    the same dead indices, draws and updated parameters."""
    p = _dead_params(components)
    store = np.random.RandomState(6).randn(256, D).astype(np.float16)
    fired = np.ones(M, np.int64)
    fired[[2, 7, 11]] = 0
    kw = dict(n_learned_features=M, resample_interval=100, n_activations_activity_collate=100,
              resample_dataset_size=128, seed=3)
    jax_r = jax_resampler.ActivationResampler(**kw)
    port_r = resampler.ActivationResampler(**kw)
    jax_p = _squeeze(p) if components else p
    seen = {}
    orig = jax_resampler.ActivationResampler.compute_loss_and_get_activations

    def record(self, *a, **k):
        seen["loss"], seen["inputs"] = orig(self, *a, **k)
        return seen["loss"], seen["inputs"]

    monkeypatch.setattr(jax_resampler.ActivationResampler, "compute_loss_and_get_activations", record)
    want = jax_r.step_resampler(fired, store, jax_p, jax_losses.SAELossCfg(3e-4), 32)
    port_orig = resampler.ActivationResampler.compute_loss_and_get_activations

    def identical_loss(self, *a, **k):
        loss, inputs = port_orig(self, *a, **k)
        np.testing.assert_allclose(loss, seen["loss"], rtol=1e-5)
        np.testing.assert_array_equal(inputs, seen["inputs"])
        return seen["loss"], inputs

    monkeypatch.setattr(resampler.ActivationResampler, "compute_loss_and_get_activations", identical_loss)
    port_store = store[:, None, :] if components else store
    got = port_r.step_resampler(fired, port_store, model.sae_params_from_numpy(p), losses.SAELossCfg(3e-4), 32)
    np.testing.assert_array_equal(got.dead_neuron_indices, [2, 7, 11])
    np.testing.assert_array_equal(got.dead_neuron_indices, want.dead_neuron_indices)
    for f in ("dead_encoder_weight_updates", "dead_encoder_bias_updates", "dead_decoder_weight_updates"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=1e-6, rtol=0, err_msg=f)
    assert port_r._rng.randint(1 << 30) == jax_r._rng.randint(1 << 30)  # the same draws were consumed
    new = resampler.apply_parameter_updates(model.sae_params_from_numpy(p), got)
    want_p = jax_resampler.apply_parameter_updates(jax_p, want)
    _assert_tree_close(model.tree_map(lambda t: t[0], new) if components else new, want_p, 1e-6)
    assert float(new["encoder"]["bias"].reshape(-1, M)[0, 2]) == 0.0


def test_jax_resampler_fails_in_the_components_layout():
    """The reference caveat the port works around: JAX's update of a
    resampled neuron in the (batch, 1, d) layout does not broadcast."""
    p = _dead_params(1)
    r = jax_resampler.ActivationResampler(n_learned_features=M, resample_interval=100,
                                          n_activations_activity_collate=100, resample_dataset_size=128)
    store = np.random.RandomState(6).randn(256, 1, D).astype(np.float16)
    fired = np.ones(M, np.int64)
    fired[2] = 0
    updates = r.step_resampler(fired, store, p, jax_losses.SAELossCfg(3e-4), 32)
    with pytest.raises(ValueError, match="broadcast"):
        jax_resampler.apply_parameter_updates(p, updates)


@pytest.mark.parametrize("components", [None, 1])
def test_run_pipeline_matches_jax(components, tmp_path, monkeypatch):
    """Three epochs over two shards, a resample forced by dead neurons after
    each pass (JAX in the plain layout, the port in ``components``): the
    same shard order and final parameters; the final ``.pt`` of each loads
    in the other package."""
    p = _dead_params(components, seed=1)
    rng = np.random.RandomState(7)
    shards = []
    for i in range(2):
        path = tmp_path / f"shard{i}.npy"
        np.save(path, (rng.randn(256, D) * 0.5 + 0.1).astype(np.float16))
        shards.append(str(path))
    kw = dict(n_learned_features=M, resample_interval=256, n_activations_activity_collate=256,
              resample_dataset_size=128, resample_epoch_freq=2, seed=0)
    orders = {"jax": [], "port": []}
    for key, mod in (("jax", jax_pipeline), ("port", pipeline)):
        orig = mod.Pipeline.get_activation_store

        def record(self, fname, _orig=orig, _key=key):
            orders[_key].append(fname)
            return _orig(self, fname)

        monkeypatch.setattr(mod.Pipeline, "get_activation_store", record)
    jp = _jax_pipeline(_squeeze(p) if components else p, tmp_path,
                       activation_resampler=jax_resampler.ActivationResampler(**kw), seed=5)
    port = _port_pipeline(p, tmp_path, activation_resampler=resampler.ActivationResampler(**kw), seed=5)
    resampled = []
    orig_update = pipeline.Pipeline.update_parameters
    monkeypatch.setattr(pipeline.Pipeline, "update_parameters",
                        lambda self, u: (resampled.append(len(u.dead_neuron_indices)), orig_update(self, u)))
    run = dict(train_batch_size=B, num_epochs=3, train_fnames=shards, train_val_fnames=[shards[0]],
               val_frequency=512, checkpoint_frequency=768)
    jp.run_pipeline(**run)
    port.run_pipeline(**run)
    assert orders["port"] == orders["jax"] and len(orders["port"]) == 6 + 3  # 6 passes, 3 validations
    assert resampled and resampled[0] >= 3  # the forced dead neurons were resampled
    got = model.tree_map(lambda t: t[0], port.params) if components else port.params
    _assert_tree_close(got, jp.params, 1e-4)
    assert port.total_activations_trained_on == jp.total_activations_trained_on == 6 * 256
    ckpts = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert ckpts == sorted(f.name for f in (tmp_path / "jax").iterdir()) == [
        "sparse_autoencoder_1536.pt", "sparse_autoencoder_768.pt", "sparse_autoencoder_final.pt"]
    # .pt round trips: each package loads the other's final checkpoint
    port_sd = torch.load(tmp_path / "port" / "sparse_autoencoder_final.pt", weights_only=True)
    from_port = jax_model.sae_state_dict_to_params({k: v.numpy() for k, v in port_sd.items()})
    _assert_tree_close(port.params, from_port, 0.0)
    jax_sd = torch.load(tmp_path / "jax" / "sparse_autoencoder_final.pt", weights_only=True)
    _assert_tree_close(model.sae_state_dict_to_params(jax_sd), jp.params, 0.0)
    val = port.validation(port.get_activation_store(shards[0]), B)
    want_val = jp.validation(jp.get_activation_store(shards[0]), B)
    for k in want_val:
        np.testing.assert_allclose(val[k], want_val[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("components", [None, 1])
def test_resample_writes_unit_store_rows(components, tmp_path, monkeypatch):
    """What a resample writes, read off the pipeline's parameters and Adam
    moments around ``update_parameters``: at the dead neurons, decoder
    columns that are unit store rows (distinct rows), encoder rows in the
    same directions at 0.2x the mean alive encoder-row norm, zero encoder
    biases and zero moments; everything else untouched, bit for bit."""
    p = _dead_params(components, seed=2)
    store = (np.random.RandomState(9).randn(256, D) * 0.5 + 0.1).astype(np.float16)
    np.save(tmp_path / "shard.npy", store)
    r = resampler.ActivationResampler(M, resample_interval=256, n_activations_activity_collate=256,
                                      resample_dataset_size=128, seed=4)
    port = _port_pipeline(p, tmp_path, activation_resampler=r, seed=6)
    seen = []
    orig = pipeline.Pipeline.update_parameters

    def record(self, updates):
        before = model.tree_map(torch.clone, {"p": self.params, "mu": self.opt_state.mu, "nu": self.opt_state.nu})
        orig(self, updates)
        seen.append((updates.dead_neuron_indices, before,
                     model.tree_map(torch.clone, {"p": self.params, "mu": self.opt_state.mu, "nu": self.opt_state.nu})))

    monkeypatch.setattr(pipeline.Pipeline, "update_parameters", record)
    port.run_pipeline(train_batch_size=B, train_fnames=[str(tmp_path / "shard.npy")])
    assert len(seen) == 1
    dead, before, after = seen[0]
    assert {2, 7, 11} <= set(dead.tolist()) and len(dead) < M

    def c0(t):  # component 0, learned features first
        return t[0] if components else t

    dead_t = torch.as_tensor(dead)
    alive = torch.ones(M, dtype=torch.bool)
    alive[dead_t] = False
    dec = c0(after["p"]["decoder"]["weight"])[:, dead_t].T.double()  # (n_dead, d)
    np.testing.assert_allclose(dec.norm(dim=1).numpy(), 1.0, atol=2e-3)
    unit_store = torch.from_numpy(store).double()
    unit_store = unit_store / unit_store.norm(dim=1, keepdim=True)
    cos = (dec / dec.norm(dim=1, keepdim=True)) @ unit_store.T
    best = cos.max(dim=1)
    assert float(best.values.min()) > 1 - 1e-5
    assert len(set(best.indices.tolist())) == len(dead)  # drawn without replacement
    enc = c0(after["p"]["encoder"]["weight"])[dead_t].double()
    want_norm = 0.2 * float(c0(before["p"]["encoder"]["weight"])[alive].double().norm(dim=1).mean())
    np.testing.assert_allclose(enc.norm(dim=1).numpy(), want_norm, rtol=2e-3)
    np.testing.assert_allclose((enc / enc.norm(dim=1, keepdim=True) * (dec / dec.norm(dim=1, keepdim=True)))
                               .sum(dim=1).numpy(), 1.0, atol=1e-5)
    assert not c0(after["p"]["encoder"]["bias"])[dead_t].any()
    for part in ("mu", "nu"):
        assert not c0(after[part]["encoder"]["weight"])[dead_t].any()
        assert not c0(after[part]["encoder"]["bias"])[dead_t].any()
        assert not c0(after[part]["decoder"]["weight"])[:, dead_t].any()
    for part in ("p", "mu", "nu"):
        for key, axis in ((("encoder", "weight"), 0), (("encoder", "bias"), 0), (("decoder", "weight"), 1)):
            got, want = c0(after[part][key[0]][key[1]]), c0(before[part][key[0]][key[1]])
            keep = alive if axis == 0 else (slice(None), alive)
            assert torch.equal(got[keep], want[keep]), (part, key)
        assert torch.equal(after[part]["tied_bias"], before[part]["tied_bias"])


def test_load_activation_shard_formats(tmp_path):
    a = np.random.RandomState(8).randn(5, 4).astype(np.float16)
    np.save(tmp_path / "a.npy", a)
    np.savez(tmp_path / "a.npz", feats=a)
    torch.save(torch.from_numpy(a), tmp_path / "a.pt")
    for name in ("a.npy", "a.npz", "a.pt"):
        got = pipeline.load_activation_shard(str(tmp_path / name))
        np.testing.assert_array_equal(got, jax_pipeline.load_activation_shard(str(tmp_path / name)))
        assert got.dtype == np.float16


# --- datasets, the feature cache and the CLIs ------------------------------


@pytest.fixture(scope="module")
def dn_tree(tmp_path_factory):
    """Six domains, 10 train and 2 test images each (28-47 px JPEGs), rows
    path<TAB>label<TAB>caption; plus a CC12M-style TSV of the real ones."""
    root = tmp_path_factory.mktemp("dn_tree")
    rng = np.random.RandomState(0)
    for domain in DOMAINS:
        for split, n in (("train", 10), ("test", 2)):
            rows = []
            for i in range(n):
                cls = int(rng.randint(0, 345))
                rel = f"{domain}/c{cls}/{split}{i}.jpg"
                (root / rel).parent.mkdir(parents=True, exist_ok=True)
                h, w = rng.randint(28, 48, size=2)
                Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(root / rel)
                rows.append(f"{rel}\t{cls}\ta {domain} of thing {cls}.")
            (root / f"{domain}_{split}.tsv").write_text("\n".join(rows) + "\n")
    lines = ["filepath\ttitle"] + [f"{root}/real/{p.parent.name}/{p.name}\tcaption {i}"
                                   for i, p in enumerate(sorted((root / "real").rglob("*.jpg")))]
    (root / "cc12m-train.tsv").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def tiny_rn_ckpt(tmp_path_factory):
    jax_model_ = CLIPModel(jax_factory.clip_cfg_from_dict(TINY))
    params, state = jax.device_get(jax_model_.init(jax.random.PRNGKey(0)))
    _randomize_bn(params["visual"], state["visual"], np.random.RandomState(1))
    path = tmp_path_factory.mktemp("ckpt") / "epoch_1.pt"
    save_open_clip_checkpoint(str(path), jax_model_, params, state, epoch=1)
    return path, jax_model_, params, state


@pytest.mark.parametrize("mode", ["none", "label", "caption", "label+caption"])
def test_domainnet_modes_match_jax(dn_tree, mode):
    port = port_datasets.DomainNetCaptions(str(dn_tree), "train", image_transform(32), mode=mode)
    want = jax_datasets.DomainNetCaptions(str(dn_tree), "train", jax_image_transform(32, False), mode=mode)
    assert port.samples == want.samples and len(port) == 60
    for i in (0, 13):
        got, w = port[i], want[i]
        got, w = (got, w) if isinstance(w, tuple) else ((got,), (w,))
        assert len(got) == len(w)
        np.testing.assert_array_equal(got[0], w[0])
        assert got[1:] == tuple(w[1:])
    default = port_datasets.DomainNetCaptions(str(dn_tree), "val", image_transform(32))
    assert isinstance(default[0], tuple) and default[0][1] == default.samples[0][1]
    with pytest.raises(ValueError, match="mode"):
        port_datasets.DomainNetCaptions(str(dn_tree), "train", image_transform(32), mode="labels")
    drop = {"real": {0, 1}}  # labels dropped from real: JAX's class filter and per-domain counts
    port = port_datasets.DomainNetCaptions(str(dn_tree), "val", image_transform(32), exclude_domains=["sketch"],
                                           filter_classes=drop)
    want = jax_datasets.DomainNetCaptions(str(dn_tree), "val", jax_image_transform(32, False),
                                          exclude_domains=["sketch"], filter_classes=drop)
    assert port.samples == want.samples and port.samples_per_domain == want.samples_per_domain


@pytest.mark.parametrize("return_caption", [True, False])
def test_tsv_return_caption_matches_jax(dn_tree, return_caption):
    tsv = str(dn_tree / "cc12m-train.tsv")
    port = port_datasets.TsvDataset(tsv, image_transform(32), return_caption=return_caption)
    want = jax_datasets.TsvDataset(tsv, jax_image_transform(32, False), return_caption=return_caption)
    got, w = port[1], want[1]
    if return_caption:
        np.testing.assert_array_equal(got[0], w[0])
        assert got[1] == w[1] == "caption 1"
    else:
        np.testing.assert_array_equal(got, w)


def test_concat_datasets_matches_jax(dn_tree):
    parts = [list(range(12)), [], list(range(100, 104))]
    got, want = cache.concat_datasets(parts), jax_cache.concat_datasets(parts)
    assert len(got) == len(want) == 16
    assert [got[i] for i in range(16)] == [want[i] for i in range(16)]
    images = cache.concat_datasets([
        port_datasets.DomainNetCaptions(str(dn_tree), "val", image_transform(32), mode="none"),
        port_datasets.TsvDataset(str(dn_tree / "cc12m-train.tsv"), image_transform(32), return_caption=False)])
    assert len(images) == 12 + 12
    np.testing.assert_array_equal(images[13], images.datasets[1][1])


def _fp16_ulp_close(got, want):
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float16)).astype(np.float32)
    return np.abs(got.astype(np.float32) - want.astype(np.float32)) <= ulp


@pytest.mark.parametrize("shard_batches", [None, 2])
def test_cache_image_features_matches_jax(dn_tree, tiny_rn_ckpt, tmp_path, monkeypatch, shard_batches):
    """20 images (the train split of two domains), batch 8: the same
    loader order and permutation; fp16 shards within one ulp of JAX's."""
    path, jax_clip, params, state = tiny_rn_ckpt
    monkeypatch.setitem(port_factory._MODEL_CONFIGS, "TinyRN", TINY)
    port_model = port_factory.create_model("TinyRN", pretrained=str(path), device="cpu")
    port_ds = port_datasets.DomainNetCaptions(str(dn_tree), "train", image_transform(32), mode="none",
                                              exclude_domains=DOMAINS[2:])
    jax_ds = jax_datasets.DomainNetCaptions(str(dn_tree), "train", jax_image_transform(32, False), mode="none",
                                            exclude_domains=DOMAINS[2:])
    assert len(port_ds) == 20
    # fp32 features of every image, in index order
    images = np.stack([port_ds[i] for i in range(len(port_ds))])
    want32 = np.asarray(jax_clip.encode_image(params, jnp.asarray(images), state=state, normalize=True)[0])
    with torch.inference_mode():
        got32 = port_model.encode_image(torch.from_numpy(images), normalize=True).numpy()
    np.testing.assert_allclose(got32, want32, atol=1e-4, rtol=0)

    kw = dict(batch_size=8, num_threads=2, shard_batches=shard_batches, seed=3)
    want_paths = jax_cache.cache_image_features(jax_clip, params, state, jax_ds, str(tmp_path / "jax"), **kw)
    got_paths = cache.cache_image_features(port_model, port_ds, str(tmp_path / "port"), **kw)
    assert [p.rsplit("/", 1)[1] for p in got_paths] == [p.rsplit("/", 1)[1] for p in want_paths]
    assert len(got_paths) == (1 if shard_batches is None else 2)
    for g, w in zip(got_paths, want_paths):
        got, want = np.load(g), np.load(w)
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        assert _fp16_ulp_close(got, want).all()
    # the rows: features in the loader's order (a permutation at the seed),
    # each shard permuted by the next draw of RandomState(seed)
    in_loader_order = got32[np.random.RandomState(3).permutation(20)]
    rng = np.random.RandomState(3)
    start = 0
    for g in got_paths:
        rows = np.load(g)
        want_rows = in_loader_order[start : start + len(rows)][rng.permutation(len(rows))]
        np.testing.assert_array_equal(rows, want_rows.astype(np.float16))
        start += len(rows)
    assert start == 20


def _recording_writer(calls):
    class Writer:
        def add_scalar(self, tag, value, step):
            calls.append((tag, float(value), step))

        def close(self):
            calls.append(("closed", 0.0, 0))

    return lambda log_dir: Writer()


def test_train_sae_cli_end_to_end_loads_in_jax(dn_tree, tiny_rn_ckpt, tmp_path, monkeypatch, caplog):
    """The SAE CLI on the CPU with the default components layout: feature
    shards and SAE checkpoints that the JAX package loads, validation and
    resampling on the way."""
    path, jax_clip, params, state = tiny_rn_ckpt
    monkeypatch.setitem(port_factory._MODEL_CONFIGS, "TinyRN", TINY)
    calls = []
    monkeypatch.setattr(train_sae, "tensorboard_writer", _recording_writer(calls))
    out = tmp_path / "sae"
    argv = ["--out_dir", str(out), "--ckpt_path", str(path), "--domainnet_path", str(dn_tree),
            "--domainnet_only", "--img_enc_name", "TinyRN", "--input_dim", "32", "--expansion_factor", "1",
            "--train_sae_bs", "8", "--activations_bs", "16", "--num_workers", "2", "--resample_freq", "1",
            "--resample_dataset_size", "48", "--val_freq", "60", "--ckpt_freq", "120", "--num_epochs", "3",
            "--seed", "0", "--device", "cpu"]
    with caplog.at_level("INFO"):
        assert train_sae.main(argv) == 0
    assert sum("Resampling" in r.getMessage() for r in caplog.records) == 3  # after every epoch
    train = jax_pipeline.load_activation_shard(str(out / "activations" / "train_activations.npy"))
    val = jax_pipeline.load_activation_shard(str(out / "activations" / "train_val_activations.npy"))
    assert train.shape == (60, 32) and val.shape == (12, 32) and train.dtype == np.float16
    np.testing.assert_allclose(np.linalg.norm(train.astype(np.float32), axis=1), 1.0, atol=2e-3)
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    assert ckpts == ["sparse_autoencoder_112.pt", "sparse_autoencoder_final.pt"]
    sd = torch.load(out / "checkpoints" / "sparse_autoencoder_final.pt", weights_only=True)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "tied_bias": (1, 32), "encoder._weight": (1, 32, 32), "encoder._bias": (1, 32),
        "decoder._weight": (1, 32, 32)}
    jp = jax_model.sae_state_dict_to_params({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_allclose(np.linalg.norm(np.asarray(jp["decoder"]["weight"]), axis=-2), 1.0, atol=1e-5)
    x = val.astype(np.float32)[:, None, :]
    want_l, want_d = jax_model.sae_apply(jp, jnp.asarray(x))
    got_l, got_d = model.sae_apply(model.sae_state_dict_to_params(sd), torch.from_numpy(x))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)
    tags = [c[0] for c in calls]
    assert tags.count("Loss/val_total") == 3 and tags[-1] == "closed"  # one validation per epoch
    assert all(np.isfinite(c[1]) for c in calls)
    # a second run reuses the cached features
    before = (out / "activations" / "train_activations.npy").stat().st_mtime_ns
    assert train_sae.main(argv) == 0
    assert (out / "activations" / "train_activations.npy").stat().st_mtime_ns == before


def test_save_domainnet_features_cli_matches_jax(dn_tree, tiny_rn_ckpt, tmp_path, monkeypatch):
    path, jax_clip, params, state = tiny_rn_ckpt
    monkeypatch.setitem(port_factory._MODEL_CONFIGS, "TinyRN", TINY)
    out = tmp_path / "feats"
    assert save_domainnet_features.main([
        "--model", "TinyRN", "--ckpt_files", str(path), str(path), "--out_path", str(out),
        "--domainnet_path", str(dn_tree), "--num_workers", "0", "--device", "cpu"]) == 0
    feats = np.load(out / "img_feat.npy")
    ds = jax_datasets.DomainNetCaptions(str(dn_tree), "val", jax_image_transform(32, False))
    want = jax_extract_image_features(jax_clip, params, state, ds, batch_size=256, num_threads=2)
    assert feats.shape == (2, 12, 32) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[0], want["img_feat"], atol=1e-4)
    np.testing.assert_array_equal(feats[0], feats[1])
    np.testing.assert_array_equal(np.load(out / "domain_labels.npy"), want["clss"])
    np.testing.assert_array_equal(np.load(out / "domain_ids.npy"), jax_domain_ids(ds.samples))


@pytest.mark.parametrize("cli", ["train_sae", "save_domainnet_features"])
def test_sae_clis_default_to_cuda(cli, tmp_path, monkeypatch):
    """Without --device the CLIs ask for the card, and raise when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_sae": ["--out_dir", str(tmp_path), "--ckpt_path", "x.pt", "--domainnet_path", str(tmp_path)],
            "save_domainnet_features": ["--model", "RN50", "--ckpt_files", "x.pt", "--out_path", str(tmp_path),
                                        "--domainnet_path", str(tmp_path)]}[cli]
    mod = train_sae if cli == "train_sae" else save_domainnet_features
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())
