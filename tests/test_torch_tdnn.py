"""Port TDNN-F acoustic model vs the flax model on the CPU: a narrow model
with random weights and non-trivial batch statistics carried across with
am_nnet_from_jax, and the committed final.am read through the stub
unpickler.  Tolerances: 1e-4 on the narrow model's outputs (float32 products
of <= 100 terms in another order), 1e-3 on final.am's loglikes (seven layers
of 512-1024-term sums)."""

import tests.torch_threads  # noqa: F401
import dataclasses
import io
import os
import pickle

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import tdnn as ttdnn
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_AM = os.path.join(REPO, "exp", "minilib", "final.am")


def _random_jax_am(config, seed):
    """A flax model whose every parameter AND running statistic is random."""
    am = jam.AmNnet.init(config, seed=seed)
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
            elif k == "var":
                out[k] = (0.5 + rng.random(v.shape)).astype(np.float32)
            else:
                out[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        return out

    am.variables = fill(am.variables)
    am.log_priors = np.log(rng.dirichlet(np.ones(config.num_outputs))).astype(np.float32)
    return am


def _carry(jax_am):
    return convert.am_nnet_from_jax(
        dataclasses.asdict(jax_am.config), jax_am.variables, jax_am.log_priors,
        device="cpu")


CONFIGS = {
    # 3 layers, uniform stride 1: output_stride=3 can only subsample at the end
    "uniform": dict(input_dim=20, num_outputs=30, hidden_dim=32,
                    bottleneck_dim=8, num_layers=3),
    # chain-style strides: the trunk past layer 1 runs at T/3
    "subsampled": dict(input_dim=20, num_outputs=30, hidden_dim=32,
                       bottleneck_dim=8, num_layers=4, subsampled_stride=3,
                       num_full_rate_layers=1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("stride", [1, 3])
def test_logits_match(name, stride):
    jax_am = _random_jax_am(jtdnn.make_tdnnf(**CONFIGS[name]), seed=3)
    am = _carry(jax_am)
    assert [(l.kind, l.dim, l.offsets, l.bottleneck_dim, l.time_stride, l.bypass_scale)
            for l in am.config.layers] == [
        (l.kind, l.dim, l.offsets, l.bottleneck_dim, l.time_stride, l.bypass_scale)
        for l in jax_am.config.layers]
    x = np.random.default_rng(4).normal(size=(2, 37, 20)).astype(np.float32)
    want = np.asarray(jax_am.logits(x, output_stride=stride))
    got = am.logits(x, output_stride=stride).numpy()
    assert got.shape == want.shape == (2, -(-37 // stride), 30)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loglikes_batch_matches_with_and_without_priors():
    jax_am = _random_jax_am(jtdnn.make_tdnnf(**CONFIGS["uniform"]), seed=5)
    am = _carry(jax_am)
    x = np.random.default_rng(6).normal(size=(3, 21, 20)).astype(np.float32)
    got = am.loglikes_batch(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_am.loglikes_batch(x)),
                               atol=1e-4, rtol=0)
    jax_am.log_priors = None
    am = _carry(jax_am)
    got = am.loglikes_batch(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_am.loglikes_batch(x)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-4)


def test_splice_clips_at_the_edges():
    x = np.arange(10, dtype=np.float32).reshape(1, 5, 2)
    want = np.asarray(jtdnn.splice(x, (-2, 0, 1)))
    got = ttdnn.splice(torch.from_numpy(x), (-2, 0, 1)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[0, 0], [0, 1, 0, 1, 2, 3])  # replicated, not zero


def test_unported_kinds_raise():
    """Every kind of the JAX package builds; an unknown kind raises
    ValueError, as it does there."""
    bad = ttdnn.TdnnConfig(20, 30, (ttdnn.TdnnLayerSpec("weird", 32),))
    with pytest.raises(ValueError, match="weird"):
        ttdnn.TdnnModel(bad)
    lstm = ttdnn.TdnnConfig(20, 30, (ttdnn.TdnnLayerSpec("lstmp", 32),))
    assert ttdnn.TdnnModel(lstm)(torch.zeros(1, 5, 20)).shape == (1, 5, 30)
    desc = ttdnn.TdnnConfig(20, 30, (ttdnn.TdnnLayerSpec("tdnn", 32, input_desc="input"),))
    assert ttdnn.TdnnModel(desc)(torch.zeros(1, 5, 20)).shape == (1, 5, 30)


def test_final_am_through_the_stub_unpickler():
    jax_am = jam.AmNnet.load(FINAL_AM)
    am = AmNnet.load(FINAL_AM, device="cpu")
    assert am.config.input_dim == 39 and am.config.num_outputs == 2000
    assert [l.kind for l in am.config.layers] == ["tdnn"] + ["tdnnf"] * 5
    assert am.config.final_hidden_dim == 512
    assert am.model.tdnnf1.linear.weight.shape == (64, 1024)
    assert am.model.tdnnf1.linear.bias is None
    x = np.random.default_rng(7).normal(size=(2, 64, 39)).astype(np.float32) * 3.0
    want = np.asarray(jax_am.loglikes_batch(x))
    got = am.loglikes_batch(x).numpy()
    assert got.shape == (2, 64, 2000)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_stub_unpickler_keeps_state_and_refuses_foreign_classes():
    d = convert.load_pickle(FINAL_AM)
    cfg = d["config"]
    assert type(cfg).__name__ == "TdnnConfig"
    assert type(cfg).__module__ == "old_kaldi_git_tpu.models.tdnn"
    assert not isinstance(cfg, jtdnn.TdnnConfig)  # a stub, not the flax-side class
    assert cfg.input_dim == 39 and cfg.layers[1].bottleneck_dim == 64
    blob = pickle.dumps(os.path.join)  # posixpath.join: not numpy/builtins
    with pytest.raises(pickle.UnpicklingError):
        convert.StubUnpickler(io.BytesIO(blob)).load()


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        AmNnet.load(FINAL_AM)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.am_nnet_from_jax(
            dataclasses.asdict(jtdnn.make_tdnnf(**CONFIGS["uniform"])),
            jam.AmNnet.init(jtdnn.make_tdnnf(**CONFIGS["uniform"])).variables)
