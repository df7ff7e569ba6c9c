"""The port's TDNN-LSTM, TDNN-attention, CNN-TDNN-F and xconfig models
against the JAX package's on the CPU, at small widths (hidden 32, cell 32,
T <= 61), with random weights and batch statistics carried across by
convert.am_nnet_from_jax; inputs from numpy seeds.  Tolerances: logits
within 1e-4 of max|ref| (float32 sums of <= 300 products in another order
through up to 10 layers and 61 recurrent steps); chunked and streamed
loglikes equal the whole utterance's within 1e-5 absolute (the same
arithmetic on other slices); the trunk-subsampled logits equal the
full-rate ones at the kept frames within 2e-5 (tests/test_models.py:827);
save / load exact."""

import tests.torch_threads  # noqa: F401
import dataclasses
import pickle
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
from old_kaldi_git_tpu.models.xconfig import parse_xconfig as jparse_xconfig
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import tdnn as ttdnn
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.natural_gradient import NgCollector
from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig

D, P = 12, 20
FACTORIES = {
    "tdnn_lstm": lambda m: m.make_tdnn_lstm(D, P, hidden_dim=32, cell_dim=32,
                                            recurrent_dim=8, num_blocks=2),
    "tdnn_attention": lambda m: m.make_tdnn_attention(D, P, hidden_dim=32, num_layers=3,
                                                      num_heads=2, key_dim=8, value_dim=6),
    "cnn_tdnnf": lambda m: m.make_cnn_tdnnf(D, P, height=6, num_filters=(4, 6),
                                            hidden_dim=32, bottleneck_dim=8,
                                            num_tdnnf_layers=1),
}

# every layer type of the xconfig language, and Descriptor wiring
XCONFIG = f"""
input name=input dim={D}
conv-relu-batchnorm-layer name=cnn1 height-in=6 height-out=3 num-filters-out=4 time-offsets=-1,0,1 height-offsets=-1,0,1
relu-batchnorm-layer name=tdnn1 dim=24 input=Append(-1,0,1)
tdnnf-layer name=tdnnf1 dim=24 bottleneck-dim=8 time-stride=2
relu-batchnorm-layer name=tdnn2 dim=24 input=Sum(tdnnf1, IfDefined(Offset(tdnn1, -2)))
fast-lstmp-layer name=lstm1 cell-dim=16 recurrent-projection-dim=6 non-recurrent-projection-dim=2
pgru-layer name=gru1 cell-dim=16 recurrent-projection-dim=8
blstmp-layer name=blstm1 cell-dim=16 recurrent-projection-dim=4
attention-relu-renorm-layer name=attn num-heads=2 key-dim=4 value-dim=5 num-left-inputs=2 num-right-inputs=1 time-stride=2
relu-batchnorm-layer name=tdnn3 dim=24 input=Append(attn, Round(tdnn2, 3))
prefinal-layer name=prefinal dim=24
output-layer name=output dim={P}
"""


def random_jax_am(config, seed=0):
    """A flax AmNnet whose every parameter and running statistic is random,
    drawn by numpy into the tree flax's init makes (its structure and
    shapes from jax.eval_shape: flax's own draws would only be replaced,
    and compiling them costs seconds a model)."""
    model = jtdnn.TdnnModel(config)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, config.input_dim), jnp.float32)))
    rng = np.random.default_rng(seed + 7)

    def fill(tree):
        return {k: fill(v) if isinstance(v, Mapping) else
                (0.5 + rng.random(v.shape)).astype(np.float32) if k == "var" else
                (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                for k, v in tree.items()}
    priors = np.log(rng.dirichlet(np.ones(config.num_outputs))).astype(np.float32)
    return jam.AmNnet(config, fill(shapes), priors)


def carry(j):
    return convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables,
                                    j.log_priors, device="cpu")


def _x(T=61, seed=1, B=2):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_models_match(name):
    jcfg, tcfg = FACTORIES[name](jtdnn), FACTORIES[name](ttdnn)
    j = random_jax_am(jcfg)
    t = carry(j)
    assert t.config == tcfg
    assert (tcfg.left_context, tcfg.right_context) == (jcfg.left_context,
                                                       jcfg.right_context)
    x = _x()
    for stride in (1, 3):
        _close(t.logits(x, stride).numpy(), j.logits(x, output_stride=stride))


@pytest.fixture(scope="module")
def xconfig_jax_am():
    """The XCONFIG model in the JAX package, random, made once (flax's init
    of its three recurrent scans takes seconds)."""
    return random_jax_am(jparse_xconfig(XCONFIG), seed=2)


def test_xconfig_model_with_every_layer_type(xconfig_jax_am):
    j, jcfg = xconfig_jax_am, xconfig_jax_am.config
    t = carry(j)
    x = _x(seed=3)
    _close(t.logits(x).numpy(), j.logits(x))
    assert t.config.left_context == jcfg.left_context


def test_trunk_subsampling_rule():
    """The chain stride pattern subsamples the trunk early, exactly."""
    cfg = ttdnn.make_tdnnf(D, 50, hidden_dim=32, bottleneck_dim=8, num_layers=6,
                           subsampled_stride=3, num_full_rate_layers=3)
    assert ttdnn._subsample_at(cfg, 3) == 4
    # a recurrent or Descriptor layer in the tail stops it there
    lstm = FACTORIES["tdnn_lstm"](ttdnn)
    assert ttdnn._subsample_at(lstm, 3) == len(lstm.layers)
    am = AmNnet.init(cfg, seed=1, device="cpu")
    x = _x(T=31, seed=4)
    full, sub = am.logits(x).numpy(), am.logits(x, 3).numpy()
    assert sub.shape == (2, 11, 50)
    np.testing.assert_allclose(sub, full[:, ::3], rtol=2e-5, atol=2e-5)


def test_save_load_and_the_jax_pickle(tmp_path, xconfig_jax_am):
    j = xconfig_jax_am
    t = carry(j)
    t.lr_factors = {"tdnn*": 0.5}
    t.save(str(tmp_path / "port.am"))
    back = AmNnet.load(str(tmp_path / "port.am"), device="cpu")
    assert back.config == t.config and back.lr_factors == {"tdnn*": 0.5}
    for k, v in t.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v)
    j.save(str(tmp_path / "jax.am"))
    from_jax = AmNnet.load(str(tmp_path / "jax.am"), device="cpu")
    x = _x(seed=6)
    np.testing.assert_array_equal(from_jax.loglikes_batch(x).numpy(),
                                  t.loglikes_batch(x).numpy())
    with open(tmp_path / "jax.am", "rb") as f:
        assert pickle.load(f)["config"] == j.config


@pytest.mark.parametrize("name", ["tdnn_attention", "cnn_tdnnf", "tdnn_lstm"])
def test_chunked_loglikes_equal_whole(name):
    am = AmNnet.init(FACTORIES[name](ttdnn), seed=3, device="cpu")
    x = _x(T=230, seed=7)
    np.testing.assert_allclose(am.loglikes_batch_chunked(x, chunk=50).numpy(),
                               am.loglikes_batch(x).numpy(), atol=1e-5, rtol=0)


def _pgru_config():
    return ttdnn.TdnnConfig(D, P, (
        ttdnn.TdnnLayerSpec("tdnn", 16, (-1, 0, 1)),
        ttdnn.TdnnLayerSpec("pgru", 16, recurrent_dim=8, nonrecurrent_dim=4),
        ttdnn.TdnnLayerSpec("tdnn", 16, (-2, 0, 2))))


def test_streaming_equals_the_whole_utterance():
    feats = _x(T=77, seed=8, B=1)[0]
    for cfg in (FACTORIES["tdnn_lstm"](ttdnn), _pgru_config(),
                FACTORIES["tdnn_attention"](ttdnn), FACTORIES["cnn_tdnnf"](ttdnn)):
        am = AmNnet.init(cfg, seed=4, device="cpu")
        am.log_priors = torch.log(torch.full((P,), 1.0 / P))
        ref = am.loglikes_batch(feats[None])[0].numpy()
        for chunks in ([77], [5, 40, 32], [3] * 25 + [2]):
            sam, outs, pos = StreamingAmNnet(am), [], 0
            for i, c in enumerate(chunks):
                out = sam.accept(feats[pos: pos + c], final=i == len(chunks) - 1)
                pos += c
                if out.size:
                    outs.append(out)
            np.testing.assert_allclose(np.concatenate(outs), ref, atol=1e-5, rtol=0)
    blstm = ttdnn.TdnnConfig(D, P, (ttdnn.TdnnLayerSpec("blstmp", 16),))
    with pytest.raises(ValueError, match="blstmp"):
        StreamingAmNnet(AmNnet.init(blstm, device="cpu"))


def test_ng_instrumentation_skips_recurrent_and_attention_layers():
    """The JAX package's ng_dense sites: the tdnn, tdnnf, conv, prefinal and
    output affines; not the LSTMP, GRU or attention products."""
    t = AmNnet.init(parse_xconfig(XCONFIG), seed=9, device="cpu")
    t.model.train()
    c = NgCollector(t.model)
    c.active = True
    t.model(torch.from_numpy(_x(seed=10))).square().sum().backward()
    c.active = False
    assert sorted(c.stats()) == ["conv0.conv", "output", "prefinal.affine", "tdnn1.affine",
                                 "tdnn3.affine", "tdnn8.affine", "tdnnf2.affine",
                                 "tdnnf2.linear"]
    c.remove()
