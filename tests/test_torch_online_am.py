"""StreamingAmNnet in the port vs its batch path, on the CPU (split from
tests/test_torch_online.py): the streaming acoustic model equals
loglikes_batch within 1e-5 for every chunking, and the streaming decoder
fed by a TDNN window (frame-subsampling 1 and 3) gives the batch decode's
words and alignment."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest

import old_kaldi_git_tpu.models.tdnn as jtdnn
from old_kaldi_git_tpu.models.streaming_am import StreamingAmNnet as JaxStreamingAmNnet
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.online.streaming as tstream
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
from tests.test_online import _backoff_split_system
from tests.test_torch_chain import port_graph
from tests.test_torch_tdnn import _random_jax_am
from tests.test_torch_online import _feed


def _toy_am(config, seed=0):
    jax_am = _random_jax_am(config, seed)
    return jax_am, convert.am_nnet_from_jax(
        dataclasses.asdict(jax_am.config), jax_am.variables, jax_am.log_priors,
        device="cpu")


TOY_CONFIG = jtdnn.TdnnConfig(8, 12, (
    jtdnn.TdnnLayerSpec("tdnn", 16, offsets=(-2, -1, 0, 1, 2)),
    jtdnn.TdnnLayerSpec("tdnnf", 16, bottleneck_dim=8, time_stride=3),
    jtdnn.TdnnLayerSpec("tdnnf", 16, bottleneck_dim=8, time_stride=1),
), final_hidden_dim=16)


@pytest.mark.parametrize("chunks", [[57], [10, 20, 27], [1] * 57, [5, 52]])
def test_streaming_am_equals_loglikes_batch(chunks):
    jax_am, am = _toy_am(TOY_CONFIG)
    feats = np.random.default_rng(0).standard_normal((57, 8)).astype(np.float32)
    ref = am.loglikes_batch(feats[None])[0].numpy()
    sam = StreamingAmNnet(am)
    assert sam.total_right_context == 2 + 3 + 1
    outs, pos = [], 0
    for i, c in enumerate(chunks):
        outs.append(sam.accept(feats[pos: pos + c], final=i == len(chunks) - 1))
        pos += c
    got = np.concatenate([o for o in outs if o.size])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # and the JAX package's streaming model, fed the same way, within 1e-4
    # (the port's TDNN tolerance against flax)
    jsam = JaxStreamingAmNnet(jax_am)
    jouts, pos = [], 0
    for i, c in enumerate(chunks):
        jouts.append(jsam.accept(feats[pos: pos + c], final=i == len(chunks) - 1))
        pos += c
    np.testing.assert_allclose(got, np.concatenate([o for o in jouts if o.size]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("fsf", [1, 3])
def test_streaming_with_a_tdnn_window_equals_batch(fsf):
    """A toy TDNN-F (left/right context 6, a stride-3 tdnnf) as the acoustic
    model over the decoder's fixed window: loglikes at the kept frames and
    the decode equal the whole-utterance batch path (at fsf 3 the window
    starts on the subsample grid)."""
    _, am = _toy_am(TOY_CONFIG, seed=1)
    _folded, split, _ = _backoff_split_system()
    pg = port_graph(split)
    feats = np.random.default_rng(5).standard_normal((90, 8)).astype(np.float32)
    if fsf == 1:
        ll = am.loglikes_batch(feats[None])
        am_fn = am.loglikes_batch
    else:
        ll = am.logits(feats[None], output_stride=3)
        am_fn = lambda x: am.logits(x, output_stride=3)  # noqa: E731
    o = tvit.ViterbiOptions(beam=1e9, max_active=64, acoustic_scale=0.7)
    batch = tvit.decode_batch_tokens(pg, ll, [ll.shape[1]], o, device="cpu")[0]
    for chunks in ([30, 30, 30], [9] * 10, [90]):
        dec = tstream.StreamingTokenDecoder(
            pg, am_fn, [], np.zeros(99, np.int32), o,
            am_left_context=am.config.left_context,
            am_right_context=am.config.right_context,
            frame_subsampling_factor=fsf, chunk_quantum=30, device="cpu")
        assert _feed(dec, feats, chunks) == (batch.words, list(batch.alignment))
