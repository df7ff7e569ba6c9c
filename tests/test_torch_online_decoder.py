"""StreamingTokenDecoder in the port vs its batch decode and the JAX package,
on the CPU (split from tests/test_torch_online.py, whose toy graphs these
tests use): words and alignment exactly equal to the port's batch decode
and to the JAX StreamingTokenDecoder for every chunking, on a folded graph,
a split-eps graph and a split-eps graph at frame-subsampling 3;
endpointing on trailing silence; the max_frames refusal."""

import tests.torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.online.streaming as jstream
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.online.streaming as tstream
from tests.test_online import _loglikes_for, _toy_decode_system
from tests.test_torch_chain import port_graph
from tests.test_torch_online import _toy_graphs, _chunkings, _feed


@pytest.mark.parametrize("kind", ["folded", "split", "split_fsf3"])
@pytest.mark.parametrize("chunking", range(4))
def test_streaming_token_decoder_equals_batch_and_jax(kind, chunking):
    graph, ll, o, fsf, quantum, sil, t2p = _toy_graphs()[kind]
    pg = port_graph(graph)
    ll_sub = ll[::fsf]
    batch = tvit.decode_batch_tokens(pg, ll_sub[None], [len(ll_sub)],
                                     tvit.ViterbiOptions(**o), device="cpu")[0]
    assert batch is not None
    chunks = _chunkings(len(ll), fsf)[chunking]
    dec = tstream.StreamingTokenDecoder(
        pg, lambda x: x[:, ::fsf], sil, t2p, tvit.ViterbiOptions(**o),
        frame_subsampling_factor=fsf, chunk_quantum=quantum, device="cpu")
    words, tids = _feed(dec, ll, chunks)
    assert words == batch.words and tids == list(batch.alignment)
    jdec = jstream.StreamingTokenDecoder(
        graph, lambda x: jnp.asarray(x)[:, ::fsf], sil, t2p, jvit.ViterbiOptions(**o),
        frame_subsampling_factor=fsf, chunk_quantum=quantum)
    assert (words, tids) == _feed(jdec, ll, chunks)


def test_streaming_token_decoder_endpoints_on_trailing_silence():
    lang, _topo, cd, tm, csr = _toy_decode_system()
    speech = _loglikes_for(tm, cd, lang, ["N", "OW"])
    silence = _loglikes_for(tm, cd, lang, ["SIL"], frames_per_phone=120)
    dec = tstream.StreamingTokenDecoder(
        port_graph(csr), lambda x: x, [lang.silence_id], tm.tid_to_phone_array(),
        tvit.ViterbiOptions(beam=30.0, max_active=64, acoustic_scale=1.0),
        endpoint_rules=[tstream.EndpointRule(True, 0.5, 0.0)], device="cpu")
    dec.advance(speech)
    assert not dec.endpoint_detected()
    dec.advance(silence)
    assert dec.trailing_silence_frames() * 0.01 >= 0.5
    assert dec.endpoint_detected()
    assert [lang.words[w] for w in dec.best_words()] == ["no"]
    rules = tstream.default_endpoint_rules()
    assert [(r.must_contain_nonsilence, r.min_trailing_silence, r.min_utterance_length)
            for r in rules] == [(False, 5.0, 0.0), (True, 1.0, 0.0), (True, 0.0, 20.0)]


def test_streaming_token_decoder_refuses_past_max_frames():
    graph, ll, o, *_ = _toy_graphs()["split"]
    dec = tstream.StreamingTokenDecoder(
        port_graph(graph), lambda x: x, [], np.zeros(99, np.int32),
        tvit.ViterbiOptions(**o), max_frames=40, device="cpu")
    dec.advance(ll[:8])
    with pytest.raises(ValueError, match="max_frames"):
        dec.advance(ll[8:])
    with pytest.raises(Exception, match="multiple of"):
        tstream.StreamingTokenDecoder(port_graph(graph), lambda x: x, [], None,
                                      frame_subsampling_factor=3, chunk_quantum=32,
                                      device="cpu")
