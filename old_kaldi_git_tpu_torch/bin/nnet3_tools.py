"""nnet3 serving tools (counterpart of the serving part of
old_kaldi_git_tpu/bin/nnet3_tools.py; reference nnet3bin / online2bin):
nnet3-init, nnet3-copy, nnet3-am-init, nnet3-align-compiled,
nnet3-latgen-faster, online2-wav-nnet3-latgen-faster and the TCP server
online2-tcp-nnet3-decode-faster.  Models are written in the port's format
and read in either package's.
"""

from __future__ import annotations

from typing import List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import (
    _host_model, _symbols, _usage, _words_text, device_option, streaming_words, tool,
    write_decode_outputs)
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("nnet3_tools")


@tool("nnet3-init")
def nnet3_init_tool(argv: List[str]) -> int:
    """A raw nnet from an xconfig file (reference nnet3bin/nnet3-init.cc and
    xconfig_to_configs.py in one: the xconfig front end is the config
    format).  The weights are drawn from --srand by torch's generator."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig

    po = ParseOptions("nnet3-init [options] <xconfig-file> <raw-nnet-out>")

    class Opts:
        srand = 0

    o = Opts()
    po.register("srand", o, "srand")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with open(args[0]) as f:
        config = parse_xconfig(f.read())
    AmNnet.init(config, seed=o.srand, device=device()).save(args[1])
    log.info("initialized nnet: %d layers, input %d, outputs %d",
             len(config.layers), config.input_dim, config.num_outputs)
    return 0


@tool("nnet3-copy")
def nnet3_copy_tool(argv: List[str]) -> int:
    """Copy a raw nnet, optionally editing it, scaling its parameters or
    setting its priors (reference nnet3-copy / nnet3-am-copy roles)."""
    import torch

    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    po = ParseOptions("nnet3-copy [options] <raw-nnet-in> <raw-nnet-out>")

    class Opts:
        scale = 1.0
        prior_counts_vec = ""  # Kaldi vector file of pdf counts
        edits = ""  # semicolon-separated directives (nnet-utils ReadEditConfig)
        edits_config = ""  # file of directives, one per line

    o = Opts()
    po.register("scale", o, "scale")
    po.register("prior-counts-vec", o, "prior_counts_vec")
    po.register("edits", o, "edits")
    po.register("edits-config", o, "edits_config")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    am = AmNnet.load(args[0], device=device())
    if o.edits or o.edits_config:
        from old_kaldi_git_tpu_torch.models.edits import apply_edits

        edits = o.edits
        if o.edits_config:
            with open(o.edits_config) as f:
                edits = (edits + ";" if edits else "") + f.read()
        am = apply_edits(am, edits)
    if o.scale != 1.0:
        with torch.no_grad():
            for p in am.model.parameters():
                p.mul_(o.scale)
    if o.prior_counts_vec:
        with open(o.prior_counts_vec, "rb") as f:
            iof.init_kaldi_input_stream(f)
            am.set_priors_from_alignment_counts(iof.read_vector(f))
    am.save(args[1])
    return 0


@tool("nnet3-am-init")
def nnet3_am_init_tool(argv: List[str]) -> int:
    """Bundle a raw nnet with the transition model of an existing system:
    the decodable `final.mdl` (reference nnet3-am-init)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet, AmNnetModel

    po = ParseOptions("nnet3-am-init <gmm-model-with-transitions> <raw-nnet> <am-nnet-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    AmNnetModel(AmNnet.load(args[1], device=device()), tm).save(args[2])
    return 0


@tool("nnet3-align-compiled")
def nnet3_align_compiled_tool(argv: List[str]) -> int:
    """Batched Viterbi alignment with an nnet3 AM over per-utterance graphs
    (reference nnet3bin/nnet3-align-compiled.cc), through the gather kernel."""
    from old_kaldi_git_tpu_torch.bin.train_tools import batch_align
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel

    po = ParseOptions("nnet3-align-compiled [options] <am-nnet-model> <graphs-rspecifier> "
                      "<feats-rspecifier> <ali-wspecifier>")

    class Opts:
        beam = 200.0
        acoustic_scale = 1.0

    o = Opts()
    po.register("beam", o, "beam")
    po.register("acoustic-scale", o, "acoustic_scale")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    return batch_align(AmNnetModel.load(args[0], device=dev), args[1], args[2], args[3],
                       beam=o.beam, acoustic_scale=o.acoustic_scale, device=dev)


def nnet3_loglikes(am, padded: np.ndarray, nf: np.ndarray, fsf: int, use_priors: bool):
    """The decode tools' scores of a padded batch: pseudo-loglikes (in time
    chunks) subsampled by fsf, or with use_priors off (or no priors) the
    logits at output stride fsf; and the frame counts at that rate."""
    if use_priors and am.log_priors is not None:
        ll = am.loglikes_batch_chunked(padded)
        if fsf > 1:
            ll = ll[:, ::fsf]
    else:
        ll = am.logits(padded, output_stride=fsf)
    if fsf > 1:
        nf = np.asarray([(n + fsf - 1) // fsf for n in nf], np.int32)
    return ll, nf


@tool("nnet3-latgen-faster")
def nnet3_latgen_faster_tool(argv: List[str]) -> int:
    """Batched lattice-generating decode with an nnet3 AM (reference
    nnet3bin/nnet3-latgen-faster.cc).  --frame-subsampling-factor 3 decodes
    chain models (graph built with self-loop-scale 1.0)."""
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("nnet3-latgen-faster [options] <am-nnet-model> <hclg-fst> "
                      "<feats-rspecifier> <lattice-wspecifier> [<words-wspecifier>]")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 1.0
        lattice_beam = 10.0
        word_symbol_table = ""
        frame_subsampling_factor = 1
        use_priors = True

    o = Opts()
    for name, attr in (("beam", "beam"), ("max-active", "max_active"),
                       ("acoustic-scale", "acoustic_scale"),
                       ("lattice-beam", "lattice_beam"),
                       ("word-symbol-table", "word_symbol_table"),
                       ("frame-subsampling-factor", "frame_subsampling_factor"),
                       ("use-priors", "use_priors")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) not in (4, 5):
        return _usage(po)
    dev = device()
    bundle = AmNnetModel.load(args[0], device=dev)
    csr = read_hclg_csr(args[1], bundle.tm.tid_to_pdf_array())
    feats = dict(SequentialTableReader(args[2], "mat"))
    if not feats:
        log.warning("no features")
        return 1
    keys, padded, nf = pad_feature_batch(feats)
    ll, nf = nnet3_loglikes(bundle.am, padded, nf, o.frame_subsampling_factor,
                            o.use_priors)
    results = decode_batch(csr, ll, nf,
                           ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                          acoustic_scale=o.acoustic_scale),
                           want_lattice=True, device=dev)
    write_decode_outputs(csr, keys, results, ll.cpu().numpy(), nf, o.acoustic_scale,
                         o.lattice_beam, args[3], args[4] if len(args) == 5 else None,
                         _symbols(o.word_symbol_table))
    return 0


def _online_parts(o, dev, bundle_path: str, hclg_path: str):
    """(bundle, csr, words table, MFCC options, Viterbi options) of the
    online nnet3 tools."""
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
    from old_kaldi_git_tpu_torch.feat.compute import MfccOptions
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel

    bundle = AmNnetModel.load(bundle_path, device=dev)
    csr = read_hclg_csr(hclg_path, bundle.tm.tid_to_pdf_array())
    mfcc_opts = MfccOptions()
    mfcc_opts.frame_opts.samp_freq = o.samp_freq
    mfcc_opts.frame_opts.dither = 0.0
    vopts = ViterbiOptions(beam=o.beam, max_active=o.max_active,
                           acoustic_scale=o.acoustic_scale)
    return bundle, csr, _symbols(o.word_symbol_table), mfcc_opts, vopts


def _online_decoder(bundle, csr, mfcc_opts, vopts, silence_phone_id: int, dev):
    """A fresh (feature pipeline, streaming AM, streaming decoder): the AM
    runs looped with its carried context (models/streaming_am.py), so the
    decoder takes finished loglike frames as they are."""
    from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
    from old_kaldi_git_tpu_torch.online.streaming import (
        OnlineFeaturePipeline, StreamingDecoder)

    return (OnlineFeaturePipeline(mfcc_opts, device=dev), StreamingAmNnet(bundle.am),
            StreamingDecoder(csr, lambda x: x, silence_phones=[silence_phone_id],
                             tid_to_phone=bundle.tm.tid_to_phone_array(), opts=vopts,
                             device=dev))


@tool("online2-wav-nnet3-latgen-faster")
def online2_wav_nnet3_latgen_tool(argv: List[str]) -> int:
    """Simulated-real-time streaming decode with an nnet3 AM (reference
    online2bin/online2-wav-nnet3-latgen-faster.cc): chunked audio →
    streaming features (the MFCC kernel) → the looped AM → the streaming
    decoder with endpointing; prints RTF."""
    import time as _time

    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("online2-wav-nnet3-latgen-faster [options] <am-nnet-model> "
                      "<hclg-fst> <wav-rspecifier> <words-wspecifier>")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 1.0
        chunk_seconds = 0.5
        word_symbol_table = ""
        samp_freq = 16000.0
        silence_phone_id = 1

    o = Opts()
    for name, attr in (("beam", "beam"), ("max-active", "max_active"),
                       ("acoustic-scale", "acoustic_scale"),
                       ("chunk-seconds", "chunk_seconds"),
                       ("word-symbol-table", "word_symbol_table"),
                       ("samp-freq", "samp_freq"),
                       ("silence-phone-id", "silence_phone_id")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    bundle, csr, words_tab, mfcc_opts, vopts = _online_parts(o, dev, args[0], args[1])
    chunk = int(o.chunk_seconds * o.samp_freq)
    tot_audio = tot_wall = 0.0
    with TableWriter(args[3], "text") as w:
        for key, wave in SequentialTableReader(args[2], "wav"):
            pipe, sam, dec = _online_decoder(bundle, csr, mfcc_opts, vopts,
                                             o.silence_phone_id, dev)
            samples = wave.data[0]
            t0 = _time.perf_counter()
            text = _words_text(words_tab, streaming_words(dec, samples, chunk, pipe, sam))
            wall = _time.perf_counter() - t0
            w[key] = text
            dur = len(samples) / o.samp_freq
            tot_audio += dur
            tot_wall += wall
            print(f"{key} ({dur:.2f}s, RTF {wall / max(dur, 1e-9):.3f}): {text}")
    if tot_audio:
        print(f"overall RTF {tot_wall / tot_audio:.3f} "
              f"({tot_audio:.1f}s audio in {tot_wall:.1f}s)")
    return 0


@tool("online2-tcp-nnet3-decode-faster")
def online2_tcp_nnet3_decode_tool(argv: List[str]) -> int:
    """TCP streaming decode server (reference
    online2bin/online2-tcp-nnet3-decode-faster.cc): clients stream raw
    S16LE PCM; the server answers with partial hypotheses (lines ending
    '\\r') and, on an endpoint or the end of the stream, the utterance's
    final text (ending '\\n'), then starts the next utterance on the same
    connection.  --num-connections bounds the connections served (0 =
    forever); --port-file records the bound port (for --port-num=0)."""
    import socket

    po = ParseOptions("online2-tcp-nnet3-decode-faster [options] <am-nnet-model> "
                      "<hclg-fst>")

    class Opts:
        port_num = 5050
        port_file = ""
        num_connections = 0
        beam = 16.0
        max_active = 7000
        acoustic_scale = 1.0
        chunk_length_secs = 0.18
        samp_freq = 16000.0
        silence_phone_id = 1
        word_symbol_table = ""
        read_timeout = 10.0

    o = Opts()
    for name, attr in (
            ("port-num", "port_num"), ("port-file", "port_file"),
            ("num-connections", "num_connections"), ("beam", "beam"),
            ("max-active", "max_active"), ("acoustic-scale", "acoustic_scale"),
            ("chunk-length-secs", "chunk_length_secs"), ("samp-freq", "samp_freq"),
            ("silence-phone-id", "silence_phone_id"),
            ("word-symbol-table", "word_symbol_table"), ("read-timeout", "read_timeout")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    bundle, csr, words_tab, mfcc_opts, vopts = _online_parts(o, dev, args[0], args[1])

    def fresh():
        return _online_decoder(bundle, csr, mfcc_opts, vopts, o.silence_phone_id, dev)

    chunk_bytes = max(2, 2 * int(o.chunk_length_secs * o.samp_freq))
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("", o.port_num))
    srv.listen(1)
    port = srv.getsockname()[1]
    log.info("TCP server listening on port %d", port)
    if o.port_file:
        with open(o.port_file, "w") as f:
            f.write(str(port))
    served = 0
    try:
        while o.num_connections == 0 or served < o.num_connections:
            conn, addr = srv.accept()
            served += 1
            log.info("connection from %s", addr)
            conn.settimeout(o.read_timeout)
            pipe, sam, dec = fresh()
            buf = b""
            saw_audio = False
            try:
                while True:
                    try:
                        data = conn.recv(65536)
                    except socket.timeout:
                        log.warning("read timeout, closing connection")
                        break
                    if not data:
                        break
                    buf += data
                    while len(buf) >= chunk_bytes:
                        raw, buf = buf[:chunk_bytes], buf[chunk_bytes:]
                        samples = np.frombuffer(raw, "<i2").astype(np.float32)
                        dec.advance(sam.accept(pipe.accept_waveform(samples)))
                        saw_audio = True
                        conn.sendall((_words_text(words_tab, dec.best_words()) + "\r").encode())
                        if dec.endpoint_detected():
                            final = _words_text(words_tab, dec.best_words())
                            conn.sendall((final + "\n").encode())
                            log.info("endpoint: %s", final)
                            pipe, sam, dec = fresh()
                            saw_audio = False
                # end of the stream: the remaining samples, then finalise
                if buf:
                    samples = np.frombuffer(buf[: 2 * (len(buf) // 2)], "<i2").astype(np.float32)
                    dec.advance(sam.accept(pipe.accept_waveform(samples)))
                    saw_audio = True
                if saw_audio:
                    dec.advance(sam.accept(pipe.input_finished(), final=True), final=True)
                    final = _words_text(words_tab, dec.best_words())
                    conn.sendall((final + "\n").encode())
                    log.info("final: %s", final)
            except (BrokenPipeError, ConnectionResetError):
                log.warning("client disconnected")
            finally:
                conn.close()
    finally:
        srv.close()
    return 0

