"""nnet3 and chain tools (counterpart of old_kaldi_git_tpu/bin/nnet3_tools.py,
all 28 of its tools; reference nnet3bin, chainbin, online2bin).

- Serving: nnet3-init, nnet3-copy, nnet3-am-init, nnet3-align-compiled,
  nnet3-latgen-faster, online2-wav-nnet3-latgen-faster and the TCP server
  online2-tcp-nnet3-decode-faster.
- Egs (host): nnet3-get-egs, nnet3-copy-egs (round-robin to N outputs),
  nnet3-shuffle-egs, nnet3-merge-egs (a stable sort by length: merging into
  [B, T, ...] minibatches happens in the training step, the ExampleMerger
  role) and their chain variants, in the JAX package's egs / cegs bytes.
- CE training: nnet3-train, nnet3-compute-prob, nnet3-adjust-priors,
  nnet3-combine.
- Chain: chain-est-phone-lm, chain-build-tree (monophone, or a left biphone
  from GMM alignment statistics), chain-make-den-fst, nnet3-chain-init,
  nnet3-chain-get-egs, nnet3-chain-train, nnet3-chain-compute-prob,
  nnet3-chain-combine.
- Sequence training: nnet3-discriminative-train,
  nnet3-discriminative-compute-objf.

Models and den graphs are written in the port's format (torch.save) and read
in either package's.
"""

from __future__ import annotations

from typing import List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import (
    _host_model, _symbols, _usage, _words_text, device_option, streaming_words, tool,
    write_decode_outputs)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
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



# ---------------------------------------------------------------------------
# egs tools (host)
# ---------------------------------------------------------------------------

@tool("nnet3-get-egs")
def nnet3_get_egs_tool(argv: List[str]) -> int:
    """Cut utterances into fixed-width CE egs (reference
    nnet3bin/nnet3-get-egs.cc; the labels are a pdf alignment, ali-to-pdf's)."""
    from old_kaldi_git_tpu_torch.models.egs import get_ce_egs
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("nnet3-get-egs [options] <feats-rspecifier> <pdf-ali-rspecifier> "
                      "<egs-wspecifier>")

    class Opts:
        frames_per_eg = 64

    o = Opts()
    po.register("frames-per-eg", o, "frames_per_eg")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    alis = RandomAccessTableReader(args[1], "ivec")
    n = 0
    with TableWriter(args[2], "egs") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            if key not in alis:
                log.warning("no alignment for %s", key)
                continue
            for i, eg in enumerate(get_ce_egs(f, alis[key], o.frames_per_eg)):
                w[f"{key}-{i}"] = eg
                n += 1
    log.info("wrote %d egs", n)
    return 0 if n else 1


@tool("nnet3-copy-egs")
def nnet3_copy_egs_tool(argv: List[str]) -> int:
    """Copy egs to one or more outputs round-robin (reference nnet3-copy-egs
    job-archive splitting); --chain for chain egs."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("nnet3-copy-egs <egs-rspecifier> <egs-wspecifier1> "
                      "[<egs-wspecifier2> ...]")

    class Opts:
        chain = False

    o = Opts()
    po.register("chain", o, "chain")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    holder = "cegs" if o.chain else "egs"
    writers = [TableWriter(a, holder) for a in args[1:]]
    for i, (key, eg) in enumerate(SequentialTableReader(args[0], holder)):
        writers[i % len(writers)][key] = eg
    for w in writers:
        w.close()
    return 0


@tool("nnet3-shuffle-egs")
def nnet3_shuffle_egs_tool(argv: List[str]) -> int:
    """Shuffle the egs' order by numpy's default_rng(--srand) (reference
    nnet3-shuffle-egs); --chain for chain egs."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("nnet3-shuffle-egs [options] <egs-rspecifier> <egs-wspecifier>")

    class Opts:
        srand = 0
        chain = False

    o = Opts()
    po.register("srand", o, "srand")
    po.register("chain", o, "chain")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    holder = "cegs" if o.chain else "egs"
    pairs = list(SequentialTableReader(args[0], holder))
    np.random.default_rng(o.srand).shuffle(pairs)
    with TableWriter(args[1], holder) as w:
        for key, eg in pairs:
            w[key] = eg
    return 0


def _merge_egs(argv: List[str], chain: bool) -> int:
    """nnet3-merge-egs / nnet3-chain-merge-egs: the egs in a stable sort by
    length, so that each run of --minibatch-size that the training step
    stacks pads little (the ExampleMerger's shape matching)."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    name = "nnet3-chain-merge-egs" if chain else "nnet3-merge-egs"
    po = ParseOptions(f"{name} [options] <egs-rspecifier> <egs-wspecifier>")

    class Opts:
        minibatch_size = 8 if chain else 128

    o = Opts()
    po.register("minibatch-size", o, "minibatch_size")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    holder = "cegs" if chain else "egs"
    pairs = sorted(SequentialTableReader(args[0], holder), key=lambda kv: kv[1].feats.shape[0])
    n_shapes = len({eg.feats.shape[0] for _k, eg in pairs})
    with TableWriter(args[1], holder) as w:
        for key, eg in pairs:
            w[key] = eg
    log.info("%s: %d egs in %d shape groups (minibatch %d)", name, len(pairs), n_shapes,
             o.minibatch_size)
    return 0 if pairs else 1


@tool("nnet3-merge-egs")
def nnet3_merge_egs_tool(argv: List[str]) -> int:
    """Order egs into same-shape minibatch runs (reference
    nnet3bin/nnet3-merge-egs.cc)."""
    return _merge_egs(argv, chain=False)


@tool("nnet3-chain-merge-egs")
def nnet3_chain_merge_egs_tool(argv: List[str]) -> int:
    """Chain variant of nnet3-merge-egs (reference chainbin/nnet3-chain-merge-egs.cc)."""
    return _merge_egs(argv, chain=True)


@tool("nnet3-chain-copy-egs")
def nnet3_chain_copy_egs_tool(argv: List[str]) -> int:
    """Round-robin copy of chain egs (reference chainbin/nnet3-chain-copy-egs.cc)."""
    return nnet3_copy_egs_tool(["--chain=true"] + argv)


@tool("nnet3-chain-shuffle-egs")
def nnet3_chain_shuffle_egs_tool(argv: List[str]) -> int:
    """Shuffle chain egs (reference chainbin/nnet3-chain-shuffle-egs.cc)."""
    return nnet3_shuffle_egs_tool(["--chain=true"] + argv)


def _read_egs(rspecifier: str, holder: str = "egs") -> list:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    return [eg for _k, eg in SequentialTableReader(rspecifier, holder)]


# ---------------------------------------------------------------------------
# CE training and diagnostics
# ---------------------------------------------------------------------------

def _ce_eval(am, egs, batch_size: int = 128):
    """(CE, accuracy, frames) of `am` over an eg list, masked, in groups of
    `batch_size` (nnet3-compute-prob's figures)."""
    import torch

    from old_kaldi_git_tpu_torch.models.egs import batch_ce_egs, iter_merged

    tot_ll = tot_acc = tot_n = 0.0
    with torch.no_grad():
        for group in iter_merged(egs, batch_size):
            bf, bl, bm = batch_ce_egs(group)
            logits = am.logits(bf)
            y = torch.from_numpy(bl).to(logits.device).long()
            m = torch.from_numpy(bm).to(logits.device)
            ll = torch.log_softmax(logits, dim=-1).gather(-1, y[..., None])[..., 0]
            acc = (logits.argmax(-1) == y).to(m.dtype)
            tot_ll += float((ll * m).sum())
            tot_acc += float((acc * m).sum())
            tot_n += float(m.sum())
    n = max(tot_n, 1.0)
    return -tot_ll / n, tot_acc / n, int(tot_n)


@tool("nnet3-train")
def nnet3_train_tool(argv: List[str]) -> int:
    """Minibatch CE training over an egs archive (reference
    nnet3bin/nnet3-train.cc): the egs sorted by length, then each epoch
    grouped into --minibatch-size runs, the runs shuffled by
    default_rng(--srand) and stepped (models/train.py's step, Adam with
    max-change).  A non-finite mean CE is fatal."""
    import torch

    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.egs import batch_ce_egs, iter_merged
    from old_kaldi_git_tpu_torch.models.train import (
        NnetTrainOptions, TrainState, make_ce_train_step, make_optimizer)

    po = ParseOptions("nnet3-train [options] <raw-nnet-in> <egs-rspecifier> <raw-nnet-out>")

    class Opts:
        minibatch_size = 128
        num_epochs = 1
        initial_lr = 1e-3
        final_lr = 1e-4
        max_change = 2.0
        srand = 0

    o = Opts()
    for name, attr in (("minibatch-size", "minibatch_size"), ("num-epochs", "num_epochs"),
                       ("initial-lr", "initial_lr"), ("final-lr", "final_lr"),
                       ("max-change", "max_change"), ("srand", "srand")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    am = AmNnet.load(args[0], device=device())
    egs = _read_egs(args[1])
    if not egs:
        log.error("no egs")
        return 1
    # sorted by length: each minibatch pads little, and few shapes recur
    egs.sort(key=lambda e: e.feats.shape[0])
    steps = max(1, len(egs) // o.minibatch_size) * o.num_epochs
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=o.initial_lr, final_lr=o.final_lr,
                                                max_param_change=o.max_change),
                               steps, lr_factors=am.lr_factors)
    model = am.model.train()
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_ce_train_step(model, optimizer)
    rng = np.random.default_rng(o.srand)
    for epoch in range(o.num_epochs):
        groups = list(iter_merged(egs, o.minibatch_size))
        rng.shuffle(groups)
        losses, accs = [], []
        for group in groups:
            state, metrics = step_fn(state, *batch_ce_egs(group))
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
        mean_loss = float(torch.stack(losses).double().mean())
        log.info("epoch %d: CE %.4f acc %.3f (%d steps)", epoch, mean_loss,
                 float(torch.stack(accs).double().mean()), len(losses))
        if not np.isfinite(mean_loss):
            raise KaldiError("model diverged (non-finite CE): rerun with a lower learning "
                             "rate (reference train.py halves the lr and redoes the iteration)")
    priors = None if am.log_priors is None else am.log_priors.cpu().numpy()
    AmNnet(am.config, model.eval(), priors, device=am.device, ivector_dim=am.ivector_dim,
           lr_factors=am.lr_factors).save(args[2])
    return 0


@tool("nnet3-compute-prob")
def nnet3_compute_prob_tool(argv: List[str]) -> int:
    """CE objective and frame accuracy on an egs archive, without updating
    (reference nnet3bin/nnet3-compute-prob.cc)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet

    po = ParseOptions("nnet3-compute-prob <raw-nnet> <egs-rspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    ce, acc, n = _ce_eval(AmNnet.load(args[0], device=device()), _read_egs(args[1]))
    print(f"log-probability per frame: {-ce:.4f} accuracy: {acc:.4f} ({n} frames)")
    return 0


@tool("nnet3-adjust-priors")
def nnet3_adjust_priors_tool(argv: List[str]) -> int:
    """Priors = the model's average posterior over the first --max-egs egs
    (reference nnet3bin/nnet3-adjust-priors.cc / ComputePriors)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.egs import batch_ce_egs
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("nnet3-adjust-priors [options] <raw-nnet-in> <egs-rspecifier> "
                      "<raw-nnet-out>")

    class Opts:
        max_egs = 512

    o = Opts()
    po.register("max-egs", o, "max_egs")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    am = AmNnet.load(args[0], device=device())
    egs = []
    for _k, eg in SequentialTableReader(args[1], "egs"):
        egs.append(eg)
        if len(egs) >= o.max_egs:
            break
    if not egs:
        log.error("no egs")
        return 1
    bf, _bl, bm = batch_ce_egs(egs)
    am.set_priors_from_posteriors(bf, bm.sum(axis=1).astype(np.int32))
    am.save(args[2])
    return 0


@tool("nnet3-combine")
def nnet3_combine_tool(argv: List[str]) -> int:
    """Combination of models with weights optimised on held-out egs
    (reference nnet3bin/nnet3-combine.cc; models/train.combine_models on
    the --max-egs shortest egs as utterances)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.train import combine_models

    po = ParseOptions("nnet3-combine [options] <nnet-in-1> [<nnet-in-2> ...] "
                      "<valid-egs-rspecifier> <nnet-out>")

    class Opts:
        num_steps = 60
        max_egs = 128

    o = Opts()
    po.register("num-steps", o, "num_steps")
    po.register("max-egs", o, "max_egs")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    dev = device()
    ams = [AmNnet.load(p, device=dev) for p in args[:-2]]
    egs = _read_egs(args[-2])
    if not egs:
        log.error("no valid egs")
        return 1
    egs = sorted(egs, key=lambda e: e.feats.shape[0])[: o.max_egs]
    feats = {f"eg{i}": e.feats for i, e in enumerate(egs)}
    labels = {f"eg{i}": e.labels for i, e in enumerate(egs)}
    combine_models(ams, feats, labels, num_steps=o.num_steps).save(args[-1])
    return 0


# ---------------------------------------------------------------------------
# chain tools
# ---------------------------------------------------------------------------

DEN_FORMAT = "old_kaldi_git_tpu_torch.DenominatorGraph/1"


def write_den_graph(den, path: str) -> None:
    """The port's den file: torch.save of the DenominatorGraph."""
    import torch

    torch.save({"format": DEN_FORMAT, "den": den}, path)


def read_den_graph(path: str):
    """A den file of the port's, or the JAX package's pickle (read without
    it, through convert.den_graph_from_pickle)."""
    import torch

    from old_kaldi_git_tpu_torch import convert

    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        d = torch.load(path, map_location="cpu", weights_only=False)
        if d.get("format") != DEN_FORMAT:
            raise KaldiError(f"{path}: not a {DEN_FORMAT} file")
        return d["den"]
    return convert.den_graph_from_pickle(convert.load_pickle(path))


def _read_tree(path: str):
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    with open(path, "rb") as f:
        return ContextDependency.read(f)


@tool("chain-est-phone-lm")
def chain_est_phone_lm_tool(argv: List[str]) -> int:
    """Un-smoothed phone n-gram from alignment phone sequences (reference
    chainbin/chain-est-phone-lm.cc; the input is ali-to-phones')."""
    from old_kaldi_git_tpu_torch.chain.phone_lm import estimate_phone_lm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("chain-est-phone-lm [options] <phone-seqs-rspecifier> <phone-lm-out>")

    class Opts:
        ngram_order = 2

    o = Opts()
    po.register("ngram-order", o, "ngram_order")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    seqs = [list(map(int, v)) for _k, v in SequentialTableReader(args[0], "ivec")]
    lm = estimate_phone_lm(seqs, o.ngram_order)
    with open(args[1], "wb") as f:
        lm.write(f)
    log.info("phone LM: %d states %d arcs from %d sequences", lm.num_states, lm.num_arcs,
             len(seqs))
    return 0


@tool("chain-build-tree")
def chain_build_tree_tool(argv: List[str]) -> int:
    """The chain tree (one-state topology): monophone at --context-width=1,
    else a left biphone from the GMM alignment's statistics with every
    pdf-class pooled into the chain topology's one (reference
    steps/nnet3/chain/build_tree.sh --context-width=2 --central-position=1)."""
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader)

    po = ParseOptions("chain-build-tree [options] <gmm-model> <feats-rspecifier> "
                      "<ali-rspecifier> <tree-out>")

    class Opts:
        context_width = 1
        max_leaves = 500
        thresh = 100.0

    o = Opts()
    po.register("context-width", o, "context_width")
    po.register("max-leaves", o, "max_leaves")
    po.register("thresh", o, "thresh")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    phones = tm.topo.phones
    if o.context_width == 1:
        ctx_dep = monophone_context_dependency(phones, {p: 1 for p in phones})
    else:
        from old_kaldi_git_tpu_torch.tree.build_tree import accumulate_tree_stats, build_tree
        from old_kaldi_git_tpu_torch.tree.event_map import KEY_PDF_CLASS, make_event

        alis = RandomAccessTableReader(args[2], "ivec")
        stats: dict = {}
        for k, feats in SequentialTableReader(args[1], "mat"):
            if k in alis:
                accumulate_tree_stats(alis[k], np.asarray(feats, np.float32), tm, N=2, P=1,
                                      stats=stats)
        pooled: dict = {}
        for event, st in stats.items():
            d = dict(event)
            d[KEY_PDF_CLASS] = 0
            ev = make_event(sorted(d.items()))
            if ev in pooled:
                pooled[ev].add(st)
            else:
                pooled[ev] = st.copy()
        ctx_dep = build_tree(pooled, phones, {p: 1 for p in phones}, N=2, P=1,
                             max_leaves=o.max_leaves, thresh=o.thresh)
    with open(args[3], "wb") as f:
        ctx_dep.write(f)
    log.info("chain tree: %d pdfs (context width %d)", ctx_dep.num_pdfs, o.context_width)
    return 0


@tool("chain-make-den-fst")
def chain_make_den_fst_tool(argv: List[str]) -> int:
    """Phone LM ∘ chain topology → the denominator graph's arrays (reference
    chainbin/chain-make-den-fst.cc), written in the port's den format."""
    from old_kaldi_git_tpu_torch.chain.den_graph import make_denominator_graph
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst

    po = ParseOptions("chain-make-den-fst <tree-file> <phone-lm-fst> <den-out>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    ctx_dep = _read_tree(args[0])
    with open(args[1], "rb") as f:
        phone_lm = VectorFst.read(f)
    den = make_denominator_graph(phone_lm, ctx_dep)
    write_den_graph(den, args[2])
    log.info("den graph: %d states %d arcs %d pdfs", den.num_states, len(den.pdf), den.num_pdfs)
    return 0


@tool("nnet3-chain-init")
def nnet3_chain_init_tool(argv: List[str]) -> int:
    """An untrained chain model: the chain tree, den graph, an xconfig nnet
    drawn from --srand and the chain transition model (the nnet3-am-init role
    for chain systems)."""
    from old_kaldi_git_tpu_torch.chain.topology import chain_topology
    from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel

    po = ParseOptions("nnet3-chain-init [options] <tree-file> <den-file> <xconfig-file> "
                      "<phones:colon-list> <chain-mdl-out>")

    class Opts:
        frame_subsampling_factor = 3
        srand = 0

    o = Opts()
    po.register("frame-subsampling-factor", o, "frame_subsampling_factor")
    po.register("srand", o, "srand")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    ctx_dep = _read_tree(args[0])
    den = read_den_graph(args[1])
    with open(args[2]) as f:
        config = parse_xconfig(f.read())
    phones = [int(x) for x in args[3].split(":") if x]
    tm = TransitionModel.from_context_dependency(ctx_dep, chain_topology(phones))
    am = AmNnet.init(config, seed=o.srand, device=device())
    ChainModel.from_parts(am, ctx_dep, tm, den, o.frame_subsampling_factor).save(args[4])
    return 0


@tool("nnet3-chain-get-egs")
def nnet3_chain_get_egs_tool(argv: List[str]) -> int:
    """Chain egs, one an utterance: the supervision, its den-graph weights
    and the xent labels (reference chainbin/nnet3-chain-get-egs.cc).  An
    utterance whose supervision fails is counted and skipped; no egs at all
    exits 1."""
    from old_kaldi_git_tpu_torch.models.egs import get_chain_egs
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("nnet3-chain-get-egs [options] <gmm-model> <chain-tree> <den-file> "
                      "<feats-rspecifier> <ali-rspecifier> <cegs-wspecifier>")

    class Opts:
        frame_subsampling_factor = 3
        left_tolerance = 5
        right_tolerance = 5

    o = Opts()
    po.register("frame-subsampling-factor", o, "frame_subsampling_factor")
    po.register("left-tolerance", o, "left_tolerance")
    po.register("right-tolerance", o, "right_tolerance")
    args = po.parse(argv)
    if len(args) != 6:
        return _usage(po)
    tm = _host_model(args[0]).tm
    ctx_dep = _read_tree(args[1])
    den = read_den_graph(args[2])
    alis = RandomAccessTableReader(args[4], "ivec")
    n = n_err = 0
    with TableWriter(args[5], "cegs") as w:
        for key, feats in SequentialTableReader(args[3], "mat"):
            if key not in alis:
                continue
            try:
                for i, eg in enumerate(get_chain_egs(
                        np.asarray(feats, np.float32), alis[key], tm, ctx_dep, den,
                        o.frame_subsampling_factor, o.left_tolerance, o.right_tolerance)):
                    w[f"{key}-{i}"] = eg
                    n += 1
            except KaldiError as e:
                log.warning("supervision failed for %s: %s", key, e)
                n_err += 1
    log.info("wrote %d chain egs (%d failed)", n, n_err)
    return 0 if n else 1


def chain_batches(egs, minibatch_size: int, rng: np.random.Generator) -> list:
    """nnet3-chain-train's minibatches of an epoch: the (length-sorted) egs
    in runs of `minibatch_size`, the runs shuffled by `rng`, each stacked
    by batch_chain_egs."""
    from old_kaldi_git_tpu_torch.models.egs import batch_chain_egs, iter_merged

    groups = list(iter_merged(egs, minibatch_size))
    rng.shuffle(groups)
    return [batch_chain_egs(g) for g in groups]


@tool("nnet3-chain-train")
def nnet3_chain_train_tool(argv: List[str]) -> int:
    """LF-MMI training over a chain egs archive (reference
    chainbin/nnet3-chain-train.cc): recipes/chain.make_chain_step (on the
    card its objective runs as CUDA graphs, one pair a distinct batch
    shape), the TDNN-F factors re-constrained after every 4th step.  A
    non-finite mean objective is fatal."""
    import torch

    from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.tdnn import apply_orthonormal_constraints
    from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions, TrainState, make_optimizer
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel, make_chain_step

    po = ParseOptions("nnet3-chain-train [options] <chain-mdl-in> <cegs-rspecifier> "
                      "<chain-mdl-out>")

    class Opts:
        minibatch_size = 8
        num_epochs = 1
        initial_lr = 1e-3
        final_lr = 1e-4
        leaky_hmm_coefficient = 0.1
        l2_regularize = 5e-5
        xent_regularize = 0.1
        srand = 0

    o = Opts()
    for name, attr in (("minibatch-size", "minibatch_size"), ("num-epochs", "num_epochs"),
                       ("initial-lr", "initial_lr"), ("final-lr", "final_lr"),
                       ("leaky-hmm-coefficient", "leaky_hmm_coefficient"),
                       ("l2-regularize", "l2_regularize"),
                       ("xent-regularize", "xent_regularize"), ("srand", "srand")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    cm = ChainModel.load(args[0], device=device())
    egs = _read_egs(args[1], "cegs")
    if not egs:
        log.error("no chain egs")
        return 1
    egs.sort(key=lambda e: e.feats.shape[0])
    loss_opts = ChainLossOptions(leaky_hmm_coefficient=o.leaky_hmm_coefficient,
                                 l2_regularize=o.l2_regularize,
                                 xent_regularize=o.xent_regularize)
    steps = max(1, len(egs) // o.minibatch_size) * o.num_epochs
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=o.initial_lr, final_lr=o.final_lr),
                               steps, lr_factors=cm.am.lr_factors)
    model = cm.am.model.train()
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_chain_step(model, cm.den, optimizer, loss_opts, cm.frame_subsampling_factor)
    rng = np.random.default_rng(o.srand)
    for epoch in range(o.num_epochs):
        objs = []
        for batch in chain_batches(egs, o.minibatch_size, rng):
            state, _loss, metrics = step_fn(state, *batch)
            objs.append(metrics["objf"])
            if state.step % 4 == 0:
                apply_orthonormal_constraints(model)
        mean_obj = float(torch.stack(objs).double().mean()) if objs else float("nan")
        log.info("epoch %d: objf %.4f (%d steps)", epoch, mean_obj, len(objs))
        if objs and not np.isfinite(mean_obj):
            raise KaldiError("chain model diverged (non-finite objective): rerun with a "
                             "lower learning rate")
    priors = None if cm.am.log_priors is None else cm.am.log_priors.cpu().numpy()
    am = AmNnet(cm.am.config, model.eval(), priors, device=cm.am.device,
                ivector_dim=cm.am.ivector_dim, lr_factors=cm.am.lr_factors)
    ChainModel.from_parts(am, cm.ctx_dep, cm.tm, cm.den,
                          cm.frame_subsampling_factor).save(args[2])
    return 0


def _chain_eval(cm, egs, leaky_hmm_coefficient: float = 0.1):
    """(frame-weighted chain objective per frame, frames) of `cm` over a
    cegs list, in length order and groups of 8, l2 and xent off
    (nnet3-chain-compute-prob's figures)."""
    import torch

    from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions, chain_loss
    from old_kaldi_git_tpu_torch.models.egs import batch_chain_egs, iter_merged

    dev = cm.am.device
    opts = ChainLossOptions(leaky_hmm_coefficient=leaky_hmm_coefficient, l2_regularize=0.0,
                            xent_regularize=0.0)
    tot_obj = tot_frames = 0.0
    with torch.no_grad():
        for group in iter_merged(sorted(egs, key=lambda e: e.feats.shape[0]), 8):
            bf, *sup, _xent = (torch.from_numpy(np.asarray(a)).to(dev)
                               for a in batch_chain_egs(group))
            logits = cm.am.logits(bf, output_stride=cm.frame_subsampling_factor)
            _loss, metrics = chain_loss(logits[:, : sup[1].shape[1]], cm.den, *sup, opts)
            frames = float(sup[2].sum())
            tot_obj += float(metrics["objf"]) * frames
            tot_frames += frames
    return tot_obj / max(tot_frames, 1.0), int(tot_frames)


@tool("nnet3-chain-compute-prob")
def nnet3_chain_compute_prob_tool(argv: List[str]) -> int:
    """The chain objective on a cegs archive, without updating (reference
    chainbin/nnet3-chain-compute-prob.cc)."""
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel

    po = ParseOptions("nnet3-chain-compute-prob [options] <chain-mdl> <cegs-rspecifier>")

    class Opts:
        leaky_hmm_coefficient = 0.1

    o = Opts()
    po.register("leaky-hmm-coefficient", o, "leaky_hmm_coefficient")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    cm = ChainModel.load(args[0], device=device())
    egs = _read_egs(args[1], "cegs")
    if not egs:
        log.error("no chain egs")
        return 1
    objf, frames = _chain_eval(cm, egs, o.leaky_hmm_coefficient)
    print(f"chain objective per frame: {objf:.4f} ({frames} frames)")
    return 0


@tool("nnet3-chain-combine")
def nnet3_chain_combine_tool(argv: List[str]) -> int:
    """Chain-model combination optimised on the LF-MMI objective of
    held-out cegs (reference chainbin/nnet3-chain-combine.cc;
    recipes/chain.combine_chain_models)."""
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel, combine_chain_models

    po = ParseOptions("nnet3-chain-combine [options] <chain-mdl-1> [<chain-mdl-2> ...] "
                      "<valid-cegs-rspecifier> <chain-mdl-out>")

    class Opts:
        num_steps = 40
        max_egs = 32

    o = Opts()
    po.register("num-steps", o, "num_steps")
    po.register("max-egs", o, "max_egs")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    dev = device()
    cms = [ChainModel.load(p, device=dev) for p in args[:-2]]
    egs = _read_egs(args[-2], "cegs")
    if not egs:
        log.error("no valid cegs")
        return 1
    combine_chain_models(cms, egs, num_steps=o.num_steps, max_egs=o.max_egs).save(args[-1])
    return 0


# ---------------------------------------------------------------------------
# sequence training
# ---------------------------------------------------------------------------

def _disc_inputs(args: List[str]):
    """(feats, numerator alignments, denominator lattices) of the
    discriminative tools' three tables."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    feats = {k: np.asarray(v, np.float32) for k, v in SequentialTableReader(args[0], "mat")}
    return (feats, dict(SequentialTableReader(args[1], "ivec")),
            dict(SequentialTableReader(args[2], "lat")))


@tool("nnet3-discriminative-train")
def nnet3_discriminative_train_tool(argv: List[str]) -> int:
    """Lattice-based sequence training (MMI / sMBR / MPFE) of an am-nnet
    bundle (reference nnet3bin/nnet3-discriminative-train.cc; the degs are
    read as separate feature, alignment and lattice tables)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel
    from old_kaldi_git_tpu_torch.models.discriminative import (
        DiscriminativeOptions, train_discriminative)

    po = ParseOptions("nnet3-discriminative-train [options] <am-nnet-in> <feats-rspecifier> "
                      "<num-ali-rspecifier> <den-lat-rspecifier> <am-nnet-out>")

    class Opts:
        criterion = "smbr"
        acoustic_scale = 0.1
        num_epochs = 1
        minibatch_size = 8
        learning_rate = 2e-4
        silence_phones = ""

    o = Opts()
    for name, attr in (("criterion", "criterion"), ("acoustic-scale", "acoustic_scale"),
                       ("num-epochs", "num_epochs"), ("minibatch-size", "minibatch_size"),
                       ("learning-rate", "learning_rate"),
                       ("silence-phones", "silence_phones")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    bundle = AmNnetModel.load(args[0], device=device())
    feats, alis, lats = _disc_inputs(args[1:4])
    am = train_discriminative(
        bundle.am, feats, alis, lats, bundle.tm,
        DiscriminativeOptions(criterion=o.criterion, acoustic_scale=o.acoustic_scale,
                              num_epochs=o.num_epochs, minibatch_size=o.minibatch_size,
                              learning_rate=o.learning_rate,
                              silence_phones=tuple(int(p) for p in o.silence_phones.split(":")
                                                   if p)))
    AmNnetModel(am, bundle.tm).save(args[4])
    return 0


@tool("nnet3-discriminative-compute-objf")
def nnet3_discriminative_compute_objf_tool(argv: List[str]) -> int:
    """The average sequence objective per frame over a data set (reference
    nnet3bin/nnet3-discriminative-compute-objf.cc)."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel
    from old_kaldi_git_tpu_torch.models.discriminative import (
        DiscriminativeOptions, compute_discriminative_objf)

    po = ParseOptions("nnet3-discriminative-compute-objf [options] <am-nnet> "
                      "<feats-rspecifier> <num-ali-rspecifier> <den-lat-rspecifier>")

    class Opts:
        criterion = "smbr"
        acoustic_scale = 0.1

    o = Opts()
    po.register("criterion", o, "criterion")
    po.register("acoustic-scale", o, "acoustic_scale")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    bundle = AmNnetModel.load(args[0], device=device())
    feats, alis, lats = _disc_inputs(args[1:4])
    objf = compute_discriminative_objf(
        bundle.am, feats, alis, lats, bundle.tm,
        DiscriminativeOptions(criterion=o.criterion, acoustic_scale=o.acoustic_scale))
    print(f"{o.criterion} objf per frame: {objf:.6f}")
    return 0
