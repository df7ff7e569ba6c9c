"""Implementations of the CLI tools (counterpart of
old_kaldi_git_tpu/bin/tools.py; see bin/__init__ and bin/__main__).

Each tool function takes argv (excluding the tool name) and returns an exit
code.  Reference parity: featbin/compute-{mfcc,fbank,...}-feats,
compute-cmvn-stats, apply-cmvn, add-deltas, the decode and lattice tools,
arpa2fst, prepare-lang / mkgraph and the fstbin tools on the framework's FST
format.  Features go through the MFCC kernel (compute-mfcc-feats), GMM
loglikes through the GMM kernel (gmm-latgen-faster,
online-wav-gmm-latgen-faster) on the device that --device names.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List

import numpy as np

from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("bin")

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def reg(fn):
        TOOLS[name] = fn
        return fn

    return reg


def device_option(po: ParseOptions) -> Callable:
    """Registers --device=cuda|cpu on a tool that makes tensors; returns
    the function that resolves it after parsing (cuda by default, which
    raises without a card: the CPU runs only when it is named)."""

    class Opts:
        device = "cuda"

    o = Opts()
    po.register("device", o, "device", "cuda (default) or cpu")

    def resolve():
        from old_kaldi_git_tpu_torch.device import resolve_device

        return resolve_device(o.device)

    return resolve


def _usage(po: ParseOptions) -> int:
    print(po.print_usage(), file=sys.stderr)
    return 1


def _words_text(words_tab, ids) -> str:
    return " ".join(words_tab[x] if words_tab else str(x) for x in ids)


def _symbols(path: str):
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable

    return SymbolTable.read(path) if path else None


def _host_model(path: str):
    """A GMM model whose transition model or sizes a host tool reads; its
    parameters stay on the host, where no arithmetic touches them."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel

    return AmGmmModel.load(path, device="cpu")


def _wave_tensor(wave, dev, channels=slice(0, 1)):
    import torch

    return torch.from_numpy(np.ascontiguousarray(wave.data[channels], np.float32)).to(dev)


@tool("compute-mfcc-feats")
def compute_mfcc_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.compute import Mfcc, MfccOptions
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = MfccOptions()
    po = ParseOptions("compute-mfcc-feats [options] <wav-rspecifier> <feats-wspecifier>")
    po.register_dataclass(opts.frame_opts)
    po.register_dataclass(opts.mel_opts, prefix="mel")
    po.register("num-ceps", opts, "num_ceps")
    po.register("use-energy", opts, "use_energy")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    mfcc = Mfcc(opts)
    n = 0
    with TableWriter(args[1], "mat") as w:
        for key, wave in SequentialTableReader(args[0], "wav"):
            if wave.samp_freq != opts.frame_opts.samp_freq:
                log.warning("%s: samp_freq %.0f != config %.0f, skipping",
                            key, wave.samp_freq, opts.frame_opts.samp_freq)
                continue
            w[key] = mfcc(_wave_tensor(wave, dev)[0]).cpu().numpy()
            n += 1
    log.info("computed MFCC for %d utterances", n)
    return 0


def _spectral_tool(argv: List[str], name: str, computer, options, mel: bool) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = options()
    po = ParseOptions(f"{name} [options] <wav-rspecifier> <feats-wspecifier>")
    po.register_dataclass(opts.frame_opts)
    if mel:
        po.register_dataclass(opts.mel_opts, prefix="mel")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    comp = computer(opts)
    with TableWriter(args[1], "mat") as w:
        for key, wave in SequentialTableReader(args[0], "wav"):
            w[key] = comp(_wave_tensor(wave, dev)[0]).cpu().numpy()
    return 0


@tool("compute-fbank-feats")
def compute_fbank_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.compute import Fbank, FbankOptions

    return _spectral_tool(argv, "compute-fbank-feats", Fbank, FbankOptions, True)


@tool("compute-cmvn-stats")
def compute_cmvn_stats_tool(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.feat.cmvn import acc_cmvn_stats
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(
        "compute-cmvn-stats [--spk2utt=file] <feats-rspecifier> <stats-wspecifier>")

    class Opts:
        spk2utt = ""

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    feats = dict(SequentialTableReader(args[0], "mat"))

    def stats_of(f):
        return acc_cmvn_stats(torch.from_numpy(f).to(dev))

    with TableWriter(args[1], "mat") as w:
        if o.spk2utt:
            for spk, utts in _read_map(o.spk2utt).items():
                stats = None
                for u in utts.split():
                    if u in feats:
                        s = stats_of(feats[u])
                        stats = s if stats is None else stats + s
                if stats is not None:
                    w[spk] = stats
        else:
            for key, f in feats.items():
                w[key] = stats_of(f)
    return 0


@tool("apply-cmvn")
def apply_cmvn_tool(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.feat.cmvn import apply_cmvn
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("apply-cmvn [--norm-vars=bool] [--utt2spk=file] "
                      "<cmvn-rspecifier> <feats-rspecifier> <feats-wspecifier>")

    class Opts:
        norm_vars = False
        utt2spk = ""

    o = Opts()
    po.register("norm-vars", o, "norm_vars")
    po.register("utt2spk", o, "utt2spk")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    stats = RandomAccessTableReader(args[0], "mat")
    utt2spk = _read_map(o.utt2spk) if o.utt2spk else {}
    with TableWriter(args[2], "mat") as w:
        for key, f in SequentialTableReader(args[1], "mat"):
            skey = utt2spk.get(key, key)
            if skey not in stats:
                log.warning("no cmvn stats for %s", skey)
                continue
            x = torch.from_numpy(np.asarray(f, np.float32)).to(dev)
            w[key] = apply_cmvn(x, stats[skey], o.norm_vars).cpu().numpy()
    return 0


@tool("add-deltas")
def add_deltas_tool(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.feat.functions import DeltaFeaturesOptions, compute_deltas
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = DeltaFeaturesOptions()
    po = ParseOptions("add-deltas [options] <feats-rspecifier> <feats-wspecifier>")
    po.register_dataclass(opts)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    with TableWriter(args[1], "mat") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            x = torch.from_numpy(np.asarray(f, np.float32)).to(dev)
            w[key] = compute_deltas(x, opts).cpu().numpy()
    return 0


@tool("splice-feats")
def splice_feats_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.recipes.triphone import splice_numpy
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("splice-feats [options] <feats-rspecifier> <feats-wspecifier>")

    class Opts:
        left_context = 4
        right_context = 4

    o = Opts()
    po.register("left-context", o, "left_context")
    po.register("right-context", o, "right_context")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "mat") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            w[key] = splice_numpy(f, o.left_context, o.right_context)
    return 0


@tool("copy-feats")
def copy_feats_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("copy-feats [--compress=bool] <feats-rspecifier> <feats-wspecifier>")

    class Opts:
        compress = False

    o = Opts()
    po.register("compress", o, "compress")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "cmat" if o.compress else "mat") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            w[key] = f
    return 0


@tool("compute-wer")
def compute_wer_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("compute-wer <ref-rspecifier> <hyp-rspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    ref = {k: v.split() for k, v in SequentialTableReader(args[0], "text")}
    hyp = {k: v.split() for k, v in SequentialTableReader(args[1], "text")}
    stats = compute_wer(ref, hyp)
    print(stats.report())
    print(f"%SER {100.0 * stats.err_sent / max(stats.num_sent, 1):.2f} "
          f"[ {stats.err_sent} / {stats.num_sent} ]")
    return 0


@tool("ali-to-phones")
def ali_to_phones_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_phones
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("ali-to-phones <model> <ali-rspecifier> <phones-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    with TableWriter(args[2], "ivec") as w:
        for key, ali in SequentialTableReader(args[1], "ivec"):
            w[key] = np.asarray(alignment_to_phones(tm, ali), np.int32)
    return 0


@tool("gmm-info")
def gmm_info_tool(argv: List[str]) -> int:
    po = ParseOptions("gmm-info <model>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    m = _host_model(args[0])
    print(f"number of phones {len(m.tm.topo.phones)}")
    print(f"number of pdfs {m.am.num_pdfs}")
    print(f"number of transition-ids {m.tm.num_tids}")
    print(f"number of transition-states {len(m.tm.tuples)}")
    print(f"number of gaussians {m.am.num_gauss}")
    print(f"feature dimension {m.am.dim}")
    return 0


@tool("arpa2fst")
def arpa2fst_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa

    po = ParseOptions("arpa2fst --words=words.txt <arpa-file> <fst-out>")

    class Opts:
        words = ""

    o = Opts()
    po.register("words", o, "words")
    args = po.parse(argv)
    if len(args) != 2 or not o.words:
        return _usage(po)
    with open(args[0]) as f:
        lm = parse_arpa(f.read())
    return _write_fst(arpa_to_fst(lm, _symbols(o.words)), args[1])


@tool("fstinfo")
def fstinfo_tool(argv: List[str]) -> int:
    po = ParseOptions("fstinfo <fst-file>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    fst = _read_fst(args[0])
    print(f"# of states  {fst.num_states}")
    print(f"# of arcs    {fst.num_arcs}")
    print(f"start state  {fst.start}")
    print(f"# of final states  {sum(1 for s in fst.states() if fst.is_final(s))}")
    return 0


@tool("fstprint")
def fstprint_tool(argv: List[str]) -> int:
    po = ParseOptions("fstprint <fst-file>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    sys.stdout.write(_read_fst(args[0]).to_text())
    return 0


def main(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m old_kaldi_git_tpu_torch.bin <tool> [options] <args>",
              file=sys.stderr)
        print("tools:", file=sys.stderr)
        for name in sorted(TOOLS):
            print(f"  {name}", file=sys.stderr)
        return 0 if argv else 1
    name = argv[0]
    if name not in TOOLS:
        print(f"unknown tool {name!r}; run with --help for the list", file=sys.stderr)
        return 1
    try:
        return TOOLS[name](argv[1:])
    except SystemExit:
        raise
    except (KaldiError, ValueError, OSError) as e:
        print(f"ERROR ({name}): {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# more feature tools
# ---------------------------------------------------------------------------

@tool("compute-spectrogram-feats")
def compute_spectrogram_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.compute import Spectrogram, SpectrogramOptions

    return _spectral_tool(argv, "compute-spectrogram-feats", Spectrogram,
                          SpectrogramOptions, False)


@tool("compute-plp-feats")
def compute_plp_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.compute import Plp, PlpOptions

    return _spectral_tool(argv, "compute-plp-feats", Plp, PlpOptions, True)


@tool("compute-kaldi-pitch-feats")
def compute_kaldi_pitch_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.pitch import PitchOptions, compute_kaldi_pitch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = PitchOptions()
    po = ParseOptions(
        "compute-kaldi-pitch-feats [options] <wav-rspecifier> <feats-wspecifier>")
    po.register_dataclass(opts)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    with TableWriter(args[1], "mat") as w:
        for key, wave in SequentialTableReader(args[0], "wav"):
            w[key] = compute_kaldi_pitch(_wave_tensor(wave, dev), opts)[0].cpu().numpy()
    return 0


@tool("process-kaldi-pitch-feats")
def process_kaldi_pitch_feats(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.feat.pitch import ProcessPitchOptions, process_pitch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = ProcessPitchOptions()
    po = ParseOptions(
        "process-kaldi-pitch-feats [options] <pitch-rspecifier> <feats-wspecifier>")
    po.register_dataclass(opts)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    with TableWriter(args[1], "mat") as w:
        for key, p in SequentialTableReader(args[0], "mat"):
            x = torch.from_numpy(np.asarray(p, np.float32)[None]).to(dev)
            w[key] = process_pitch(x, opts)[0].cpu().numpy()
    return 0


@tool("compute-vad")
def compute_vad_tool(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.ivector.vad import VadOptions, compute_vad_energy
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    opts = VadOptions()
    po = ParseOptions("compute-vad [options] <feats-rspecifier> <vad-wspecifier>")
    po.register_dataclass(opts)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    with TableWriter(args[1], "vec") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            e = torch.from_numpy(np.ascontiguousarray(f[None, :, 0], np.float32)).to(dev)
            w[key] = compute_vad_energy(e, opts)[0].cpu().numpy()
    return 0


@tool("paste-feats")
def paste_feats_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(
        "paste-feats <feats-rspecifier1> <feats-rspecifier2> [...] <wspecifier>")
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    tables = [dict(SequentialTableReader(a, "mat")) for a in args[:-1]]
    with TableWriter(args[-1], "mat") as w:
        for key in tables[0]:
            if not all(key in t for t in tables):
                log.warning("paste-feats: %s missing in some inputs", key)
                continue
            T = min(t[key].shape[0] for t in tables)
            w[key] = np.concatenate([t[key][:T] for t in tables], axis=1)
    return 0


@tool("select-feats")
def select_feats_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions('select-feats <selection> <feats-rspecifier> <wspecifier>  '
                      '(e.g. "0-12" or "0,2,4-6")')
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    cols: List[int] = []
    for piece in args[0].split(","):
        if "-" in piece:
            a, b = piece.split("-")
            cols.extend(range(int(a), int(b) + 1))
        else:
            cols.append(int(piece))
    idx = np.asarray(cols)
    with TableWriter(args[2], "mat") as w:
        for key, f in SequentialTableReader(args[1], "mat"):
            w[key] = f[:, idx]
    return 0


@tool("subsample-feats")
def subsample_feats_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("subsample-feats --n=N <feats-rspecifier> <wspecifier>")

    class Opts:
        n = 1
        offset = 0

    o = Opts()
    po.register("n", o, "n")
    po.register("offset", o, "offset")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "mat") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            w[key] = f[o.offset:: o.n]
    return 0


@tool("extract-segments")
def extract_segments_tool(argv: List[str]) -> int:
    """segments file: <seg-id> <rec-id> <start-sec> <end-sec>"""
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, TableWriter
    from old_kaldi_git_tpu_torch.utils.wav import WaveData

    po = ParseOptions("extract-segments <wav-rspecifier> <segments-file> <wav-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    wavs = RandomAccessTableReader(args[0], "wav")
    n = 0
    with TableWriter(args[2], "wav") as w:
        with open(args[1]) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) != 4:
                    continue
                seg, rec, s, e = parts[0], parts[1], float(parts[2]), float(parts[3])
                if rec not in wavs:
                    log.warning("extract-segments: no wav for %s", rec)
                    continue
                wav = wavs[rec]
                sr = wav.samp_freq
                i0, i1 = int(s * sr), int(e * sr)
                if i1 <= i0 or i0 >= wav.data.shape[1]:
                    log.warning("extract-segments: bad range for %s", seg)
                    continue
                w[seg] = WaveData(samp_freq=sr, data=wav.data[:, i0:i1])
                n += 1
    log.info("extracted %d segments", n)
    return 0


# ---------------------------------------------------------------------------
# decode + lattice tools
# ---------------------------------------------------------------------------

def write_decode_outputs(csr, keys, results, loglikes, nf, acoustic_scale: float,
                         lattice_beam: float, lat_wspec: str, words_wspec,
                         words_tab) -> int:
    """Each utterance's lattice (rebuilt from the decode's kept tokens, or
    from the token-sparse decoder's records on a graph too large for the
    dense state) and, with words_wspec, its words; returns the count
    decoded.  loglikes: [B, T, P] on the host."""
    from old_kaldi_git_tpu_torch.lat.lattice import (
        lattice_from_decode, lattice_from_token_records)
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    wwriter = TableWriter(words_wspec, "text") if words_wspec else None
    n_done = 0
    with TableWriter(lat_wspec, "lat") as lw:
        for i, (k, res) in enumerate(zip(keys, results)):
            if res is None:
                log.warning("decode failed for %s", k)
                continue
            if res.token_lattice is not None:
                lat = lattice_from_token_records(csr, res.token_lattice)
            else:
                lat = lattice_from_decode(csr, loglikes[i, : nf[i]], res.frame_states,
                                          res.frame_costs, acoustic_scale, lattice_beam)
            if lat is not None:
                lw[k] = lat
            if wwriter is not None:
                wwriter[k] = _words_text(words_tab, res.words)
            n_done += 1
    if wwriter is not None:
        wwriter.close()
    log.info("decoded %d/%d utterances", n_done, len(keys))
    return n_done


@tool("gmm-latgen-faster")
def gmm_latgen_faster_tool(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("gmm-latgen-faster [options] <model> <hclg-fst> <feats-rspecifier> "
                      "<lattice-wspecifier> [<words-wspecifier>]")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 0.1
        lattice_beam = 10.0
        word_symbol_table = ""

    o = Opts()
    for name, attr in (("beam", "beam"), ("max-active", "max_active"),
                       ("acoustic-scale", "acoustic_scale"),
                       ("lattice-beam", "lattice_beam"),
                       ("word-symbol-table", "word_symbol_table")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) not in (4, 5):
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    csr = read_hclg_csr(args[1], model.tm.tid_to_pdf_array())
    feats = dict(SequentialTableReader(args[2], "mat"))
    if not feats:
        log.warning("no features")
        return 1
    keys, padded, nf = pad_feature_batch(feats)
    loglikes = model.am.loglikes_batch(torch.from_numpy(padded).to(dev))
    results = decode_batch(csr, loglikes, nf,
                           ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                          acoustic_scale=o.acoustic_scale),
                           want_lattice=True, device=dev)
    write_decode_outputs(csr, keys, results, loglikes.cpu().numpy(), nf, o.acoustic_scale,
                         o.lattice_beam, args[3], args[4] if len(args) == 5 else None,
                         _symbols(o.word_symbol_table))
    return 0


@tool("lattice-best-path")
def lattice_best_path_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-best-path [options] <lattice-rspecifier> <words-wspecifier> "
                      "[<ali-wspecifier>]")

    class Opts:
        lm_scale = 1.0
        acoustic_scale = 0.1
        word_symbol_table = ""

    o = Opts()
    po.register("lm-scale", o, "lm_scale")
    po.register("acoustic-scale", o, "acoustic_scale")
    po.register("word-symbol-table", o, "word_symbol_table")
    args = po.parse(argv)
    if len(args) not in (2, 3):
        return _usage(po)
    words_tab = _symbols(o.word_symbol_table)
    awriter = TableWriter(args[2], "ivec") if len(args) == 3 else None
    with TableWriter(args[1], "text") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            ws, tids, _ = lattice_best_path(lat, o.lm_scale, o.acoustic_scale)
            w[key] = _words_text(words_tab, ws)
            if awriter is not None:
                awriter[key] = np.asarray(tids, np.int32)
    if awriter is not None:
        awriter.close()
    return 0


@tool("lattice-prune")
def lattice_prune_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_prune
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-prune [options] <lat-rspecifier> <lat-wspecifier>")

    class Opts:
        beam = 4.0
        acoustic_scale = 0.1

    o = Opts()
    po.register("beam", o, "beam")
    po.register("acoustic-scale", o, "acoustic_scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            w[key] = lattice_prune(lat, o.beam, 1.0, o.acoustic_scale)
    return 0


@tool("lattice-scale")
def lattice_scale_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.lattice import INF
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-scale [options] <lat-rspecifier> <lat-wspecifier>")

    class Opts:
        lm_scale = 1.0
        acoustic_scale = 1.0

    o = Opts()
    po.register("lm-scale", o, "lm_scale")
    po.register("acoustic-scale", o, "acoustic_scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            for s in range(lat.num_states):
                for a in lat.arcs[s]:
                    a.graph_cost *= o.lm_scale
                    a.acoustic_cost *= o.acoustic_scale
                g, ac = lat.finals[s]
                if g != INF:
                    lat.finals[s] = (g * o.lm_scale, ac * o.acoustic_scale)
            w[key] = lat
    return 0


@tool("lattice-determinize-pruned")
def lattice_determinize_pruned_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.determinize import determinize_lattice_pruned
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-determinize-pruned [options] <lat-rspecifier> "
                      "<clat-wspecifier>")

    class Opts:
        beam = 10.0
        acoustic_scale = 0.1

    o = Opts()
    po.register("beam", o, "beam")
    po.register("acoustic-scale", o, "acoustic_scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "clat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            w[key] = determinize_lattice_pruned(lat, o.beam, acoustic_scale=o.acoustic_scale)
    return 0


@tool("lattice-lmrescore-const-arpa")
def lattice_lmrescore_const_arpa_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice
    from old_kaldi_git_tpu_torch.lm.arpa import load_lm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-lmrescore-const-arpa [options] --words=words.txt "
                      "<clat-rspecifier> <const-arpa-or-arpa-file> <clat-wspecifier>")

    class Opts:
        lm_scale = 1.0
        words = ""

    o = Opts()
    po.register("lm-scale", o, "lm_scale")
    po.register("words", o, "words")
    args = po.parse(argv)
    if len(args) != 3 or not o.words:
        return _usage(po)
    lm = load_lm(args[1])
    words = _symbols(o.words)
    with TableWriter(args[2], "clat") as w:
        for key, clat in SequentialTableReader(args[0], "clat"):
            w[key] = lmrescore_compact_lattice(clat, words, lm, new_scale=o.lm_scale)
    return 0


@tool("lattice-to-nbest")
def lattice_to_nbest_tool(argv: List[str]) -> int:
    """N best paths per lattice, written as linear lattices keyed
    <key>-1..<key>-n (reference src/latbin/lattice-to-nbest.cc: the scales
    rank paths; output arcs keep the original separate costs)."""
    from old_kaldi_git_tpu_torch.lat.lattice import (
        lattice_nbest_paths, linear_lattice_from_path)
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-to-nbest [options] <lat-rspecifier> <nbest-wspecifier>")

    class Opts:
        n = 10
        lm_scale = 1.0
        acoustic_scale = 0.1

    o = Opts()
    po.register("n", o, "n")
    po.register("lm-scale", o, "lm_scale")
    po.register("acoustic-scale", o, "acoustic_scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            paths = lattice_nbest_paths(lat, o.n, o.lm_scale, o.acoustic_scale)
            for i, (arcs, final) in enumerate(paths):
                w[f"{key}-{i + 1}"] = linear_lattice_from_path(arcs, final)
    return 0


@tool("nbest-to-linear")
def nbest_to_linear_tool(argv: List[str]) -> int:
    """Split linear (n-best) lattices into alignment / word / cost tables
    (reference src/latbin/nbest-to-linear.cc)."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("nbest-to-linear <nbest-rspecifier> <ali-wspecifier> "
                      "[<words-wspecifier> [<lmcost-wspecifier> [<accost-wspecifier>]]]")
    args = po.parse(argv)
    if len(args) not in (2, 3, 4, 5):
        return _usage(po)
    wri = [TableWriter(a, f) for a, f in zip(args[1:], ("ivec", "text", "text", "text"))]
    n_err = 0
    for key, lat in SequentialTableReader(args[0], "lat"):
        ali: List[int] = []
        words: List[int] = []
        lm_cost = ac_cost = 0.0
        s, ok, seen = lat.start, True, 0
        while not lat.is_final(s):
            if len(lat.arcs[s]) != 1 or seen > lat.num_states:
                log.warning("lattice %s is not linear", key)
                n_err += 1
                ok = False
                break
            a = lat.arcs[s][0]
            if a.ilabel:
                ali.append(a.ilabel)
            if a.olabel:
                words.append(a.olabel)
            lm_cost += a.graph_cost
            ac_cost += a.acoustic_cost
            s = a.nextstate
            seen += 1
        if not ok:
            continue
        g, ac = lat.finals[s]
        lm_cost += g
        ac_cost += ac
        wri[0][key] = np.asarray(ali, np.int32)
        if len(wri) > 1:
            wri[1][key] = " ".join(str(x) for x in words)
        if len(wri) > 2:
            wri[2][key] = f"{lm_cost:.6g}"
        if len(wri) > 3:
            wri[3][key] = f"{ac_cost:.6g}"
    for w in wri:
        w.close()
    return 0 if n_err == 0 else 1


@tool("linear-to-nbest")
def linear_to_nbest_tool(argv: List[str]) -> int:
    """Inverse of nbest-to-linear: linear lattices from alignments and words
    (and optional costs; reference src/latbin/linear-to-nbest.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import Lattice, LatticeArc
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("linear-to-nbest <ali-rspecifier> <words-rspecifier> "
                      "<lmcost-rspecifier|''> <accost-rspecifier|''> <nbest-wspecifier>")
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    words_r = RandomAccessTableReader(args[1], "text")
    lm_r = RandomAccessTableReader(args[2], "text") if args[2] else None
    ac_r = RandomAccessTableReader(args[3], "text") if args[3] else None
    with TableWriter(args[4], "lat") as w:
        for key, ali in SequentialTableReader(args[0], "ivec"):
            if key not in words_r:
                log.warning("no words for %s", key)
                continue
            ws = [int(x) for x in words_r[key].split()]
            lm_cost = float(lm_r[key]) if lm_r is not None else 0.0
            ac_cost = float(ac_r[key]) if ac_r is not None else 0.0
            lat = Lattice()
            cur = lat.add_state(0)
            lat.start = cur
            for i in range(max(len(ali), len(ws), 1)):
                tid = int(ali[i]) if i < len(ali) else 0
                wd = ws[i] if i < len(ws) else 0
                nxt = lat.add_state(i + 1 if tid else 0)
                # every cost on the first arc, as the reference does
                lat.arcs[cur].append(LatticeArc(tid, wd, lm_cost if i == 0 else 0.0,
                                                ac_cost if i == 0 else 0.0, nxt))
                cur = nxt
            lat.finals[cur] = (0.0, 0.0)
            w[key] = lat
    return 0


@tool("lattice-combine")
def lattice_combine_tool(argv: List[str]) -> int:
    """Union of the lattices with one key across several archives
    (reference src/latbin/lattice-combine.cc / fst::Union; --lat-weights
    scales each archive's posterior contribution through an added graph
    cost)."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_union
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("lattice-combine [options] <lat-rspecifier1> <lat-rspecifier2> "
                      "[...] <lat-wspecifier>")

    class Opts:
        lat_weights = ""  # colon-separated, e.g. 0.5:0.5

    o = Opts()
    po.register("lat-weights", o, "lat_weights")
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    n_in = len(args) - 1
    weights = ([float(x) for x in o.lat_weights.split(":")] if o.lat_weights
               else [1.0] * n_in)
    if len(weights) != n_in:
        log.error("--lat-weights needs %d values", n_in)
        return 1
    readers = [RandomAccessTableReader(a, "lat") for a in args[1:-1]]
    n_done = 0
    with TableWriter(args[-1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            lats, wts = [lat], [weights[0]]
            for r, wt in zip(readers, weights[1:]):
                if key in r:
                    lats.append(r[key])
                    wts.append(wt)
            for la, wt in zip(lats, wts):
                if wt != 1.0:  # -log posterior weight on the start arcs
                    la.arcs[la.start] = [
                        type(a)(a.ilabel, a.olabel, a.graph_cost - math.log(max(wt, 1e-30)),
                                a.acoustic_cost, a.nextstate)
                        for a in la.arcs[la.start]]
            w[key] = lattice_union(lats) if len(lats) > 1 else lats[0]
            n_done += 1
    log.info("combined %d lattices", n_done)
    return 0


@tool("lattice-mbr-decode")
def lattice_mbr_decode_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.mbr import minimum_bayes_risk
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-mbr-decode [options] <clat-rspecifier> <words-wspecifier> "
                      "[<conf-wspecifier>]")

    class Opts:
        lm_scale = 1.0
        acoustic_scale = 0.1
        word_symbol_table = ""

    o = Opts()
    po.register("lm-scale", o, "lm_scale")
    po.register("acoustic-scale", o, "acoustic_scale")
    po.register("word-symbol-table", o, "word_symbol_table")
    args = po.parse(argv)
    if len(args) not in (2, 3):
        return _usage(po)
    words_tab = _symbols(o.word_symbol_table)
    cwriter = TableWriter(args[2], "vec") if len(args) == 3 else None
    with TableWriter(args[1], "text") as w:
        for key, clat in SequentialTableReader(args[0], "clat"):
            res = minimum_bayes_risk(clat, o.lm_scale, o.acoustic_scale)
            if res is None:
                log.warning("MBR failed for %s", key)
                continue
            w[key] = _words_text(words_tab, res.words)
            if cwriter is not None:
                cwriter[key] = np.asarray(res.confidences, np.float32)
    if cwriter is not None:
        cwriter.close()
    return 0


@tool("nnet3-info")
def nnet3_info_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet

    po = ParseOptions("nnet3-info <nnet-file>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    am = AmNnet.load(args[0], device=device())
    cfg = am.config
    print(f"input-dim: {cfg.input_dim}")
    print(f"output-dim: {cfg.num_outputs}")
    print(f"left-context: {cfg.left_context}")
    print(f"right-context: {cfg.right_context}")
    print(f"num-parameters: {sum(p.numel() for p in am.model.parameters())}")
    for i, layer in enumerate(cfg.layers):
        print(f"layer {i}: {layer.kind} dim={layer.dim}")
    return 0


@tool("nnet3-compute")
def nnet3_compute_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("nnet3-compute [options] <nnet-file> <feats-rspecifier> "
                      "<loglikes-wspecifier>")

    class Opts:
        use_priors = True

    o = Opts()
    po.register("use-priors", o, "use_priors")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    am = AmNnet.load(args[0], device=device())
    with TableWriter(args[2], "mat") as w:
        for key, f in SequentialTableReader(args[1], "mat"):
            x = np.asarray(f, np.float32)[None]
            out = am.loglikes_batch(x) if o.use_priors else am.logits(x)
            w[key] = out[0].cpu().numpy()
    return 0


@tool("lattice-oracle")
def lattice_oracle_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_oracle
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-oracle <lat-rspecifier> <ref-rspecifier> <oracle-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    refs = {k: [int(x) for x in v.split()] for k, v in SequentialTableReader(args[1], "text")}
    tot_err = tot_words = 0
    with TableWriter(args[2], "text") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            if key not in refs:
                continue
            d, words = lattice_oracle(lat, refs[key])
            w[key] = " ".join(str(x) for x in words)
            tot_err += d
            tot_words += len(refs[key])
    print(f"%WER {100.0 * tot_err / max(tot_words, 1):.2f} "
          f"[ {tot_err} / {tot_words} ] (oracle)")
    return 0


@tool("lattice-depth")
def lattice_depth_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_depth
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("lattice-depth <lat-rspecifier>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    tot = n = 0.0
    for key, lat in SequentialTableReader(args[0], "lat"):
        d = lattice_depth(lat)
        print(f"{key} {d:.2f}")
        tot += d
        n += 1
    if n:
        print(f"mean depth {tot / n:.2f} over {int(n)} lattices")
    return 0


@tool("prepare-lang")
def prepare_lang_tool(argv: List[str]) -> int:
    """lexicon.txt (word phone phone ...) → lang dir (words / phones / L
    FSTs); the utils/prepare_lang.sh role."""
    import os

    from old_kaldi_git_tpu_torch.fst.lang import lang_from_lexicon_file, read_lexicon_file

    po = ParseOptions("prepare-lang [options] <lexicon.txt> <lang-dir>")

    class Opts:
        silence_phone = "SIL"
        sil_prob = 0.5

    o = Opts()
    po.register("silence-phone", o, "silence_phone")
    po.register("sil-prob", o, "sil_prob")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    lex = read_lexicon_file(args[0])
    lang = lang_from_lexicon_file(args[0], o.silence_phone, o.sil_prob)
    os.makedirs(args[1], exist_ok=True)
    lang.words.write(os.path.join(args[1], "words.txt"))
    lang.phones.write(os.path.join(args[1], "phones.txt"))
    _write_fst(lang.L, os.path.join(args[1], "L.fst"))
    _write_fst(lang.L_disambig, os.path.join(args[1], "L_disambig.fst"))
    with open(os.path.join(args[1], "lexicon.txt"), "w") as f:
        for w, prons in lex.items():
            for p in prons:
                f.write(f"{w} {p}\n")
    log.info("prepare-lang: %d words, %d phones → %s",
             len(lang.words) - 2, len(lang.phones), args[1])
    return 0


@tool("mkgraph")
def mkgraph_tool(argv: List[str]) -> int:
    """lang dir + ARPA LM + model → HCLG.fst (the utils/mkgraph.sh role), on
    the native graph library.  The lang dir must come from prepare-lang
    (lexicon.txt is reread so the Lang keeps its pronunciations)."""
    import os

    from old_kaldi_git_tpu_torch.decoder.graph import mkgraph
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa
    from old_kaldi_git_tpu_torch.tree.context_dep import (
        ContextDependency, monophone_context_dependency)

    po = ParseOptions("mkgraph [options] <lang-dir> <arpa-file> <model> <graph-dir>")

    class Opts:
        self_loop_scale = 0.1
        silence_phone = "SIL"
        sil_prob = 0.5
        tree = ""  # ContextDependency file for context-dependent models

    o = Opts()
    po.register("self-loop-scale", o, "self_loop_scale")
    po.register("silence-phone", o, "silence_phone")
    po.register("sil-prob", o, "sil_prob")
    po.register("tree", o, "tree")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    lang = load_lang_dir(args[0], o.silence_phone, o.sil_prob)
    with open(args[1]) as f:
        g = arpa_to_fst(parse_arpa(f.read()), lang.words)
    tm = _host_model(args[2]).tm
    if o.tree:
        with open(o.tree, "rb") as f:
            ctx_dep = ContextDependency.read(f)
    else:
        phones = lang.real_phone_ids
        ctx_dep = monophone_context_dependency(
            phones, {p: tm.topo.num_pdf_classes(p) for p in phones})
    hclg = mkgraph(lang, g, ctx_dep, tm, self_loop_scale=o.self_loop_scale)
    os.makedirs(args[3], exist_ok=True)
    _write_fst(hclg, os.path.join(args[3], "HCLG.fst"))
    lang.words.write(os.path.join(args[3], "words.txt"))
    log.info("mkgraph: HCLG %d states / %d arcs → %s", hclg.num_states, hclg.num_arcs,
             args[3])
    return 0


def streaming_words(dec, samples: np.ndarray, chunk: int, pipe, am=None,
                    stop_at_endpoint: bool = True) -> List[int]:
    """Feed one wave to a streaming decoder in chunks of `chunk` samples
    (through `am`, a StreamingAmNnet, when the decoder takes loglikes) and
    return its words; with stop_at_endpoint the feed stops at the first
    endpoint, as the online tools do."""
    def feed(feats, final=False):
        dec.advance(am.accept(feats, final=final) if am is not None else feats, final=final)

    for lo in range(0, len(samples), chunk):
        feed(pipe.accept_waveform(samples[lo: lo + chunk]))
        if stop_at_endpoint and dec.endpoint_detected():
            log.info("endpoint detected")
            if am is None:
                break
            return dec.best_words()
    feed(pipe.input_finished(), final=True)
    return dec.best_words()


@tool("online-wav-gmm-latgen-faster")
def online_wav_gmm_latgen_tool(argv: List[str]) -> int:
    """Simulated-real-time streaming decode of wav files (the
    online2-wav-*-latgen-faster role): chunked audio → streaming features
    (the MFCC kernel) → the streaming decoder on GMM loglikes (the GMM
    kernel) with endpointing; prints partials, finals and RTF."""
    import time as _time

    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
    from old_kaldi_git_tpu_torch.feat.compute import MfccOptions
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.online.streaming import (
        OnlineFeaturePipeline, StreamingDecoder)
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("online-wav-gmm-latgen-faster [options] <model> <hclg-fst> "
                      "<wav-rspecifier> <words-wspecifier>")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 0.1
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
    model = AmGmmModel.load(args[0], device=dev)
    csr = read_hclg_csr(args[1], model.tm.tid_to_pdf_array())
    words_tab = _symbols(o.word_symbol_table)
    mfcc_opts = MfccOptions()
    mfcc_opts.frame_opts.samp_freq = o.samp_freq
    mfcc_opts.frame_opts.dither = 0.0
    vopts = ViterbiOptions(beam=o.beam, max_active=o.max_active,
                           acoustic_scale=o.acoustic_scale)
    tid_to_phone = model.tm.tid_to_phone_array()
    chunk = int(o.chunk_seconds * o.samp_freq)
    tot_audio = tot_wall = 0.0
    with TableWriter(args[3], "text") as w:
        for key, wave in SequentialTableReader(args[2], "wav"):
            pipe = OnlineFeaturePipeline(mfcc_opts, device=dev)
            dec = StreamingDecoder(csr, model.am.loglikes_batch,
                                   silence_phones=[o.silence_phone_id],
                                   tid_to_phone=tid_to_phone, opts=vopts, device=dev)
            samples = wave.data[0]
            t0 = _time.perf_counter()
            text = _words_text(words_tab, streaming_words(dec, samples, chunk, pipe))
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


def _read_fst(path: str):
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst

    with open(path, "rb") as f:
        return VectorFst.read(f)


def _write_fst(fst, path: str) -> int:
    with open(path, "wb") as f:
        fst.write(f)
    return 0


@tool("fstcompose")
def fstcompose_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import compose

    po = ParseOptions("fstcompose <fst1> <fst2> <out-fst>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    return _write_fst(compose(_read_fst(args[0]), _read_fst(args[1])), args[2])


@tool("fstdeterminizestar")
def fstdeterminizestar_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import determinize_star

    po = ParseOptions("fstdeterminizestar [--use-log=bool] <fst> <out-fst>")

    class Opts:
        use_log = False

    o = Opts()
    po.register("use-log", o, "use_log")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    return _write_fst(determinize_star(_read_fst(args[0]), use_log=o.use_log), args[1])


@tool("fstminimizeencoded")
def fstminimizeencoded_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import minimize_encoded

    po = ParseOptions("fstminimizeencoded <fst> <out-fst>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    return _write_fst(minimize_encoded(_read_fst(args[0])), args[1])


@tool("fstpushspecial")
def fstpushspecial_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import push_special

    po = ParseOptions("fstpushspecial <fst> <out-fst>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    fst = _read_fst(args[0])
    push_special(fst)
    return _write_fst(fst, args[1])


@tool("fstrmepslocal")
def fstrmepslocal_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import remove_eps_local

    po = ParseOptions("fstrmepslocal <fst> <out-fst>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    fst = _read_fst(args[0])
    remove_eps_local(fst)
    return _write_fst(fst, args[1])


@tool("fstrmsymbols")
def fstrmsymbols_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import rm_symbols

    po = ParseOptions("fstrmsymbols <symbol-list-file> <fst> <out-fst>  "
                      "(replaces listed input symbols with epsilon)")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    with open(args[0]) as f:
        labels = [int(x) for x in f.read().split()]
    fst = _read_fst(args[1])
    rm_symbols(fst, labels, side="input")
    return _write_fst(fst, args[2])


@tool("fstproject")
def fstproject_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import project

    po = ParseOptions("fstproject [--project-output=bool] <fst> <out-fst>")

    class Opts:
        project_output = False

    o = Opts()
    po.register("project-output", o, "project_output")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    return _write_fst(project(_read_fst(args[0]), "output" if o.project_output else "input"),
                      args[1])


@tool("fstshortestpath")
def fstshortestpath_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.algorithms import shortest_path

    po = ParseOptions("fstshortestpath <fst>   (prints cost, ilabels, olabels)")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    cost, ils, ols = shortest_path(_read_fst(args[0]))
    print(f"cost {cost:.6g}")
    print("ilabels " + " ".join(str(x) for x in ils))
    print("olabels " + " ".join(str(x) for x in ols))
    return 0


@tool("nnet3-average")
def nnet3_average_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.train import average_models

    po = ParseOptions("nnet3-average <model1> <model2> [...] <model-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    dev = device()
    ams = [AmNnet.load(p, device=dev) for p in args[:-1]]
    average_models(ams).save(args[-1])
    log.info("averaged %d models -> %s", len(ams), args[-1])
    return 0


@tool("wav-reverberate")
def wav_reverberate_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.feat.signal import add_noise, reverberate
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)
    from old_kaldi_git_tpu_torch.utils.wav import WaveData, read_wav

    po = ParseOptions("wav-reverberate [options] <wav-rspecifier> <wav-wspecifier>")

    class Opts:
        impulse_response = ""  # wav file with the RIR
        additive_noise = ""  # wav rspecifier; mixed per utterance (by key)
        snr_db = 20.0
        volume = 0.0  # 0 = auto power normalisation
        seed = 0  # noise-window randomisation (reproducible per run)

    o = Opts()
    po.register("impulse-response", o, "impulse_response")
    po.register("additive-noise", o, "additive_noise")
    po.register("snr-db", o, "snr_db")
    po.register("volume", o, "volume")
    po.register("seed", o, "seed")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    rir = read_wav(o.impulse_response).data[0] if o.impulse_response else None
    noises = RandomAccessTableReader(o.additive_noise, "wav") if o.additive_noise else None
    rng = np.random.default_rng(o.seed)  # one stream: windows vary per utterance
    with TableWriter(args[1], "wav") as w:
        for key, wave in SequentialTableReader(args[0], "wav"):
            sig = wave.data[0]
            if rir is not None:
                sig = reverberate(sig, rir, volume=o.volume if o.volume else None)
            if noises is not None and key in noises:
                sig = add_noise(sig, noises[key].data[0], o.snr_db, rng=rng)
            w[key] = WaveData(samp_freq=wave.samp_freq, data=sig[None])
    return 0


# registration side effect: the nnet3 serving, alignment, lattice, utility, training,
# speaker-ID, SGMM2 and keyword-search tools
from old_kaldi_git_tpu_torch.bin import nnet3_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import train_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import lat_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import util_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import spkid_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import sgmm2_tools  # noqa: E402,F401  (isort:skip)
from old_kaldi_git_tpu_torch.bin import kws_tools  # noqa: E402,F401  (isort:skip)
