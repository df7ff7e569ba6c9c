"""run_all: the five BASELINE configs as one stage-gated pipeline.

Counterpart of old_kaldi_git_tpu/recipes/run_all.py (reference
egs/<corpus>/s5/run.sh): data prep → mono → tri (deltas) → LDA+MLLT →
SAT/fMLLR decode → nnet3 CE TDNN → TDNN + online iVectors → chain LF-MMI →
lattice LM rescoring → streaming decode, on `device` (None: the GPU).  Every
stage is skipped below `--stage` and when its artifacts exist
(utils/pipeline.py), logs to <workdir>/log/, and appends its WER lines to
<workdir>/RESULTS (the egs RESULTS convention).  The stages exchange their
artifacts on disk: alignments as `ivec` archives and features as `mat`
archives (utils/table.py), trees in the JAX package's token format, GMM
models as `.mdl`, the neural models in the port's formats.

The corpus is the synthetic yesno of recipes/yesno.py (24 training and 8
test utterances), and the options are the JAX package's: GMM stages at 8
iterations towards 60 Gaussians, 60 leaves, LDA to 20 dimensions with MLLT
after iterations 2 and 4; 64-wide 3-layer TDNNs for 30 epochs; decodes at
beam 20, fMLLR from 50 frames, lattice beam 12.

Run:  python -m old_kaldi_git_tpu_torch.recipes.run_all --workdir exp/run_all
      [--stage N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler, mkgraph_csr
from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat import MfccOptions
from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.ivector.extractor import (
    IvectorExtractor,
    extract_online_ivectors,
    train_ivector_extractor,
    train_ubm,
)
from old_kaldi_git_tpu_torch.lat.determinize import determinize_lattice_pruned
from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice
from old_kaldi_git_tpu_torch.lm.arpa import parse_arpa
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnetModel
from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions
from old_kaldi_git_tpu_torch.online.streaming import OnlineFeaturePipeline, StreamingDecoder
from old_kaldi_git_tpu_torch.recipes import yesno
from old_kaldi_git_tpu_torch.recipes.chain import (
    ChainTrainOptions,
    decode_chain,
    make_chain_decode_graph,
    train_chain,
)
from old_kaldi_git_tpu_torch.recipes.decode import (
    DecodeOptions,
    decode_dataset,
    decode_dataset_with_lattices,
    score_hyps,
)
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions, align_all
from old_kaldi_git_tpu_torch.recipes.mono import train_mono
from old_kaldi_git_tpu_torch.recipes.nnet3 import decode_tdnn, train_tdnn
from old_kaldi_git_tpu_torch.recipes.triphone import (
    estimate_fmllr_per_speaker,
    splice_numpy,
    train_deltas,
    train_lda_mllt,
)
from old_kaldi_git_tpu_torch.transform.fmllr import apply_affine_transform
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.pipeline import Pipeline, PipelineContext
from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

log = get_logger("run_all")

NUM_TRAIN, NUM_TEST = 24, 8


def _fast() -> GmmTrainOptions:
    return GmmTrainOptions(num_iters=8, totgauss=60, realign_iters=(1, 2, 3, 4, 6))


def _nnet_opts() -> NnetTrainOptions:
    return NnetTrainOptions(num_epochs=30, minibatch_size=8, chunk_width=64)


def _corpus():
    tw, tt, sw, st = yesno.make_corpus(NUM_TRAIN, NUM_TEST)
    return tw, tt, sw, st, yesno.make_lang()


def _result(ctx: PipelineContext, name: str, wer: float) -> None:
    with open(ctx.path("RESULTS"), "a") as f:
        f.write(f"%WER {wer:.2f} [{name}]\n")
    log.info("RESULT %s: %%WER %.2f", name, wer)


def _read_ali(path: str) -> Dict[str, np.ndarray]:
    return read_table(f"ark:{path}", "ivec")


def _write_ali(path: str, ali: Dict[str, np.ndarray]) -> None:
    with TableWriter(f"ark:{path}", "ivec") as w:
        for k, a in sorted(ali.items()):
            if a is not None:
                w[k] = np.asarray(a, np.int32)


def _read_tree(path: str) -> ContextDependency:
    with open(path, "rb") as f:
        return ContextDependency.read(f)


def _write_tree(path: str, tree: ContextDependency) -> None:
    with open(path, "wb") as f:
        tree.write(f)


def _unigram_graph(lang, train_text, tree, tm):
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    return mkgraph_csr(lang, g, tree, tm)


def _lda_test_feats(ctx: PipelineContext, waves, dev) -> Dict[str, np.ndarray]:
    """The test set's statics spliced ±3 and projected by tri2b's transform,
    float32 (the JAX package's numpy promotion)."""
    transform = np.load(ctx.path("tri2b/transform.npy"))
    return {k: (splice_numpy(v) @ transform.T).astype(np.float32)
            for k, v in yesno.compute_static_feats(waves, dev).items()}


def _bigram_arpa(train_text: Dict[str, List[str]]) -> str:
    """A bigram estimated from the training text (ARPA, log10)."""
    counts: Dict[tuple, int] = {}
    uni: Dict[str, int] = {}
    for words in train_text.values():
        seq = ["<s>"] + list(words) + ["</s>"]
        for a, b in zip(seq[:-1], seq[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
            uni[a] = uni.get(a, 0) + 1
    uni["</s>"] = len(train_text)
    tot = sum(uni.values())
    lines = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(counts)}", "", "\\1-grams:"]
    for w, c in sorted(uni.items()):
        lines.append(f"{math.log10(max(c, 1) / tot):.6f}\t{w}\t-0.30103")
    lines += ["", "\\2-grams:"]
    for (a, b), c in sorted(counts.items()):
        lines.append(f"{math.log10(c / uni[a]):.6f}\t{a} {b}")
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def build_pipeline(workdir: str, stage: int = 0, device: DeviceLike = None) -> Pipeline:
    """The stages 0, 10, 20, 30, 40, 50-53, 60, 70 and 80 of the JAX
    package's run_all, on `device` (None: the GPU)."""
    dev = resolve_device(device)
    pipe = Pipeline(workdir, stage=stage)

    @pipe.stage(0, "prepare data", produces=("data/feats_train.ark",))
    def _prepare(ctx):
        tw, tt, sw, st, _ = _corpus()
        for name, feats in (("feats_train", yesno.compute_feats(tw, dev)),
                            ("feats_test", yesno.compute_feats(sw, dev)),
                            ("static_train", yesno.compute_static_feats(tw, dev)),
                            ("static_test", yesno.compute_static_feats(sw, dev))):
            with TableWriter(f"ark:{ctx.path(f'data/{name}.ark')}", "mat") as w:
                for k, f in sorted(feats.items()):
                    w[k] = f
        for name, text in (("text", tt), ("ref", st)):
            with TableWriter(f"ark:{ctx.path(f'data/{name}.ark')}", "text") as w:
                for k, words in sorted(text.items()):
                    w[k] = " ".join(words)

    @pipe.stage(10, "train mono", produces=("mono/final.mdl", "mono/ali.ark"))
    def _mono(ctx):
        tw, tt, _, _, lang = _corpus()
        model, ali = train_mono(yesno.compute_feats(tw, dev), tt, lang, _fast(), device=dev)
        model.save(ctx.path("mono/final.mdl"))
        _write_ali(ctx.path("mono/ali.ark"), ali)

    @pipe.stage(20, "train tri deltas",
                produces=("tri1/final.mdl", "tri1/tree", "tri1/ali.ark"))
    def _tri(ctx):
        tw, tt, _, _, lang = _corpus()
        mono = AmGmmModel.load(ctx.path("mono/final.mdl"), device=dev)
        model, tree, ali = train_deltas(yesno.compute_feats(tw, dev), tt, lang, mono,
                                        _read_ali(ctx.path("mono/ali.ark")), num_leaves=60,
                                        opts=_fast(), device=dev)
        model.save(ctx.path("tri1/final.mdl"))
        _write_tree(ctx.path("tri1/tree"), tree)
        _write_ali(ctx.path("tri1/ali.ark"), ali)

    @pipe.stage(30, "train lda+mllt", produces=("tri2b/final.mdl", "tri2b/tree",
                                                "tri2b/transform.npy", "tri2b/ali.ark"))
    def _lda(ctx):
        tw, tt, _, _, lang = _corpus()
        tri = AmGmmModel.load(ctx.path("tri1/final.mdl"), device=dev)
        res = train_lda_mllt(yesno.compute_static_feats(tw, dev), tt, lang, tri,
                             _read_ali(ctx.path("tri1/ali.ark")), num_leaves=60,
                             target_dim=20, mllt_iters=(2, 4), opts=_fast(), device=dev)
        res.model.save(ctx.path("tri2b/final.mdl"))
        _write_tree(ctx.path("tri2b/tree"), res.ctx_dep)
        np.save(ctx.path("tri2b/transform.npy"), res.transform)
        _write_ali(ctx.path("tri2b/ali.ark"), res.alignments)

    @pipe.stage(40, "sat fmllr decode", produces=("tri2b/DONE_fmllr",))
    def _sat(ctx):
        _, tt, sw, st, lang = _corpus()
        model = AmGmmModel.load(ctx.path("tri2b/final.mdl"), device=dev)
        tree = _read_tree(ctx.path("tri2b/tree"))
        test_lda = _lda_test_feats(ctx, sw, dev)
        csr = _unigram_graph(lang, tt, tree, model.tm)
        hyps = decode_dataset(model, csr, lang, test_lda, DecodeOptions(beam=20.0))
        _result(ctx, "tri2b", score_hyps(st, hyps).wer)
        # two-pass unsupervised fMLLR: align the first pass's words, one
        # transform a speaker, decode again
        utt2spk = {k: k.split("_")[0] for k in test_lda}
        hyp_texts = {k: v for k, v in hyps.items() if v}
        keys, fp, nf = pad_feature_batch({k: test_lda[k] for k in hyp_texts})
        graphs = GraphCompiler(lang, tree, model.tm).compile_csr_graphs(
            [hyp_texts[k] for k in keys])
        alis, _ = align_all(model.am, graphs, torch.from_numpy(fp).to(dev), nf,
                            ViterbiOptions(beam=32.0))
        ali_map = {k: a for k, a in zip(keys, alis) if a is not None}
        transforms = estimate_fmllr_per_speaker(model, test_lda, ali_map, utt2spk,
                                                min_count=50.0)
        adapted = {k: apply_affine_transform(v, transforms[utt2spk[k]])
                   if utt2spk[k] in transforms else v for k, v in test_lda.items()}
        hyps2 = decode_dataset(model, csr, lang, adapted, DecodeOptions(beam=20.0))
        _result(ctx, "tri2b+fmllr", score_hyps(st, hyps2).wer)
        with open(ctx.path("tri2b/DONE_fmllr"), "w") as f:
            f.write("done\n")

    @pipe.stage(50, "train nnet3 tdnn", produces=("nnet3/am.mdl",))
    def _tdnn(ctx):
        tw, _, _, _, _ = _corpus()
        tri = AmGmmModel.load(ctx.path("tri1/final.mdl"), device=dev)
        am = train_tdnn(tri, yesno.compute_feats(tw, dev), _read_ali(ctx.path("tri1/ali.ark")),
                        hidden_dim=64, num_layers=3, opts=_nnet_opts(), device=dev)
        AmNnetModel(am, tri.tm).save(ctx.path("nnet3/am.mdl"))

    @pipe.stage(51, "decode nnet3", produces=("nnet3/DONE_decode",))
    def _tdnn_decode(ctx):
        _, tt, sw, st, lang = _corpus()
        bundle = AmNnetModel.load(ctx.path("nnet3/am.mdl"), device=dev)
        csr = _unigram_graph(lang, tt, _read_tree(ctx.path("tri1/tree")), bundle.tm)
        hyps = decode_tdnn(bundle.am, csr, lang, yesno.compute_feats(sw, dev), beam=20.0)
        _result(ctx, "nnet3-tdnn", score_hyps(st, hyps).wer)
        with open(ctx.path("nnet3/DONE_decode"), "w") as f:
            f.write("done\n")

    @pipe.stage(52, "train nnet3 tdnn + online ivectors",
                produces=("nnet3_iv/am.mdl", "nnet3_iv/final.ie"))
    def _tdnn_ivector(ctx):
        tw, _, _, _, _ = _corpus()
        feats = yesno.compute_feats(tw, dev)
        # the UBM and the T matrix on the training features (reference
        # steps/online/nnet2/{train_diag_ubm,train_ivector_extractor}.sh)
        pooled = np.concatenate(list(feats.values()))[::2]
        ubm = train_ubm(pooled, num_gauss=16, num_iters=6, device=dev)
        ext = train_ivector_extractor(ubm, list(feats.values()), ivector_dim=8, num_iters=4,
                                      device=dev)
        ext.save(ctx.path("nnet3_iv/final.ie"))
        ivecs = {k: extract_online_ivectors(ext, v, period=10).cpu().numpy()
                 for k, v in feats.items()}
        tri = AmGmmModel.load(ctx.path("tri1/final.mdl"), device=dev)
        am = train_tdnn(tri, feats, _read_ali(ctx.path("tri1/ali.ark")), hidden_dim=64,
                        num_layers=3, opts=_nnet_opts(), ivectors=ivecs, device=dev)
        assert am.ivector_dim == 8
        AmNnetModel(am, tri.tm).save(ctx.path("nnet3_iv/am.mdl"))

    @pipe.stage(53, "decode nnet3 + online ivectors", produces=("nnet3_iv/DONE_decode",))
    def _tdnn_ivector_decode(ctx):
        _, tt, sw, st, lang = _corpus()
        bundle = AmNnetModel.load(ctx.path("nnet3_iv/am.mdl"), device=dev)
        ext = IvectorExtractor.load(ctx.path("nnet3_iv/final.ie"), device=dev)
        csr = _unigram_graph(lang, tt, _read_tree(ctx.path("tri1/tree")), bundle.tm)
        test_feats = yesno.compute_feats(sw, dev)
        ivecs = {k: extract_online_ivectors(ext, v, period=10).cpu().numpy()
                 for k, v in test_feats.items()}
        hyps = decode_tdnn(bundle.am, csr, lang, test_feats, beam=20.0, ivectors=ivecs)
        _result(ctx, "nnet3-tdnn-ivector", score_hyps(st, hyps).wer)
        with open(ctx.path("nnet3_iv/DONE_decode"), "w") as f:
            f.write("done\n")

    @pipe.stage(60, "train+decode chain", produces=("chain/DONE",))
    def _chain(ctx):
        tw, tt, sw, st, lang = _corpus()
        tri = AmGmmModel.load(ctx.path("tri1/final.mdl"), device=dev)
        cm = train_chain(tri, yesno.compute_feats(tw, dev), _read_ali(ctx.path("tri1/ali.ark")),
                         lang, ChainTrainOptions(num_epochs=30, minibatch_size=8, hidden_dim=64,
                                                 bottleneck_dim=16, num_layers=3),
                         device=dev)
        cm.save(ctx.path("chain/final.mdl"))
        g = make_unigram_grammar_fst(list(tt.values()), lang.words)
        hyps = decode_chain(cm, make_chain_decode_graph(cm, lang, g), lang,
                            yesno.compute_feats(sw, dev))
        _result(ctx, "chain", score_hyps(st, hyps).wer)
        # the marker last, so that a crash mid-decode runs the stage again
        with open(ctx.path("chain/DONE"), "w") as f:
            f.write("done\n")

    @pipe.stage(70, "lattice lm rescoring", produces=("rescore/DONE",))
    def _rescore(ctx):
        _, tt, sw, st, lang = _corpus()
        model = AmGmmModel.load(ctx.path("tri2b/final.mdl"), device=dev)
        csr = _unigram_graph(lang, tt, _read_tree(ctx.path("tri2b/tree")), model.tm)
        lats = decode_dataset_with_lattices(model, csr, lang, _lda_test_feats(ctx, sw, dev),
                                            DecodeOptions(beam=20.0), lattice_beam=12.0)
        lm = parse_arpa(_bigram_arpa(tt))
        base_hyps, resc_hyps = {}, {}
        for k, lat in lats.items():
            words, _, _ = lattice_best_path(lat, 1.0, 0.1)
            base_hyps[k] = [lang.words[w] for w in words]
            clat = determinize_lattice_pruned(lat, 12.0, acoustic_scale=0.1)
            resc = lmrescore_compact_lattice(clat, lang.words, lm, new_scale=1.0)
            w2, _, _ = resc.best_path(lm_scale=1.0, ac_scale=0.1)
            resc_hyps[k] = [lang.words[w] for w in w2]
        _result(ctx, "tri2b-lattice-1best", score_hyps(st, base_hyps).wer)
        _result(ctx, "tri2b+bigram-rescore", score_hyps(st, resc_hyps).wer)
        with open(ctx.path("rescore/DONE"), "w") as f:
            f.write("done\n")

    @pipe.stage(80, "streaming decode", produces=("stream/DONE",))
    def _stream(ctx):
        _, tt, sw, _, lang = _corpus()
        bundle = AmNnetModel.load(ctx.path("nnet3/am.mdl"), device=dev)
        csr = _unigram_graph(lang, tt, _read_tree(ctx.path("tri1/tree")), bundle.tm)
        mo = MfccOptions()
        mo.frame_opts.samp_freq = yesno.SAMP_FREQ
        mo.frame_opts.dither = 0.0
        # the CE model was trained on batch features (deltas, per-utterance
        # CMN): this stage shows the streaming path and its real-time
        # factor, feeding it the streaming front end all the same
        tot_audio = tot_wall = 0.0
        chunk = int(0.5 * yesno.SAMP_FREQ)
        for wav in sw.values():
            front = OnlineFeaturePipeline(mo, device=dev)
            sam = StreamingAmNnet(bundle.am)
            dec = StreamingDecoder(csr, lambda x: x, [lang.silence_id],
                                   bundle.tm.tid_to_phone_array(),
                                   opts=ViterbiOptions(beam=20.0, acoustic_scale=1.0),
                                   device=dev)
            t0 = time.perf_counter()
            for lo in range(0, len(wav), chunk):
                feats = front.accept_waveform(wav[lo: lo + chunk])
                if feats.size:
                    dec.advance(sam.accept(feats))
            fin = front.input_finished()
            dec.advance(sam.accept(fin, final=True), final=True)
            tot_wall += time.perf_counter() - t0
            tot_audio += len(wav) / yesno.SAMP_FREQ
        with open(ctx.path("RESULTS"), "a") as f:
            f.write(f"RTF {tot_wall / max(tot_audio, 1e-9):.3f} [streaming]\n")
        with open(ctx.path("stream/DONE"), "w") as f:
            f.write("done\n")

    return pipe


def run_all(workdir: str, stage: int = 0, device: DeviceLike = None) -> PipelineContext:
    """Every stage from `stage` on, on `device` (None: the GPU); the
    context's `stage_seconds` holds the seconds of each stage that ran."""
    return build_pipeline(workdir, stage, device).run()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="The five BASELINE configs on yesno as one "
                                             "stage-gated pipeline (on the GPU by default)")
    ap.add_argument("--workdir", default="exp/run_all")
    ap.add_argument("--stage", type=int, default=0, help="skip the stages below this one")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    run_all(args.workdir, args.stage, args.device)
    with open(os.path.join(args.workdir, "RESULTS")) as f:
        print(f.read())


if __name__ == "__main__":
    main()
